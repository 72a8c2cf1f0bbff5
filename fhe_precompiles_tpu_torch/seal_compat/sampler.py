"""SEAL 4.0 polynomial samplers (util/rlwe.cpp), bit-exact.

* ``sample_poly_ternary``: one draw per coefficient from
  ``std::uniform_int_distribution<uint64_t>(0, 2)`` over SEAL's
  ``RandomToStandardAdapter`` (a uint32 engine).  The distribution's mapping
  from raw engine output to {0,1,2} is *implementation-defined* in C++ --
  which is exactly why the reference pins different golden hashes for linux
  vs macOS (fhe.rs:2103-2119).  The linux (libstdc++) algorithm is the
  down-scaling rejection loop:

      scaling = floor((2^32 - 1) / 3) = 1431655765
      draw r until r < 3 * scaling  (only r = 0xFFFFFFFF is rejected)
      value = r / scaling

  Encoded per modulus as rand + (flag & q_j) - 1 with flag = -(rand == 0),
  i.e. {q_j - 1, 0, 1}.

* ``sample_poly_cbd``: centered binomial with 21 bits per side: 6 bytes per
  coefficient, bytes 2 and 5 masked to 5 bits, noise = wt(x0..x2) -
  wt(x3..x5); encoded per modulus as noise + (flag & q_j).
"""
from __future__ import annotations

import numpy as np

from .prng import Blake2xbPrng

_SCALING = (2**32 - 1) // 3          # 1431655765
_PAST = 3 * _SCALING                 # 4294967295: rejects only 0xFFFFFFFF


def sample_poly_ternary(prng: Blake2xbPrng, n: int) -> np.ndarray:
    """Returns int64 coefficients in {-1, 0, 1} (libstdc++ semantics)."""
    out = np.empty(n, dtype=np.int64)
    for i in range(n):
        while True:
            r = prng.u32()
            if r < _PAST:
                break
        out[i] = r // _SCALING - 1
    return out


_POPCNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                        axis=1).sum(axis=1).astype(np.int64)


def sample_poly_cbd(prng: Blake2xbPrng, n: int) -> np.ndarray:
    """Returns int64 noise coefficients (range [-21, 21])."""
    raw = np.frombuffer(prng.generate(6 * n), dtype=np.uint8).reshape(n, 6)
    raw = raw.copy()
    raw[:, 2] &= 0x1F
    raw[:, 5] &= 0x1F
    w = _POPCNT[raw]
    return (w[:, 0] + w[:, 1] + w[:, 2] - w[:, 3] - w[:, 4] - w[:, 5])
