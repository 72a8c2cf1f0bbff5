"""The inputs of a run, made from its seed by the benchmark's own code.

Keys and ``FRESH`` fresh encryptions come from the reference
(``bench_port/reference``) on the host.  The pool on the card is then filled
with exact modular sums of them: entry j is the sum of the ``TERMS`` fresh
encryptions ``terms[j]`` names, so it decrypts to the sum of their
plaintexts mod t.  The program receives the pool tensor and the public key's
arrays; the reference forms the same sums itself for the entries it checks.

A mix with plain ops (``traffic.PLAIN_OPS``) also has a pool of
``plain_pool`` plaintexts on the card: each uniform mod t, from a stream of
its own, uploaded as (P_plain, n) int64 rows as
``convert.plaintexts_from_numpy`` lays them out.  Assumed: the five types'
encodings (a u64 in the low coefficients, the rest 0) are sparser, but no
op's cost on the card depends on a plaintext's values.  Keys, fresh
encryptions and ``terms`` do not depend on the plaintext pool.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from .reference.golden import BfvContext, PublicKey, SecretKey
from .reference.modmath import addmod
from .reference.params import Params
from .traffic import STREAM_PLAIN_POOL, STREAM_PLAINS, STREAM_POOL, rng

POOL_CHUNK = 1024           # pool rows summed on the card per call
FRESH = 32                  # fresh encryptions the pool is summed from
TERMS = 4                   # fresh encryptions summed into each pool entry


def params_of(cfg: dict) -> Params:
    """The reference's parameter set from a configuration's numbers."""
    p = Params(poly_modulus_degree=int(cfg["poly_modulus_degree"]),
               coeff_modulus=tuple(int(q) for q in cfg["coeff_modulus"]),
               plain_modulus=int(cfg["plain_modulus"]))
    p.validate()
    return p


def seed_bytes(seed: int, label: str, i: int = 0) -> bytes:
    """64 bytes for the reference's samplers, from the run's seed."""
    msg = f"bench_port/{label}/{seed}/{i}".encode()
    return hashlib.blake2b(msg, digest_size=64).digest()


@dataclasses.dataclass
class Inputs:
    ctx: BfvContext
    pk: PublicKey
    sk: SecretKey
    plains: np.ndarray          # (fresh, n) uint64 plaintexts mod t
    fresh: np.ndarray           # (fresh, 2, k, n) uint64 encryptions
    terms: np.ndarray           # (pool, terms) int64 indices into fresh
    plain_pool: np.ndarray      # (plain_pool, n) uint64 plaintexts mod t

    def pool_entry(self, j: int) -> np.ndarray:
        """Pool entry j as the reference forms it: (2, k, n) uint64."""
        out = self.fresh[self.terms[j, 0]].copy()
        for f in self.terms[j, 1:]:
            for i, p in enumerate(self.ctx.q_mods):
                out[:, i] = addmod(out[:, i], self.fresh[f, :, i], p)
        return out

    def pool_plain(self, j: int) -> np.ndarray:
        """The plaintext pool entry j decrypts to: (n,) uint64 mod t."""
        return (self.plains[self.terms[j]].sum(axis=0)
                % np.uint64(self.ctx.t))


def make_inputs(cfg: dict, traffic: dict, seed: int) -> Inputs:
    ctx = BfvContext(params_of(cfg))
    pk, sk = ctx.generate_keys(seed=seed_bytes(seed, "keys"))
    plains = rng(seed, STREAM_PLAINS).integers(
        0, ctx.t, size=(FRESH, ctx.n), dtype=np.uint64)
    fresh = np.stack([ctx.encrypt(m, pk, seed=seed_bytes(seed, "enc", i)).data
                      for i, m in enumerate(plains)])
    terms = rng(seed, STREAM_POOL).integers(
        0, FRESH, size=(traffic["pool"], TERMS),
        dtype=np.int64)
    plain_pool = rng(seed, STREAM_PLAIN_POOL).integers(
        0, ctx.t, size=(traffic.get("plain_pool", 0), ctx.n), dtype=np.uint64)
    return Inputs(ctx, pk, sk, plains, fresh, terms, plain_pool)


def pool_on_device(inp: Inputs, device):
    """The pool (P, 2, k, n) int64 on `device`: each entry the exact sum mod
    q_i of its terms, computed in blocks of ``POOL_CHUNK`` rows."""
    import torch
    dev = torch.device(device)
    fresh = torch.from_numpy(inp.fresh.view(np.int64)).to(dev)
    terms = torch.from_numpy(inp.terms).to(dev)
    q = torch.tensor(inp.ctx.q_mods, dtype=torch.int64,
                     device=dev).reshape(-1, 1)
    P = inp.terms.shape[0]
    pool = torch.empty((P,) + tuple(fresh.shape[1:]), dtype=torch.int64,
                       device=dev)
    for r0 in range(0, P, POOL_CHUNK):
        rows = terms[r0:r0 + POOL_CHUNK]
        acc = fresh.index_select(0, rows[:, 0])
        for c in range(1, rows.shape[1]):
            acc = acc + fresh.index_select(0, rows[:, c])
            acc = torch.where(acc >= q, acc - q, acc)
        pool[r0:r0 + POOL_CHUNK] = acc
    return pool


def plain_pool_on_device(inp: Inputs, device):
    """The plaintext pool (P_plain, n) int64 on `device`."""
    import torch
    return torch.from_numpy(inp.plain_pool.view(np.int64)).to(device)
