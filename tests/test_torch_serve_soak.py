"""ByteServer soak on the native codec: identical request windows through
``ByteServer(codec="native")`` stay byte-stable and do not grow host
memory.

The counterpart of ``tests/test_serve_soak.py``, on the port's
``FheApp(engine="torch", device="cpu")`` (the kernels' plain versions).
The native-codec path allocates per request (refcounted key references,
malloc'd outputs crossing the ctypes boundary, thread-local zstd contexts
and scratch).  An unfreed output ciphertext (~260 KB) or a leaked
key-backing buffer grows RSS by ~100 MB over the windows run here; the
reference's bound of 60 MB catches that class while staying robust to
allocator noise on identical, already-warm windows.

Four workers (not one a core), every worker's zstd contexts made before
the baseline, the baseline taken after the plateau, and each reading taken
after ``malloc_trim``: so the bound measures memory still in use, the same
under the test suite's parallel workers as alone.
"""
import ctypes
import gc
import hashlib
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from fhe_precompiles_tpu_torch import FheApp, pack
from fhe_precompiles_tpu_torch.app import _CT_CODEC
from fhe_precompiles_tpu_torch.bfv.golden import BfvContext
from fhe_precompiles_tpu_torch.encoding import PLAIN_TYPES
from fhe_precompiles_tpu_torch.params import TESTNET_ONE
from fhe_precompiles_tpu_torch.serve import ByteServer

WORKERS = 4
# measured windows: twice the reference's 8, so that a leak of the packed
# outputs alone passes the bound (half of it did not)
MEASURED = 16


def _vmrss_kb():
    """Resident kB after glibc hands its free pages back: the engine's
    batches free tens of MB of tensors a run, which the allocator keeps
    cached in one arena or another (RSS moved by +-80 MB from run to run
    without it); what is still resident after the trim is live memory."""
    ctypes.CDLL(None).malloc_trim(0)
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    raise RuntimeError("no VmRSS")


def test_byte_server_native_soak():
    app = FheApp(TESTNET_ONE, engine="torch", device="cpu")
    ctx = BfvContext(TESTNET_ONE)
    pk1, _ = ctx.generate_keys(seed=b"\x61" * 64)

    def ct(value, pk, tag):
        poly = PLAIN_TYPES["u64"].encode(value, TESTNET_ONE)
        return ctx.encrypt(poly, pk, hashlib.sha512(tag).digest())

    a, b = ct(9, pk1, b"s1"), ct(4, pk1, b"s2")
    reqs = []
    for i in range(48):
        op = ("add", "sub", "mul")[i % 3]
        reqs.append((f"{op}_cipheru64_cipheru64",
                     pack.pack_binary_operation(pk1, a, _CT_CODEC,
                                                b, _CT_CODEC)))
    reqs.append(("encrypt_u64",
                 pack.pack_two_arguments(5, pack.U64, b"pd", pack.BYTES)))
    reqs.append(("decrypt_u64", pack.pack_one_argument(
        ct(7, app.public_key, b"s3"), _CT_CODEC)))

    expected = [app.call(name, data) for name, data in reqs]
    with ByteServer(TESTNET_ONE, workers=WORKERS, app=app,
                    codec="native") as server:
        assert server.run(reqs) == expected
        assert server.pooled["pooled_windows"] == 1

        # Prime EVERY pool thread's codec state deterministically: each
        # worker builds its zstd contexts (~3.5 MB) on first use, and which
        # threads have compressed yet depends on scheduling.
        barrier = threading.Barrier(server.workers)
        out_arr = np.asarray(ctx.mul_relin(a, b, pk1.relin).data)
        mul_data = reqs[2][1]

        def prime():
            barrier.wait(timeout=60)   # each worker takes exactly one task
            server.codec.pack_ciphertext(out_arr)                   # CCtx
            server.codec.unpack_binary("mul_cipheru64_cipheru64",
                                       mul_data)[7].release()       # DCtx
            barrier.wait(timeout=60)

        for f in [server._pool.submit(prime) for _ in range(server.workers)]:
            f.result(timeout=120)

        # the first windows still grow one-time state (per-thread glibc
        # arenas, the engine's caches); the plateau is flat from there
        for _ in range(3):
            assert server.run(reqs) == expected

        gc.collect()
        rss0 = _vmrss_kb()
        for _ in range(MEASURED):
            assert server.run(reqs) == expected
        gc.collect()
        rss1 = _vmrss_kb()
    # 16 windows x 50 requests: leaking each packed output (~88 KB) alone
    # adds ~70 MB, the raw result arrays (196 KB) ~160 MB; identical warm
    # windows add 1-3 MB
    assert rss1 - rss0 < 60_000, f"RSS grew {rss1 - rss0} kB over soak"
