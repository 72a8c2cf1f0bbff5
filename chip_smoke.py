"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card and nvcc
    python3 chip_smoke.py --ptxas    # also prints each kernel's registers

Drives the port's paths through ``TorchEngine`` on the card, on
``testnet.one`` (n = 4096) at a batch of 128, and checks each byte for byte
against the port's host golden model: the main path, ciphertext x ciphertext
BFV multiplies followed by relinearization, and the round trip, encrypt on
the card -> multiply + relinearize -> decrypt on the card, with the
elementwise operations beside it, on the default engine (butterfly NTT);
then the same multiply and round trip on the four-step engine
(``ntt_backend="four_step"``) and the four-step transform in its two-launch
form; then the system's entry point, the 49 byte-level precompiles through
``FheApp(TESTNET_ONE, engine="torch")`` on the card against the port's
golden ``FheApp``, with a dozen invalid inputs, the launch counters of every
call and the host time of a call by op class; then a stream of 1,024
precompile calls through the batched ``ByteServer`` (phase serve: every
response equal to ``FheApp.call`` one at a time, the batches in the launch
counters, requests a second, continuous mode's latency), with the python
codec and then with the native one (``codec="native"``: the C++ codec
library built with g++ from ``fhe_precompiles_tpu_torch/native/`` beside
the CUDA build, all 36 binary ops and the threshold calls batched, pooled
windows, the launches against a count derived from its windows); then the C ABI
(phase c_abi: ``libc_fhe.so`` and its C host ``host_test.c`` on the card,
and the 49 precompiles through the library's 51 symbols by ctypes, each
equal to ``FheApp.call`` with its launches; then ``libc_fhe_cpu.so``, the
same 51 symbols computed on the CPU by the C++ host engine: its exports,
the 49 calls through it equal to the torch app's with no launch, size-1
ciphertexts equal to the native app's, and ``host_test.c`` linked to it
dynamically and, statically, to ``libc_fhe_cpu.a``, each passing in a
process of its own).  Between phases serve and c_abi: phase
native_engine, the 49 precompiles through ``FheApp(TESTNET_ONE,
engine="native")`` (the C++ host engine, the CPU validator's engine) equal
to the torch and golden apps, phase app's invalid inputs with the same
codes, no kernel launched, and host ms a call against the torch app's; and
phase soak, one window of 256 requests of the reference soak's mix through
``ByteServer(codec="native")`` run 3 + 8 times: every run byte-equal to
the first, the same launches every run, host RSS growth under 60 MB,
``torch.cuda.memory_allocated()`` flat across the measured runs.  Then
phase multi_device, the port's mesh on ``torch.distributed``: an NCCL
world of one in this process (``RequestStream`` over ``global_mesh()`` and
the distributed NTT at D = 1, equal to the stream without a mesh and to
the NTT kernels), then a gloo world of four ranks, this script in
processes of its own (``--multi-device-rank``), all on the one card:
the distributed NTT at D = 2 and 4, ``RequestStream`` on (dp, tp) =
(2, 2) with limbs sharded and on (4, 1), ``pipeline_chain`` over four
stages and ``ByteServer`` on dp = 4 with both codecs, every rank's result
equal to the single-device one and its launches equal to those its
batches imply.  The world's times are those of one card shared by four
ranks, not a scaling figure.  Then phase hardening, the port's native
code under checkers: the ten kernels in a process of their own
(``--sanitize-kernels``) at their smallest shapes, ragged row counts and
largest n, every input and output between poisoned guard words and the
output poisoned (two poisons), each word-equal to its plain version with
no guard or input written (a process that compute-sanitizer can wrap,
where the tool supports the card); the coverage fuzzer (ASan + UBSan) over
the C++ byte path from the synthesized seeds and the JAX package's 132;
the ASan drive on three presets and the TSan drive, every case equal to
the torch app on the card; the install with ``c_fhe.pc`` and two C hosts
linked through ``pkg-config``.  Last, phase examples: the port's three
demos (``examples/torch_demo.py``, ``torch_consensus_demo.py``,
``torch_byte_server_demo.py``) imported and their ``main`` run on the card,
each with the launches its calls imply, and ``torch_demo.py`` once from the
command line.  Before all that it builds the CUDA
kernels from ``fhe_precompiles_tpu_torch/csrc/`` and holds each of the ten
(five BEHZ tail segments, forward and inverse butterfly NTT, forward and
inverse four-step NTT, one four-step product) against its plain PyTorch
version on the card (``floor_sk`` also on bench.n1024 and at ragged batches,
as it has one instance per limb-count pair), and the four-step transforms
against the butterfly kernels too (exact integer arithmetic: the tolerance
is 0, every word must be equal).

Phases, one JSON line each: device, build, kernels, main_path, round_trip,
timing, four_step_path, app (with the zstd codec that ran: ``zstandard``, or
the machine's libzstd through ctypes where ``zstandard`` does not import),
serve, native_engine (with the host CPU's model and cores), soak, c_abi,
multi_device, hardening, examples.
Any failure ends the run with a non-zero exit code and without the last
line. Then, in this order: the card's name and power limit as ``nvidia-smi``
gives them, one ``{"kernels": [...]}`` line (per kernel: launches counted
during its path's run, during its round trip and during the 49 precompile
calls of phase app, error against the plain version, measured times, and the
least time the card could take, with its bytes and operations terms;
``launches_serve``, ``launches_serve_native``, ``launches_soak`` and
``launches_abi`` are the launches of phase serve's ``ByteServer.run`` with
each codec, of one measured run of phase soak and of phase c_abi's 49
calls through the card's library, ``launches_mesh`` those of one rank's
``RequestStream`` run on dp = 4 in phase multi_device; ``ms``
is taken with the inputs cold in the cache and is the time ``bound_ms`` is
held against, ``same_buffers_ms`` repeats one input set, ``path_ms`` is one
call inside ``_mul_relin``, for the NTTs the call of the shape that ``ms``
was taken at, for the four-step product its launch inside the two-launch
transform), and the last line ``{"ok": true, "device": {"platform": "gpu",
"kind": ..., "count": ...}}``.

It imports ``fhe_precompiles_tpu_torch`` only, never JAX.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import gc
import hashlib
import importlib.metadata
import importlib.util
import io
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
import types
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from fhe_precompiles_tpu_torch import (FheApp, PRECOMPILE_NAMES, convert,
                                       native, pack)
from fhe_precompiles_tpu_torch.app import _CT_CODEC, _PK_CODEC
from fhe_precompiles_tpu_torch.bfv import BfvContext, Ciphertext
from fhe_precompiles_tpu_torch.encoding import PLAIN_TYPES
from fhe_precompiles_tpu_torch.native import codec as codec_mod
from fhe_precompiles_tpu_torch.native import fuzz as fuzz_mod
from fhe_precompiles_tpu_torch.native import install as install_mod
from fhe_precompiles_tpu_torch.native import sanitize as sanitize_mod
from fhe_precompiles_tpu_torch.ops import build, tail, tail_cases
from fhe_precompiles_tpu_torch.ops import four_step as fsm
from fhe_precompiles_tpu_torch.ops import ntt as nttm
from fhe_precompiles_tpu_torch.ops.engine import TorchEngine
from fhe_precompiles_tpu_torch.ops.modmath import csub_reduce
from fhe_precompiles_tpu_torch.parallel import (RequestStream, make_mesh,
                                                multihost)
from fhe_precompiles_tpu_torch.parallel.dist_ntt import (
    make_distributed_ntt, shard_coeff_axis)
from fhe_precompiles_tpu_torch.parallel.mesh import Mesh
from fhe_precompiles_tpu_torch.parallel.pipeline import pipeline_chain
from fhe_precompiles_tpu_torch.params import (BENCH_N1024, BENCH_N8192,
                                              TESTNET_ONE)
from fhe_precompiles_tpu_torch.serialization import keyio, zstd_codec
from fhe_precompiles_tpu_torch.serialization import zstd_probes
from fhe_precompiles_tpu_torch.serialization.bincode import Writer
from fhe_precompiles_tpu_torch.serialization.seal import (SealCiphertextBlob,
                                                          compute_parms_id)
from fhe_precompiles_tpu_torch.serve import (BINARY_SPECS, FALLBACK_REASONS,
                                             POOL_COUNTERS, ByteServer)

BATCH = 128          # the main path's batch
DISTINCT = 8         # distinct ciphertexts, tiled up to BATCH
SWEEP = (1, 16, 32, 64, 256, 512)   # other batch sizes timed beside BATCH
SEED = 20240607
# phase serve: requests in the stream, of them per-request calls and
# malformed ones (the rest cipher∘cipher), distinct ciphertexts a user key,
# the server's batch, the golden app's sample, the continuous burst
SERVE_REQUESTS = 1024
SERVE_PER_REQUEST = 32
SERVE_MALFORMED = 16
SERVE_DISTINCT = 16
SERVE_MAX_BATCH = 128
SERVE_GOLDEN_SAMPLE = 32
SERVE_BURST = 256
# phase soak: warm runs, measured runs, and the reference soak's bound on
# the host's RSS growth over the measured runs
SOAK_WARM = 3
SOAK_MEASURED = 8
SOAK_RSS_BOUND_KB = 60_000

# Published peaks of one H100 SXM.  Memory: 3.35 TB/s.  The kernels do 64-bit
# integer arithmetic on the 32-bit integer pipe, which has half the lanes of
# the float32 pipe (67 TFLOP/s = 33.5e12 multiply-adds a second): 16.75e12
# 32-bit integer multiply-adds a second.  Operations are counted in those:
# the high half of a 64 x 64-bit product takes four, the low half three.
PEAK_BYTES_PER_S = 3.35e12
PEAK_IMAD_PER_S = 16.75e12
# The four-step kernels' digit products run on the tensor cores: 1,979e12
# dense int8 operations a second, a multiply and an add being two.
PEAK_INT8_OPS_PER_S = 1979e12
MULHI, MULLO = 4, 3
SHOUP = MULHI + 2 * MULLO         # hi(a * ws), a * w, q * p
BARRETT = MULHI + MULLO           # hi(x * mu), q * p
# general product kept lazy: hi(a * b), a * b, hi * (2^64 mod p), one Barrett
# step (2^64 mod p is the same for a whole launch and is not counted)
MUL_LAZY = MULHI + 2 * MULLO + BARRETT
# The NTT kernels form their 40-bit Shoup product on the FP64 pipe: four
# multiply-adds (q = a * ws40 / 2^40 rounded down, h = a * w, its error
# a * w - h, h - q * p).  FP64 outside the tensor cores runs at half the
# float32 rate (the data sheet's 34 TFLOP/s, rounded): 16.75e12
# multiply-adds a second, as the 32-bit integer pipe.
SHOUP40_FMAS = 4
# four_step_kernel's x - floor(x * floor(2^52 / p) / 2^52) * p: two more;
# its fold of the nine group sums: eight 32 x 32 -> 64-bit multiply-adds
FOUR_STEP_REDUCE_FMAS = 2
FOUR_STEP_FOLD_IMADS = 8
PEAK_FP64_FMA_PER_S = 16.75e12
MULMOD = MUL_LAZY + BARRETT
L2_BYTES = 50 * 2 ** 20           # the card's L2 cache

# launches of each kernel in one _mul_relin, default engine and four-step
# engine
CALLS_PER_MUL_RELIN = {"to_bsk_ext": 2, "dyadic": 1, "floor_sk": 1,
                       "relin_dot": 1, "mod_down": 1, "ntt": 3, "intt": 2}
FOUR_STEP_CALLS_PER_MUL_RELIN = {
    **{name: CALLS_PER_MUL_RELIN[name] for name in tail.KERNEL_NAMES},
    "four_step_ntt": 3, "four_step_intt": 2}
# NTT launches of the round trip: encrypt_batch, _mul_relin, _multiply,
# decrypt_batch of sizes 2 and 3, decrypt of the boundary ciphertext,
# mul_plain (forward, inverse); the tail kernels run in the two multiplies
ROUND_TRIP_NTT_CALLS = {
    "ntt": 1 + 3 + 2 + 1 + 2 + 1 + 2, "intt": 2 + 2 + 1 + 1 + 1 + 1 + 1}
# the four-step engine's round trip: encrypt_batch, _mul_relin, _multiply,
# decrypt_batch of sizes 2 and 3
FOUR_STEP_ROUND_TRIP_CALLS = {"four_step_ntt": 1 + 3 + 2 + 1 + 2,
                              "four_step_intt": 2 + 2 + 1 + 1 + 1}

# kernel launches of one precompile call on FheApp(engine="torch"), by the
# op class of ``app_op_class``: the engine paths of TorchEngine.mul_relin,
# _mul_plain (forward of the plain and of the ciphertext, one inverse),
# encrypt_batch (forward of u, inverse of u*pk0 and u*pk1) and
# decrypt_batch at size 2; reencrypt is a decrypt and an encrypt; add and
# sub launch no kernel
APP_CALLS = {
    "add cc": {}, "add cp": {}, "mul cc": CALLS_PER_MUL_RELIN,
    "mul cp": {"ntt": 2, "intt": 1}, "encrypt": {"ntt": 1, "intt": 2},
    "reencrypt": {"ntt": 2, "intt": 3}, "decrypt": {"ntt": 1, "intt": 1},
    "public_key_bytes": {},
}
# launches of the native codec's batched dispatches (serve.py
# _run_native): one _prepare (a pooled chunk of at most max_batch
# ciphertexts), one prepared multiply + relinearize, one batch of each
# plain op, encrypt and decrypt at size 2
PREPARE_CALLS = {"to_bsk_ext": 1, "ntt": 1}
PREPARED_MUL_CALLS = {k: v - 2 * PREPARE_CALLS.get(k, 0)
                      for k, v in CALLS_PER_MUL_RELIN.items()}
PLAIN_CALLS = {"add_plain": {}, "sub_plain": {}, "plain_sub": {},
               "mul_plain": APP_CALLS["mul cp"]}
# one precompile of each op class, timed on both apps
APP_TIMED = {"add cc": "add_cipheru64_cipheru64",
             "add cp": "add_cipheru64_u64",
             "mul cc": "mul_cipheru64_cipheru64",
             "mul cp": "mul_cipheru64_u64", "encrypt": "encrypt_u64",
             "reencrypt": "reencrypt_u64", "decrypt": "decrypt_u64",
             "public_key_bytes": "public_key_bytes"}
SCALARS = {"u256": pack.U256, "u64": pack.U64, "i64": pack.I64,
           "frac64": pack.FRAC64}
# the canonical bytes pinned for the JAX package's tests (zstd 1.5.7)
GOLDEN_HASHES = "tests/data/golden_hashes.json"

CSRC = "fhe_precompiles_tpu_torch/csrc/"
SOURCES = {name: CSRC + "tail.cu" for name in tail.KERNEL_NAMES}
SOURCES.update({name: CSRC + "ntt.cu" for name in nttm.KERNEL_NAMES})
SOURCES.update({name: CSRC + "four_step.cu" for name in fsm.KERNEL_NAMES})
REPLACES = {
    "to_bsk_ext": "fhe_precompiles_tpu/ops/pallas_tail.py:147",
    "dyadic": "fhe_precompiles_tpu/ops/pallas_tail.py:214",
    "floor_sk": "fhe_precompiles_tpu/ops/pallas_tail.py:254",
    "relin_dot": "fhe_precompiles_tpu/ops/pallas_tail.py:353",
    "mod_down": "fhe_precompiles_tpu/ops/pallas_tail.py:415",
    "ntt": "fhe_precompiles_tpu/ops/pallas_pair_ntt.py:86",
    "intt": "fhe_precompiles_tpu/ops/pallas_pair_ntt.py:135",
    "four_step_ntt": "fhe_precompiles_tpu/ops/pallas_ntt.py:239",
    "four_step_intt": "fhe_precompiles_tpu/ops/pallas_ntt.py:279",
    "four_step_phase": "fhe_precompiles_tpu/ops/pallas_ntt.py:184",
}
KERNEL_NAMES = tail.KERNEL_NAMES + nttm.KERNEL_NAMES + fsm.KERNEL_NAMES


def reset_launch_counts() -> None:
    tail.reset_launch_counts()
    nttm.reset_launch_counts()
    fsm.reset_launch_counts()


def launch_counts() -> dict:
    return {**tail.launch_counts, **nttm.launch_counts, **fsm.launch_counts}


def expected_counts(calls: dict) -> dict:
    """Every kernel's launches: those in `calls`, 0 for the others."""
    return {name: calls.get(name, 0) for name in KERNEL_NAMES}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def hold_device(ms: float) -> None:
    """Keeps the card busy for about `ms` milliseconds (a spin kernel on the
    current stream; 2e6 cycles a millisecond is the card's top clock), so
    that the host can queue what follows and the card then runs it back to
    back: event times after it hold no wait for the host."""
    torch.cuda._sleep(int(ms * 2e6))


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of one call on the card, from CUDA events around
    `reps` calls queued behind a spin kernel (0.5 ms of it for each call;
    the host issues one in 0.02-0.04 ms, and a pause of the host of a few
    milliseconds stays hidden too).  `fn` takes the call's number."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold_device(0.5 * reps)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds the host needs to issue one call (host clock, the
    card not waited for)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e3


def same_strides_copy(x: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(x.size(), x.stride(), dtype=x.dtype,
                               device=x.device).copy_(x)


def cold_ms(kern, inputs, c, reps: int = 20) -> float:
    """Mean milliseconds of one launch that finds its inputs cold: the calls
    rotate through copies of the inputs (same strides) that together hold
    five times the L2 cache, and each result is kept until its turn comes
    again, so that no call reads what an earlier one left in the cache.  Two
    rounds of warm-up, so that the allocator holds every block it needs."""
    in_bytes = 8 * sum(x.numel() for x in inputs)
    sets = max(2, -(-5 * L2_BYTES // in_bytes))
    ring = [inputs] + [tuple(same_strides_copy(x) for x in inputs)
                       for _ in range(sets - 1)]
    outs = [None] * sets

    def call(i):
        outs[i % sets] = kern(*ring[i % sets], c)

    return cuda_ms(call, reps=reps, warmup=2 * sets)


def rand_rows(rng, lead, mods, n) -> np.ndarray:
    """Uniform canonical residues, uint64 (*lead, len(mods), n)."""
    out = np.empty(tuple(lead) + (len(mods), n), dtype=np.uint64)
    for li, p in enumerate(mods):
        out[..., li, :] = rng.integers(0, p, size=tuple(lead) + (n,),
                                       dtype=np.uint64)
    return out


def dev(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int64)).cuda()


def imads_per_launch(name: str, c: tail.TailConstants, batch: int) -> int:
    """32-bit multiply-adds the function needs for `batch` ciphertext pairs,
    counted product by product as csrc/tail.cu forms them.  The m_tilde row
    of to_bsk_ext multiplies 16-bit values: one each.  floor_sk forms its
    products on the FP64 pipe (``floor_sk_fmas``); only its alpha mod q_i
    takes a Barrett step, and only where steps_msk_mod_q is large."""
    k, nbsk, kk, n = c.k, c.nbsk, c.k_key, c.n
    barrett_alpha = c.steps_msk_mod_q > tail.MSK_CSUB_STEPS
    per_pos = {
        "to_bsk_ext": (k * SHOUP + k + 1
                       + nbsk * (k * SHOUP + BARRETT + 2 * SHOUP)),
        "dyadic": c.nb * 3 * MULMOD,
        "floor_sk": k * BARRETT if barrett_alpha else 0,
        "relin_dot": kk * (2 * k * MUL_LAZY + 2 * BARRETT),
        "mod_down": 2 * k * (BARRETT + SHOUP),
    }[name]
    rows = {"to_bsk_ext": 2 * batch, "floor_sk": 3 * batch}.get(name, batch)
    return per_pos * rows * n


def floor_sk_fmas(c: tail.TailConstants, rows: int) -> int:
    """FP64 multiply-adds of one floor_sk launch over `rows` rows, as
    csrc/tail.cu floor_sk_at forms them: one 40-bit Shoup product for each
    term of its sums, k + 1 for each of the nB y2 limbs, nB + 1 + k for
    alpha, nB + 1 for each of the k output limbs."""
    k, nB = c.k, c.nB
    products = nB * (k + 1) + (nB + 1 + k) + k * (nB + 1)
    return rows * c.n * products * SHOUP40_FMAS


def ntt_fmas(name: str, rows: int, n: int) -> int:
    """FP64 multiply-adds of one transform of `rows` rows, as csrc/ntt.cu
    forms them: one 40-bit Shoup product for each of the n/2 * log2(n)
    butterflies, and for the inverse one more for each word (the n^-1
    multiply)."""
    per_row = n // 2 * (n.bit_length() - 1) * SHOUP40_FMAS
    if name == "intt":
        per_row += n * SHOUP40_FMAS
    return rows * per_row


def ntt_table_bytes(name: str, tb: nttm.NttTables) -> int:
    """The tables one transform reads: the moduli, the twiddles and their
    Shoup words, and for the inverse n^-1 and its Shoup word."""
    L = tb.p.shape[0]
    return 8 * (L + 2 * L * tb.n + (2 * L if name == "intt" else 0))


def kernel_cases(ctx: BfvContext, c: tail.TailConstants, batch: int, rng):
    """For every tail kernel: (wrapper, plain version, input tensors) at the
    shapes the multiply path gives it for `batch` ciphertext pairs, with the
    hand-placed branch cases in row 0."""
    n, k, kk = ctx.n, ctx.k, ctx.k_key
    q, all_mods, key = ctx.q_mods, ctx.q_mods + ctx.Bsk, ctx.key_mods
    a = rand_rows(rng, (batch * 2,), q, n)
    a = tail_cases.place_r_cases(a, ctx).reshape(batch, 2, k, n)
    tq = rand_rows(rng, (batch * 3,), all_mods, n)
    tq = tail_cases.place_alpha_cases(tq, ctx).reshape(batch, 3, c.nb, n)
    rk = dev(rand_rows(rng, (k, 2), key, n))
    ct3 = dev(rand_rows(rng, (batch, 3), q, n))
    return {
        "to_bsk_ext": (tail.to_bsk_ext, tail.to_bsk_ext_plain, (dev(a),)),
        "dyadic": (tail.dyadic, tail.dyadic_plain,
                   (dev(rand_rows(rng, (batch, 2), all_mods, n)),
                    dev(rand_rows(rng, (batch, 2), all_mods, n)))),
        "floor_sk": (tail.floor_sk, tail.floor_sk_plain, (dev(tq),)),
        "relin_dot": (tail.relin_dot, tail.relin_dot_plain,
                      (dev(rand_rows(rng, (batch, k), key, n)), rk)),
        # ct01 is the strided view the pipeline passes
        "mod_down": (tail.mod_down, tail.mod_down_plain,
                     (dev(rand_rows(rng, (batch, 2), key, n)), ct3[:, :2])),
    }


def floor_sk_cases(ctx: BfvContext, c: tail.TailConstants, rng):
    """floor_sk beyond the main path's shape: bench.n1024 (k = 1, alpha mod
    q_i by a Barrett step) and ragged batches of testnet.one, each with the
    hand-placed alpha cases in its first row.  (label, constants, input)."""
    ctx1 = BfvContext(BENCH_N1024)
    c1 = tail.TailConstants(ctx1, "cuda")
    cases = []
    for label, g, cc, batch in (("bench.n1024, B = 4", ctx1, c1, 4),
                                ("testnet.one, B = 1", ctx, c, 1),
                                ("testnet.one, B = 127", ctx, c, 127)):
        tq = rand_rows(rng, (batch * 3,), g.q_mods + g.Bsk, g.n)
        tq = tail_cases.place_alpha_cases(tq, g)
        cases.append((label, cc, dev(tq.reshape(batch, 3, cc.nb, g.n))))
    return cases


def ntt_rows(rng, lead, mods, n) -> torch.Tensor:
    """Uniform canonical residues (*lead, L, n) on the card whose first four
    (L, n) blocks are all 0, all p - 1, a single 1 at position 0 and a single
    1 at position n - 1."""
    x = rand_rows(rng, lead, mods, n)
    blocks = x.reshape(-1, len(mods), n)
    blocks[:4] = 0
    blocks[1] = np.array(mods, dtype=np.uint64).reshape(-1, 1) - np.uint64(1)
    blocks[2, :, 0] = 1
    blocks[3, :, n - 1] = 1
    return dev(x)


def ntt_cases(eng: TorchEngine, rng):
    """Every shape the two paths give the NTT kernels on testnet.one at
    BATCH, then bench.n8192 (a 64 KB row: dynamic shared memory) and
    bench.n1024 (a modulus below 2^32) at small batches, and every n from 8
    to 2048 on the key primes (each cuts its stages into passes differently).
    The first case of each kernel is the one timed for the last ``kernels``
    line.
    (label, kernel name, tables, tables for the way back or None, input)."""
    g, n = eng.golden, eng.n
    tb = {stack: t.tables for stack, t in eng.ntts.items()}
    all_mods = g.q_mods + g.Bsk
    ct = ntt_rows(rng, (BATCH, 2), g.q_mods, n)
    cases = [
        ("prepare q+bsk", "ntt", tb["all"], tb["all"],
         ntt_rows(rng, (BATCH, 2), all_mods, n)),
        ("mul_core q+bsk, t*qhat_inv folded", "intt", tb["all_t"], None,
         ntt_rows(rng, (BATCH, 3), all_mods, n)),
        ("relinearize key", "ntt", tb["key"], tb["key"],
         ntt_rows(rng, (BATCH, g.k), g.key_mods, n)),
        ("relinearize key", "intt", tb["key"], tb["key"],
         ntt_rows(rng, (BATCH, 2), g.key_mods, n)),
        ("decrypt q, strided ct[:, 1]", "ntt", tb["q"], tb["q"], ct[:, 1]),
        ("decrypt q", "intt", tb["q"], tb["q"],
         ntt_rows(rng, (BATCH,), g.q_mods, n)),
    ]
    for label, params, batch in (("bench.n8192", BENCH_N8192, 2),
                                 ("bench.n1024", BENCH_N1024, 4)):
        ctx = BfvContext(params)
        mods = ctx.q_mods + ctx.Bsk
        tb = nttm.build_tables(mods, ctx.n, "cuda")
        tb_t = nttm.build_tables(mods, ctx.n, "cuda",
                                 n_inv_factors=[params.t] * len(mods))
        for name, tables, back, what in (
                ("ntt", tb, tb, " q+bsk"), ("intt", tb_t, None,
                                            " q+bsk, t folded"),
                ("intt", tb, tb, " q+bsk")):
            cases.append((label + what, name, tables, back,
                          ntt_rows(rng, (batch, 2), mods, ctx.n)))
    for log2n in range(3, 12):
        tb = nttm.build_tables(g.key_mods, 1 << log2n, "cuda")
        for name in nttm.KERNEL_NAMES:
            cases.append((f"key primes, n = {1 << log2n}", name, tb, tb,
                          ntt_rows(rng, (4,), g.key_mods, 1 << log2n)))
    return cases


def four_step_cases(eng4: TorchEngine, eng: TorchEngine, rng):
    """Every shape the four-step engine gives its transforms on testnet.one
    at BATCH, then bench.n8192 (R = 128: dynamic shared memory) and
    bench.n1024 (R = 16, a 27-bit prime) at small batches.  (label,
    direction, four-step tables, butterfly tables of the same moduli and
    fold, whether to go there and back, input)."""
    g, n = eng4.golden, eng4.n
    all_mods = g.q_mods + g.Bsk
    f, b = eng4.ntts, eng.ntts
    ct = ntt_rows(rng, (BATCH, 2), g.q_mods, n)

    def pair(stack):
        return f[stack].tables, b[stack].tables
    cases = [
        ("prepare q+bsk", "ntt", *pair("all"), True,
         ntt_rows(rng, (BATCH, 2), all_mods, n)),
        ("mul_core q+bsk, t*qhat_inv folded", "intt", *pair("all_t"), False,
         ntt_rows(rng, (BATCH, 3), all_mods, n)),
        ("relinearize key", "ntt", *pair("key"), True,
         ntt_rows(rng, (BATCH, g.k), g.key_mods, n)),
        ("relinearize key", "intt", *pair("key"), True,
         ntt_rows(rng, (BATCH, 2), g.key_mods, n)),
        ("decrypt q, strided ct[:, 1]", "ntt", *pair("q"), True, ct[:, 1]),
        ("decrypt q", "intt", *pair("q"), True,
         ntt_rows(rng, (BATCH,), g.q_mods, n)),
    ]
    for label, params, batch in (("bench.n8192", BENCH_N8192, 2),
                                 ("bench.n1024", BENCH_N1024, 4)):
        ctx = BfvContext(params)
        mods = ctx.q_mods + ctx.Bsk
        fold = [params.t] * len(mods)
        plain = (fsm.build_mxu_tables(mods, ctx.n, "cuda"),
                 nttm.build_tables(mods, ctx.n, "cuda"))
        folded = (fsm.build_mxu_tables(mods, ctx.n, "cuda",
                                       n_inv_factors=fold),
                  nttm.build_tables(mods, ctx.n, "cuda", n_inv_factors=fold))
        for what, name, tables, back in ((" q+bsk", "ntt", plain, True),
                                         (" q+bsk, t folded", "intt", folded,
                                          False),
                                         (" q+bsk", "intt", plain, True)):
            cases.append((label + what, name, *tables, back,
                          ntt_rows(rng, (batch, 2), mods, ctx.n)))
    return cases


def phase_mode_checks(label: str, m: torch.Tensor, weights: torch.Tensor,
                      grid, tb: fsm.MxuNttTables, check: dict) -> int:
    """Kernel 9 alone against its plain version in each of its three
    modes on the matrices `m` (..., L, K, J) with the packed `weights` and
    the `grid`'s words: the mismatches go into `check`, the largest
    difference is returned."""
    max_err = 0
    for mode in fsm.PHASE_MODES:
        g = None if mode == "none" else grid
        got = fsm.phase(m, weights, g, mode, tb)
        mism, err = mismatch(got, fsm.phase_plain(m, weights, g, mode, tb))
        check["mismatches"] += mism
        check["cases"].append(
            {"case": f"phase {mode}, {label}", "shape": list(m.shape),
             "contiguous": m.is_contiguous(), "mismatches": mism})
        max_err = max(max_err, err)
    return max_err


def four_step_kernel_checks(eng4: TorchEngine, eng: TorchEngine, rng,
                            rows: dict, checks: dict) -> None:
    """Kernel 8 (``four_step_ntt`` / ``four_step_intt``, one launch) and
    kernel 9 (``four_step_phase``, the two-launch transform) at every shape
    of ``four_step_cases``, each against the plain version and against the
    butterfly kernels on the same input, and there and back again; kernel 9
    alone in its three modes at each of those shapes, on the input's R x C
    matrices (A, T) and on their transposes (B0, T transposed), and at
    K = J = 128 (bench.n8192's A, a random grid).  Fills the three kernels'
    rows and checks."""
    fused = {"ntt": fsm.ntt, "intt": fsm.intt}
    two = {"ntt": fsm.ntt_two_launch, "intt": fsm.intt_two_launch}
    plain = {"ntt": fsm.ntt_plain, "intt": fsm.intt_plain}
    bfly = {"ntt": nttm.ntt, "intt": nttm.intt}
    back = {"ntt": "intt", "intt": "ntt"}
    for name in fsm.KERNEL_NAMES:
        checks[name] = {"name": name, "mismatches": 0, "cases": []}
    max_err = {name: 0 for name in fsm.KERNEL_NAMES}
    main_input = tb128 = None
    for label, d, tb, btb, there_and_back, x in four_step_cases(eng4, eng,
                                                                rng):
        m = x.view(x.shape[:-1] + (tb.R, tb.C))
        for side, v, w, g in (
                ("R x C", m, tb.A_wg, tb.T),
                ("C x R", m.transpose(-1, -2).contiguous(), tb.B0_wg,
                 tb.TT)):
            max_err["four_step_phase"] = max(
                max_err["four_step_phase"],
                phase_mode_checks(f"{side}, {label}", v, w, g, tb,
                                  checks["four_step_phase"]))
        if tb.R == 128:
            tb128 = tb
        want = plain[d](x, tb)
        if count_diff(want, bfly[d](x, btb)):
            raise AssertionError(f"{label}: the plain four-step {d} differs "
                                 "from the butterfly kernel")
        k8 = "four_step_" + d
        for name, fn in ((k8, fused[d]), ("four_step_phase", two[d])):
            got = fn(x, tb)
            mism, err = mismatch(got, want)
            mism += count_diff(got, bfly[d](x, btb))
            if there_and_back:
                other = fused if name == k8 else two
                mism += count_diff(other[back[d]](got, tb), x)
            case = {"case": label, "direction": d, "shape": list(x.shape),
                    "contiguous": x.is_contiguous(), "mismatches": mism}
            if tb.n == 4096 and name != k8:
                case["ms_two_launch"] = cold_ms(fn, (x,), tb)
            checks[name]["mismatches"] += mism
            checks[name]["cases"].append(case)
            max_err[name] = max(max_err[name], err)
            del got
        if k8 not in rows:            # the first case of each direction
            nbytes, imads, int8_ops, fmas = four_step_work(k8, x, tb)
            rows[k8], terms = timed_row(k8, fused[d], plain[d], (x,), tb,
                                        nbytes, imads, 0, int8_ops, fmas)
            checks[k8].update(terms)
            checks[k8]["cases"][-1]["ms"] = rows[k8]["ms"]
            if main_input is None:
                main_input = (x, tb)
        elif tb.n == 4096:
            checks[k8]["cases"][-1]["ms"] = cold_ms(fused[d], (x,), tb)
        del want

    # kernel 9 alone at K = J = 128, a side pair no transform gives it
    mods = [int(p) for p in tb128.fold_scalars[:, 0].tolist()]
    max_err["four_step_phase"] = max(
        max_err["four_step_phase"],
        phase_mode_checks("K = J = 128, bench.n8192's A, a random grid",
                          dev(rand_rows(rng, (2,), mods, 128 * 128)
                              ).view(2, len(mods), 128, 128),
                          tb128.A_wg,
                          dev(rand_rows(rng, (), mods, 128 * 128)
                              ).view(len(mods), 128, 128),
                          tb128, checks["four_step_phase"]))

    # the row of the kernels line: kernel 9 in mode "pre" on the forward's
    # operand, (B, 2, nb, R, C)
    x, tb = main_input
    m = x.view(x.shape[:-1] + (tb.R, tb.C))

    def kern(v, t):
        return fsm.phase(v, t.A_wg, t.T, "pre", t)

    def ref(v, t):
        return fsm.phase_plain(v, t.A_wg, t.T, "pre", t)
    nbytes, imads, int8_ops, fmas = four_step_work("four_step_phase", m, tb)
    rows["four_step_phase"], terms = timed_row(
        "four_step_phase", kern, ref, (m,), tb, nbytes, imads, 0, int8_ops,
        fmas)
    checks["four_step_phase"].update(terms)
    for name in fsm.KERNEL_NAMES:
        rows[name]["max_abs_err"] = max_err[name]


def io_bytes(inputs, out) -> int:
    """Each input word read once, each output word written once."""
    return 8 * (sum(x.numel() for x in inputs) + out.numel())


def mismatch(got: torch.Tensor, want: torch.Tensor):
    """(words that differ, largest difference) of a kernel's output."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype or not got.is_cuda:
        raise AssertionError("kernel output differs in shape, type or device")
    mism = count_diff(got, want)
    return mism, int((got - want).abs().max().item()) if mism else 0


def count_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a != b).sum().item())


def compare(kern, plain, inputs, c):
    got = kern(*inputs, c)
    return (got, *mismatch(got, plain(*inputs, c)))


def timed_row(name, kern, plain, inputs, c, nbytes, imads, max_err,
              int8_ops=0, fp64_fmas=0):
    """One row of the last ``kernels`` line and the terms of its bound.  The
    operations term is the largest of the integer pipe's (`imads`), the FP64
    pipe's (`fp64_fmas`) and the tensor cores' (`int8_ops`): they run side
    by side."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    imad_ms = imads / PEAK_IMAD_PER_S * 1e3
    fp64_ms = fp64_fmas / PEAK_FP64_FMA_PER_S * 1e3
    tensor_ms = int8_ops / PEAK_INT8_OPS_PER_S * 1e3
    ops_ms = max(imad_ms, tensor_ms, fp64_ms)
    row = {
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": 0,
        "max_abs_err": max_err,
        "ms": cold_ms(kern, inputs, c),
        "plain_ms": cuda_ms(lambda i: plain(*inputs, c), reps=5, warmup=1),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "bytes_bound_ms": bytes_ms, "operations_bound_ms": ops_ms,
        "same_buffers_ms": cuda_ms(lambda i: kern(*inputs, c)),
        "path_ms": None, "launches_round_trip": 0,
    }
    terms = {"bytes": nbytes, "imads": imads, "int8_ops": int8_ops,
             "bytes_bound_ms": bytes_ms, "operations_bound_ms": ops_ms,
             "integer_pipe_ms": imad_ms, "tensor_core_ms": tensor_ms,
             "fp64_fmas": fp64_fmas, "fp64_pipe_ms": fp64_ms,
             "host_issue_ms": host_ms(lambda i: kern(*inputs, c))}
    return row, terms


def four_step_work(name: str, x: torch.Tensor, tb: fsm.MxuNttTables):
    """(bytes, 32-bit multiply-adds, int8 tensor-core operations, FP64
    multiply-adds) of one launch on `x`, as csrc/four_step.cu does the work;
    a phase launch (kernel 9, one product) with its grid, kernel 8 two
    products and one grid.  Bytes: each input and output word once, the
    limbs' weights (in wgmma's layout, padded), the grid's words (kernel 8:
    and their beta = 40 Shoup words) and the fold scalars once.  Tensor
    cores: 25 digit-pair products of each multiply-add of each matrix
    product, two operations each.  For each output of each product: eight
    multiply-adds of a group sum into its 64-bit word (integer pipe), a
    beta = 52 Shoup product (four) and the final reduction (two) on the FP64
    pipe; and four more a word for the grid (kernel 8's Shoup product,
    kernel 9's Barrett product from the word alone: a * w, its error, the
    quotient, the remainder)."""
    if name == "four_step_phase":
        K, J = x.shape[-2:]
        n, depth, products, grid_words = K * J, K, 1, 1
        weights = fsm.weight_bytes(K)
    else:
        n, depth, products, grid_words = tb.n, tb.R + tb.C, 2, 2
        weights = tb.A_wg.shape[1] + tb.B0_wg.shape[1]
    rows = x.numel() // n
    nbytes = 16 * x.numel() + tb.p.shape[0] * (weights + 8 * grid_words * n
                                               + 32)
    int8_ops = 2 * 25 * rows * n * depth
    return (nbytes, rows * n * products * FOUR_STEP_FOLD_IMADS, int8_ops,
            rows * n * (products * (SHOUP40_FMAS + FOUR_STEP_REDUCE_FMAS)
                        + SHOUP40_FMAS))


def phase_kernels(eng: TorchEngine, eng4: TorchEngine, rng):
    """Kernel against plain version on the card.  The tail kernels at the
    main path's shapes on testnet.one and at a small batch on bench.n8192
    (other limb counts), floor_sk also at ``floor_sk_cases``; the NTT
    kernels at every shape of ``ntt_cases``, and there and back again
    (``intt(ntt(x)) == x``).  Returns the rows of the last ``kernels`` line
    and, per kernel, the comparison's counts with the two terms of the
    bound."""
    ctx8 = BfvContext(BENCH_N8192)
    c8 = tail.TailConstants(ctx8, "cuda")
    small = kernel_cases(ctx8, c8, 2, rng)
    rows, checks = {}, {}
    for name, (kern, plain, inputs) in kernel_cases(
            eng.golden, eng.consts, BATCH, rng).items():
        out, mism, max_err = compare(kern, plain, inputs, eng.consts)
        k8, p8, in8 = small[name]
        _, mism8, max_err8 = compare(k8, p8, in8, c8)
        nbytes = io_bytes(inputs, out)
        del out
        fmas = (floor_sk_fmas(eng.consts, 3 * BATCH) if name == "floor_sk"
                else 0)
        rows[name], terms = timed_row(
            name, kern, plain, inputs, eng.consts, nbytes,
            imads_per_launch(name, eng.consts, BATCH), max(max_err, max_err8),
            fp64_fmas=fmas)
        checks[name] = {"name": name, "mismatches": mism,
                        "mismatches_n8192": mism8, **terms}
    # floor_sk, one instance per limb-count pair, at more shapes
    checks["floor_sk"]["cases"] = []
    for label, c, x in floor_sk_cases(eng.golden, eng.consts, rng):
        _, mism, max_err = compare(tail.floor_sk, tail.floor_sk_plain, (x,),
                                   c)
        checks["floor_sk"]["mismatches"] += mism
        checks["floor_sk"]["cases"].append(
            {"case": label, "shape": list(x.shape), "mismatches": mism})
        rows["floor_sk"]["max_abs_err"] = max(rows["floor_sk"]["max_abs_err"],
                                              max_err)

    kerns = {"ntt": (nttm.ntt, nttm.ntt_plain),
             "intt": (nttm.intt, nttm.intt_plain)}
    for label, name, tb, back, x in ntt_cases(eng, rng):
        kern, plain = kerns[name]
        out, mism, max_err = compare(kern, plain, (x,), tb)
        if back is not None:       # there and back with the unfolded tables
            other = nttm.intt if name == "ntt" else nttm.ntt
            mism += int((other(out, back) != x).sum().item())
        n_rows = x.numel() // tb.n
        case = {"case": label, "shape": list(x.shape),
                "contiguous": x.is_contiguous(), "mismatches": mism}
        if name not in rows:       # the first case: the kernels line's row
            nbytes = io_bytes((x,), out) + ntt_table_bytes(name, tb)
            del out
            rows[name], terms = timed_row(
                name, kern, plain, (x,), tb, nbytes,
                0, max_err, fp64_fmas=ntt_fmas(name, n_rows, tb.n))
            checks[name] = {"name": name, "mismatches": 0, "cases": [],
                            "max_abs_err": 0, **terms}
            case["ms"] = rows[name]["ms"]
        else:
            del out
            if tb.n >= 1024:       # the small sizes are held, not timed
                case["ms"] = cold_ms(kern, (x,), tb)
        if "ms" in case:
            case["bytes_bound_ms"] = (
                (16 * x.numel() + ntt_table_bytes(name, tb))
                / PEAK_BYTES_PER_S * 1e3)
        checks[name]["mismatches"] += mism
        checks[name]["max_abs_err"] = max(checks[name]["max_abs_err"], max_err)
        checks[name]["cases"].append(case)
    for name in nttm.KERNEL_NAMES:
        rows[name]["max_abs_err"] = checks[name].pop("max_abs_err")
    four_step_kernel_checks(eng4, eng, rng, rows, checks)
    return rows, checks


def negacyclic_mul_mod_t(a: np.ndarray, b: np.ndarray, t: int) -> np.ndarray:
    n = a.shape[0]
    full = np.convolve(a.astype(np.int64), b.astype(np.int64))
    out = full[:n].copy()
    out[:n - 1] -= full[n:]
    return np.mod(out, t).astype(np.uint64)


def make_keys_and_plains(ctx: BfvContext):
    """Host keygen and DISTINCT small plaintexts (products stay below t)."""
    rng = np.random.default_rng(SEED + 1)
    pk, sk = ctx.generate_keys(seed=b"\x42" * 64)
    plains = np.zeros((DISTINCT, ctx.n), dtype=np.uint64)
    plains[:, :8] = rng.integers(0, 16, size=(DISTINCT, 8), dtype=np.uint64)
    return pk, sk, plains


def seed_of(i: int) -> bytes:
    return bytes([i + 1]) * 64


def phase_main_path(eng: TorchEngine, rows: dict, keys) -> dict:
    """Keys and ciphertexts from the host model, B = 128 distinct-operand
    multiply + relinearize on the card, checked against the host golden
    model and by decryption."""
    ctx, prm = eng.golden, eng.params
    pk, sk, plains = keys
    cts = [ctx.encrypt(plains[i], pk, seed_of(i)) for i in range(DISTINCT)]
    tiled = np.tile(np.stack([c.data for c in cts]),
                    (BATCH // DISTINCT, 1, 1, 1))

    reset_launch_counts()
    a = convert.ciphertexts_from_numpy(tiled, eng.device, prm, check=True)
    b = torch.roll(a, 1, dims=0)              # distinct operands
    rk = convert.relin_keys_from_numpy(pk.relin.data, eng.device, prm,
                                       check=True)
    out = eng._mul_relin(a, b, rk)
    single = eng.mul_relin(cts[0], cts[1], pk.relin)
    torch.cuda.synchronize()
    counts = launch_counts()

    check_mul_relin(eng, out, single, keys, cts, "main path")
    # one batched _mul_relin and one single-ciphertext mul_relin
    expected = expected_counts(
        {name: 2 * calls for name, calls in CALLS_PER_MUL_RELIN.items()})
    if counts != expected:
        raise AssertionError(f"launch counts {counts}, expected {expected}")
    for name in CALLS_PER_MUL_RELIN:
        rows[name]["launches"] = counts[name]
    return {"phase": "main_path", "ok": True, "preset": "testnet.one",
            "batch": BATCH, "distinct_pairs_checked": DISTINCT,
            "rows_equal_to_golden": BATCH, "decrypt_ok": True,
            "launches": counts, "output_device": str(out.device),
            "inputs": (a, b, rk), "host_cts": cts}


def check_mul_relin(eng: TorchEngine, out: torch.Tensor, single: Ciphertext,
                    keys, cts, label: str) -> None:
    """Every row of a B = 128 ``_mul_relin`` (operands ``cts`` tiled, the
    second rotated by one) and one single-ciphertext ``mul_relin`` against
    the host golden model, and the first rows by decryption."""
    ctx, prm = eng.golden, eng.params
    pk, sk, plains = keys
    if not out.is_cuda or tuple(out.shape) != (BATCH, 2, ctx.k, ctx.n):
        raise AssertionError(f"{label} output: {out.device} {out.shape}")
    got = convert.to_numpy(out)
    for i in range(DISTINCT):
        j = (i - 1) % DISTINCT
        want = ctx.mul_relin(cts[i], cts[j], pk.relin)
        for row in range(i, BATCH, DISTINCT):
            if not np.array_equal(got[row], want.data):
                raise AssertionError(f"{label}: row {row} differs from the "
                                     "host golden mul_relin")
        dec = ctx.decrypt(Ciphertext(prm, got[i]), sk)
        if not np.array_equal(
                dec, negacyclic_mul_mod_t(plains[i], plains[j], prm.t)):
            raise AssertionError(f"{label}: row {i} does not decrypt to the "
                                 "product")
    if not np.array_equal(single.data,
                          ctx.mul_relin(cts[0], cts[1], pk.relin).data):
        raise AssertionError(f"{label}: single-ciphertext mul_relin differs "
                             "from the host golden model")


def boundary_ciphertext(ctx: BfvContext) -> Ciphertext:
    """A wire-valid ciphertext no encryption produces: c1 = 0, so that the
    dot product with the secret key is c0 itself, and c0's coefficients are
    placed on and beside the rounding boundaries of t*x/q."""
    q, t = ctx.q, ctx.t
    xs = [0, 1, q - 1, q // 2]
    for m in (0, 1, 5, t // 2, t - 1, t):
        base = m * q - q // 2
        for d in (-1, 0, 1):
            x = (base + d) // t
            if 0 <= x < q:
                xs.append(x)
    data = np.zeros((2, ctx.k, ctx.n), dtype=np.uint64)
    for j, p in enumerate(ctx.q_mods):
        data[0, j, :len(xs)] = [x % p for x in xs]
    return Ciphertext(ctx.params, data)


def call_times(fn, reps: int):
    """CUDA-event milliseconds of `reps` single calls, each waited for."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def phase_round_trip(eng: TorchEngine, rows: dict, keys, host_cts) -> dict:
    """Encrypt B = 128 on the card, multiply + relinearize, decrypt on the
    card: every step against the host golden model.  Then one ciphertext on
    the rounding boundaries, and one of each elementwise operation."""
    ctx, prm = eng.golden, eng.params
    pk, sk, plains = keys
    reps = BATCH // DISTINCT
    tiled_plains = np.tile(plains, (reps, 1))
    seeds = [seed_of(i % DISTINCT) for i in range(BATCH)]

    def same(label, got, want):
        if not np.array_equal(got, want):
            raise AssertionError(f"round trip: {label} differs from the host "
                                 "golden model")

    reset_launch_counts()
    cts = eng.encrypt_batch(tiled_plains, pk, seeds)
    if not cts.is_cuda or tuple(cts.shape) != (BATCH, 2, ctx.k, ctx.n):
        raise AssertionError(f"encrypt_batch output: {cts.device} {cts.shape}")
    enc = convert.to_numpy(cts)
    for row in range(BATCH):
        same(f"encrypt row {row}", enc[row], host_cts[row % DISTINCT].data)

    other = torch.roll(cts, 1, dims=0)
    rk = convert.relin_keys_from_numpy(pk.relin.data, eng.device, prm)
    out2 = eng._mul_relin(cts, other, rk)
    out3 = eng._multiply(cts, other)
    dec2 = eng.decrypt_batch(out2, sk)
    dec3 = eng.decrypt_batch(out3, sk)
    if not dec2.is_cuda or tuple(dec2.shape) != (BATCH, ctx.n):
        raise AssertionError(f"decrypt_batch output: {dec2.device} "
                             f"{dec2.shape}")
    host2, host3 = convert.to_numpy(out2), convert.to_numpy(out3)
    got2, got3 = convert.to_numpy(dec2), convert.to_numpy(dec3)
    for i in range(DISTINCT):
        product = negacyclic_mul_mod_t(plains[i], plains[(i - 1) % DISTINCT],
                                       prm.t)
        same(f"size-2 decrypt row {i}", got2[i],
             ctx.decrypt(Ciphertext(prm, host2[i]), sk))
        same(f"size-3 decrypt row {i}", got3[i],
             ctx.decrypt(Ciphertext(prm, host3[i]), sk))
        for row in range(i, BATCH, DISTINCT):
            same(f"size-2 product row {row}", got2[row], product)
            same(f"size-3 product row {row}", got3[row], product)

    edge = boundary_ciphertext(ctx)
    same("decrypt of the boundary ciphertext", eng.decrypt(edge, sk),
         ctx.decrypt(edge, sk))

    x, y, m = host_cts[0], host_cts[1], plains[2]
    for name, args in (("add", (x, y)), ("sub", (x, y)), ("negate", (x,)),
                       ("add_plain", (x, m)), ("mul_plain", (x, m))):
        same(name, getattr(eng, name)(*args).data,
             getattr(ctx, name)(*args).data)
    torch.cuda.synchronize()
    counts = launch_counts()
    expected = {name: 2 * calls for name, calls in CALLS_PER_MUL_RELIN.items()}
    expected["mod_down"] = expected["relin_dot"] = 1    # _multiply stops early
    expected = expected_counts({**expected, **ROUND_TRIP_NTT_CALLS})
    if counts != expected:
        raise AssertionError(f"round trip launch counts {counts}, expected "
                             f"{expected}")
    for name in CALLS_PER_MUL_RELIN:
        rows[name]["launches_round_trip"] = counts[name]

    # times at B = 128, inputs on the card: the device part of encrypt_batch
    # (everything after the host's sampling and the transfer) and
    # decrypt_batch as a caller sees it (it carries the secret key across)
    u, e0, e1 = (convert.from_numpy(r, eng.device)
                 for r in eng._sample_randomness(seeds))
    m_dev = convert.plaintexts_from_numpy(tiled_plains, eng.device, prm)
    pk_ct = convert.public_key_from_numpy(pk.data, eng.device, prm,
                                          ct_limbs_only=True)
    if not torch.equal(eng._encrypt_core(u, e0, e1, m_dev, pk_ct), cts):
        raise AssertionError("_encrypt_core differs from encrypt_batch")
    t0 = time.perf_counter()
    eng._sample_randomness(seeds)
    sampling_ms = (time.perf_counter() - t0) * 1e3
    enc_ms = call_times(lambda: eng._encrypt_core(u, e0, e1, m_dev, pk_ct), 9)
    dec2_ms = call_times(lambda: eng.decrypt_batch(out2, sk), 9)
    dec3_ms = call_times(lambda: eng.decrypt_batch(out3, sk), 9)
    return {"phase": "round_trip", "ok": True, "preset": "testnet.one",
            "batch": BATCH, "distinct_checked": DISTINCT,
            "encrypt_rows_equal_to_golden": BATCH,
            "decrypt_size2_ok": True, "decrypt_size3_ok": True,
            "boundary_ciphertext_ok": True,
            "elementwise_ok": ["add", "sub", "negate", "add_plain",
                               "mul_plain"],
            "launches": counts,
            "encrypt_core_ms_median": statistics.median(enc_ms),
            "encrypt_core_ms_all": enc_ms,
            "encrypt_host_sampling_ms": sampling_ms,
            "decrypt_batch_size2_ms_median": statistics.median(dec2_ms),
            "decrypt_batch_size2_ms_all": dec2_ms,
            "decrypt_batch_size3_ms_median": statistics.median(dec3_ms)}


# staged_mul_relin's labels of the NTT launches
NTT_LABELS = ("ntt_all", "ntt_key", "intt_all", "intt_key")


def engine_transforms(eng: TorchEngine) -> dict:
    """The engine's four transforms of ``_mul_relin`` by staged label."""
    return {"ntt_all": eng._ntt_all, "intt_all": eng._intt_all_t,
            "ntt_key": eng._ntt_key, "intt_key": eng._intt_key}


def staged_mul_relin(eng: TorchEngine, a, b, rk, transforms=None):
    """The steps of ``_mul_relin`` one by one (as ``ops/behz.py`` runs them)
    with a CUDA event before each.  Returns the result and the milliseconds
    spent under each label; the NTTs over q and Bsk and those over the key
    primes have labels of their own, because their launches differ in size.
    `transforms` (label -> callable, the engine's own by default) may be
    plain versions, to time the path as it was before the kernels."""
    bz, c = eng.behz, eng.consts
    f = transforms or engine_transforms(eng)
    marks = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    hold_device(3.0)        # the host queues ahead of the card from here on
    mark("to_bsk_ext")
    ea = tail.to_bsk_ext(a, c)
    mark("ntt_all")
    fa = f["ntt_all"](ea)
    mark("to_bsk_ext")
    eb = tail.to_bsk_ext(b, c)
    mark("ntt_all")
    fb = f["ntt_all"](eb)
    mark("dyadic")
    stacked = tail.dyadic(fa, fb, c)
    mark("intt_all")
    tq = f["intt_all"](stacked)
    mark("floor_sk")
    ct3 = tail.floor_sk(tq, c)
    mark("digit_lift")
    d = csub_reduce(ct3[:, 2, :, None, :], c.key, bz.steps_ct_mod_key)
    mark("ntt_key")
    d_ntt = f["ntt_key"](d)
    mark("relin_dot")
    acc_ntt = tail.relin_dot(d_ntt, rk, c)
    mark("intt_key")
    acc = f["intt_key"](acc_ntt)
    mark("mod_down")
    out = tail.mod_down(acc, ct3[:, :2], c)
    mark("end")
    torch.cuda.synchronize()
    ms = {}
    for (label, ev), (_, nxt) in zip(marks, marks[1:]):
        ms[label] = ms.get(label, 0.0) + ev.elapsed_time(nxt)
    return out, ms


def staged_medians(eng: TorchEngine, inputs, want, runs: int,
                   transforms=None) -> dict:
    """Median milliseconds of each label over `runs` staged runs, each run's
    result held against `want`."""
    a, b, rk = inputs
    all_ms = []
    for _ in range(runs):
        out, ms = staged_mul_relin(eng, a, b, rk, transforms)
        if not torch.equal(out, want):
            raise AssertionError("a staged run differs from _mul_relin")
        all_ms.append(ms)
    return {label: statistics.median(r[label] for r in all_ms)
            for label in all_ms[0]}


def phase_timing(eng: TorchEngine, inputs, card: str, rows: dict) -> dict:
    """CUDA-event time of ``_mul_relin`` at B = 128 (median of 12), where it
    goes (the two NTT kernels against the five tail kernels), the same batch
    with the plain NTTs in their place, and the same call at other batch
    sizes (median of 5 each), with the host's time to issue one call beside
    it.  Writes each kernel's time for one call inside the pipeline into
    `rows`."""
    a, b, rk = inputs
    want = eng._mul_relin(a, b, rk)
    times = call_times(lambda: eng._mul_relin(a, b, rk), 12)
    batch_ms = statistics.median(times)
    sweep = {}
    for size in SWEEP + (BATCH,):
        reps_of_a = -(-size // BATCH)
        xa = a.repeat(reps_of_a, 1, 1, 1)[:size].contiguous()
        xb = torch.roll(xa, 1, dims=0)
        ms = statistics.median(
            call_times(lambda: eng._mul_relin(xa, xb, rk), 5))
        sweep[str(size)] = {
            "ms_per_batch": ms, "mul_relin_per_s": size / ms * 1e3,
            "host_issue_ms": host_ms(lambda i: eng._mul_relin(xa, xb, rk),
                                     reps=5)}

    stage_ms = staged_medians(eng, inputs, want, 5)
    staged_total = sum(stage_ms.values())
    tail_ms = sum(stage_ms[name] for name in tail.KERNEL_NAMES)
    ntt_ms = sum(stage_ms[label] for label in NTT_LABELS)
    for name in tail.KERNEL_NAMES:
        rows[name]["path_ms"] = stage_ms[name] / CALLS_PER_MUL_RELIN[name]
    # the launches of the shapes that the rows' `ms` was taken at: two
    # forward ones over q and Bsk, one inverse
    rows["ntt"]["path_ms"] = stage_ms["ntt_all"] / 2
    rows["intt"]["path_ms"] = stage_ms["intt_all"]

    # the same batch as it ran before the NTT kernels: plain stage loops
    tb = {stack: t.tables for stack, t in eng.ntts.items()}
    plain = {"ntt_all": lambda x: nttm.ntt_plain(x, tb["all"]),
             "intt_all": lambda x: nttm.intt_plain(x, tb["all_t"]),
             "ntt_key": lambda x: nttm.ntt_plain(x, tb["key"]),
             "intt_key": lambda x: nttm.intt_plain(x, tb["key"])}
    plain_ms = staged_medians(eng, inputs, want, 3, plain)
    plain_total = sum(plain_ms.values())
    plain_ntt = sum(plain_ms[label] for label in NTT_LABELS)
    return {"phase": "timing", "ok": True, "card": card, "batch": BATCH,
            "ms_per_batch_median": batch_ms, "ms_per_batch_all": times,
            "mul_relin_per_s": BATCH / batch_ms * 1e3,
            "batch_sizes": sweep,
            "staged_ms": stage_ms, "staged_total_ms": staged_total,
            "ntt_kernels_share": ntt_ms / staged_total,
            "tail_kernels_share": tail_ms / staged_total,
            "plain_ntt_staged_total_ms": plain_total,
            "plain_ntt_ms": plain_ntt}


def staged_two_launch(x: torch.Tensor, tb: fsm.MxuNttTables,
                      launches=None):
    """``fsm.ntt_two_launch`` step by step with a CUDA event before each, as
    ``staged_mul_relin`` does: the result and the milliseconds of the two
    launches of kernel 9 and of the two torch transposes.  `launches`: the
    two launches ("none" on the R x C matrices, "pre" on their transposes)
    as callables, this checkout's kernel by default."""
    first, second = launches or (
        lambda m: fsm.phase(m, tb.A_wg, None, "none", tb),
        lambda m: fsm.phase(m, tb.B0_wg, tb.TT, "pre", tb))
    marks = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    hold_device(1.0)
    mark("phase_none")
    y = first(x.view(x.shape[:-1] + (tb.R, tb.C)))
    mark("transpose")
    yt = y.transpose(-1, -2).contiguous()
    mark("phase_pre")
    zt = second(yt)
    mark("transpose_back")
    out = zt.transpose(-1, -2).reshape(x.shape)
    mark("end")
    torch.cuda.synchronize()
    return out, {label: ev.elapsed_time(nxt)
                 for (label, ev), (_, nxt) in zip(marks, marks[1:])}


def phase_four_step_path(eng4: TorchEngine, eng: TorchEngine, rows: dict,
                         keys, host_cts, inputs, card: str) -> dict:
    """``TorchEngine(TESTNET_ONE, ntt_backend="four_step")`` on the card,
    each path with the launch counters set to 0 before it and read after:
    (1) ``_mul_relin`` at B = 128 and one single-ciphertext ``mul_relin``
    against the host golden model and the default engine's bytes; (2) the
    round trip encrypt_batch -> _mul_relin / _multiply -> decrypt_batch
    (sizes 2 and 3) against the host model; (3) the two-launch transform
    (``FourStepNtt(fused=False)``, kernel 9) there and back on the prepared
    operand.  Then the batch time beside the default engine's (median of 12
    each, in turns), and the steps of the four-step batch one by one."""
    ctx, prm = eng4.golden, eng4.params
    pk, sk, plains = keys
    a, b, rk = inputs
    want = eng._mul_relin(a, b, rk)

    reset_launch_counts()
    out = eng4._mul_relin(a, b, rk)
    single = eng4.mul_relin(host_cts[0], host_cts[1], pk.relin)
    torch.cuda.synchronize()
    counts = launch_counts()
    check_mul_relin(eng4, out, single, keys, host_cts, "four-step path")
    if not torch.equal(out, want):
        raise AssertionError("the four-step engine's _mul_relin differs from "
                             "the default engine's")
    expected = expected_counts({name: 2 * calls for name, calls
                                in FOUR_STEP_CALLS_PER_MUL_RELIN.items()})
    if counts != expected:
        raise AssertionError(f"four-step launch counts {counts}, expected "
                             f"{expected}")
    for name in ("four_step_ntt", "four_step_intt"):
        rows[name]["launches"] = counts[name]

    # the round trip
    reset_launch_counts()
    seeds = [seed_of(i % DISTINCT) for i in range(BATCH)]
    cts = eng4.encrypt_batch(np.tile(plains, (BATCH // DISTINCT, 1)), pk,
                             seeds)
    other = torch.roll(cts, 1, dims=0)
    out2 = eng4._mul_relin(cts, other, rk)
    out3 = eng4._multiply(cts, other)
    dec2 = eng4.decrypt_batch(out2, sk)
    dec3 = eng4.decrypt_batch(out3, sk)
    torch.cuda.synchronize()
    counts_rt = launch_counts()
    enc = convert.to_numpy(cts)
    host2, host3 = convert.to_numpy(out2), convert.to_numpy(out3)
    got2, got3 = convert.to_numpy(dec2), convert.to_numpy(dec3)
    for row in range(BATCH):
        i = row % DISTINCT
        product = negacyclic_mul_mod_t(plains[i], plains[(i - 1) % DISTINCT],
                                       prm.t)
        ok = (np.array_equal(enc[row], host_cts[i].data)
              and np.array_equal(got2[row], product)
              and np.array_equal(got3[row], product))
        if row < DISTINCT:
            ok = ok and np.array_equal(
                got2[row], ctx.decrypt(Ciphertext(prm, host2[row]), sk)
            ) and np.array_equal(
                got3[row], ctx.decrypt(Ciphertext(prm, host3[row]), sk))
        if not ok:
            raise AssertionError(f"four-step round trip: row {row} differs "
                                 "from the host golden model")
    expected = {name: 2 * calls for name, calls in CALLS_PER_MUL_RELIN.items()
                if name in tail.KERNEL_NAMES}
    expected["mod_down"] = expected["relin_dot"] = 1    # _multiply stops early
    expected = expected_counts({**expected, **FOUR_STEP_ROUND_TRIP_CALLS})
    if counts_rt != expected:
        raise AssertionError(f"four-step round trip launch counts "
                             f"{counts_rt}, expected {expected}")
    for name in FOUR_STEP_ROUND_TRIP_CALLS:
        rows[name]["launches_round_trip"] = counts_rt[name]

    # the two-launch transform on the prepared operand, there and back
    ext = tail.to_bsk_ext(a, eng4.consts)
    fused = eng4._ntt_all(ext)
    g = eng4.golden
    two = fsm.FourStepNtt(g.q_mods + g.Bsk, g.n, eng4.device, fused=False)
    reset_launch_counts()
    y2 = two.ntt(ext)
    back = two.intt(y2)
    torch.cuda.synchronize()
    counts_two = launch_counts()
    if not (torch.equal(y2, fused) and torch.equal(back, ext)):
        raise AssertionError("the two-launch transform differs from the "
                             "one-launch transform")
    if counts_two != expected_counts({"four_step_phase": 4}):
        raise AssertionError(f"two-launch counts {counts_two}")
    rows["four_step_phase"]["launches"] = counts_two["four_step_phase"]
    two_runs = []
    for _ in range(5):
        y, ms = staged_two_launch(ext, two.tables)
        if not torch.equal(y, fused):
            raise AssertionError("the staged two-launch run differs")
        two_runs.append(ms)
    two_ms = {label: statistics.median(r[label] for r in two_runs)
              for label in two_runs[0]}
    rows["four_step_phase"]["path_ms"] = two_ms["phase_pre"]

    # batch times, default and four-step in turns
    times = {"default": [], "four_step": []}
    for name, e in (("default", eng), ("four_step", eng4),
                    ("four_step", eng4), ("default", eng)):
        times[name] += call_times(lambda: e._mul_relin(a, b, rk), 6)
    batch_ms = statistics.median(times["four_step"])
    stage_ms = staged_medians(eng4, inputs, want, 5)
    staged_total = sum(stage_ms.values())
    rows["four_step_ntt"]["path_ms"] = stage_ms["ntt_all"] / 2
    rows["four_step_intt"]["path_ms"] = stage_ms["intt_all"]
    return {"phase": "four_step_path", "ok": True, "card": card,
            "preset": "testnet.one", "batch": BATCH,
            "rows_equal_to_golden": BATCH, "equal_to_default_engine": True,
            "launches": counts, "round_trip_ok": True,
            "round_trip_launches": counts_rt,
            "two_launch_ok": True, "two_launch_launches": counts_two,
            "two_launch_staged_ms": two_ms,
            "ms_per_batch_median": batch_ms,
            "ms_per_batch_all": times["four_step"],
            "mul_relin_per_s": BATCH / batch_ms * 1e3,
            "default_ms_per_batch_median": statistics.median(
                times["default"]),
            "default_ms_per_batch_all": times["default"],
            "staged_ms": stage_ms, "staged_total_ms": staged_total,
            "ntt_kernels_share": sum(stage_ms[label] for label in NTT_LABELS)
            / staged_total}


def app_op_class(name: str) -> str:
    """The op class of precompile `name`: "add cc" (add and sub of two
    ciphertexts), "add cp" (add and sub with one plain operand), "mul cc",
    "mul cp", "encrypt", "reencrypt", "decrypt" or "public_key_bytes"."""
    kind = name.partition("_")[0]
    if kind in ("encrypt", "reencrypt", "decrypt", "public"):
        return "public_key_bytes" if kind == "public" else kind
    op, a_t, b_t = name.split("_")
    shape = "cc" if a_t.startswith("cipher") and b_t.startswith(
        "cipher") else "cp"
    return f"{'mul' if op == 'mul' else 'add'} {shape}"


def app_value(tname: str, x: int):
    return float(x) if tname == "frac64" else x


def app_calldata(golden: FheApp, user_pk, name: str) -> bytes:
    """Valid calldata for precompile `name`, built with the port's pack and
    golden encryptor: ciphertext operands 16 and 4 under the user's key,
    threshold inputs 12 under the network key."""
    ctx, prm = golden.ctx, golden.params
    kind, _, rest = name.partition("_")
    if name == "public_key_bytes":
        return b""
    if kind in ("encrypt", "reencrypt", "decrypt"):
        scalar = SCALARS[rest]
        if kind == "encrypt":
            return pack.pack_two_arguments(app_value(rest, 12), scalar,
                                           b"\x01\x02\x03", pack.BYTES)
        ct = ctx.encrypt(PLAIN_TYPES[rest].encode(app_value(rest, 12), prm),
                         golden.public_key,
                         hashlib.sha512(name.encode()).digest())
        if kind == "decrypt":
            return pack.pack_one_argument(ct, _CT_CODEC)
        return pack.pack_binary_operation(user_pk, ct, _CT_CODEC,
                                          b"\x01\x02\x03", pack.BYTES)
    _, a_t, b_t = name.split("_")
    tname = a_t.replace("cipher", "")

    def arg(tag: str, v: int, cipher: bool):
        if not cipher:
            return app_value(tname, v), SCALARS[tname]
        return ctx.encrypt(PLAIN_TYPES[tname].encode(app_value(tname, v), prm),
                           user_pk,
                           hashlib.sha512((name + tag).encode()).digest()
                           ), _CT_CODEC
    a, ca = arg("a", 16, a_t.startswith("cipher"))
    b, cb = arg("b", 4, b_t.startswith("cipher"))
    return pack.pack_binary_operation(user_pk, a, ca, b, cb)


def app_check_value(golden: FheApp, user_sk, name: str, out: bytes) -> None:
    """A successful output holds 16 op 4 (add 20, sub 12, mul 64), or 12."""
    kind, _, rest = name.partition("_")
    if name == "public_key_bytes":
        if out != golden.public_key_bytes():
            raise AssertionError("public_key_bytes: not the network key")
        return
    if kind in ("encrypt", "reencrypt", "decrypt"):
        tname, want = rest, 12
    else:
        op, a_t, _ = name.split("_")
        tname, want = a_t.replace("cipher", ""), {"add": 20, "sub": 12,
                                                  "mul": 64}[op]
    if kind == "decrypt":
        got = SCALARS[tname].deserialize(out)
    else:
        sk = golden.private_key if kind == "encrypt" else user_sk
        got = PLAIN_TYPES[tname].decode(
            golden.ctx.decrypt(Ciphertext.from_bytes(out), sk),
            golden.params)
    if got != app_value(tname, want):
        raise AssertionError(f"{name}: decrypts to {got!r}, expected "
                             f"{app_value(tname, want)!r}")


def app_error_cases(golden: FheApp, user_keys, calldata: dict):
    """A dozen invalid inputs (and three odd valid ones), each with the code
    the JAX package's golden app gives it: (label, name, calldata, code)."""
    ctx, prm = golden.ctx, golden.params
    pk, _ = user_keys
    k, n = len(prm.ct_moduli), prm.n
    mul_cc = calldata["mul_cipheru64_cipheru64"]
    a, b = pack.unpack_binary_operation(mul_cc, _PK_CODEC, _CT_CODEC,
                                        _CT_CODEC)[1:]
    rng = np.random.default_rng(SEED + 9)

    def binary(x, y, key=pk):
        cx = _CT_CODEC if isinstance(x, Ciphertext) else pack.BYTES
        cy = _CT_CODEC if isinstance(y, Ciphertext) else pack.BYTES
        return pack.pack_binary_operation(key, x, cx, y, cy)

    over = a.data.copy()
    over[1, 0, 11] = prm.ct_moduli[0]                  # == its modulus
    w = Writer()
    keyio.write_params(w, prm)
    w.u64(1)
    w.byte_vec(SealCiphertextBlob(compute_parms_id(n, prm.ct_moduli, prm.t),
                                  False, n, k, over).to_stream())
    over_bytes = w.getvalue()
    size3 = ctx.multiply(a, b)
    foreign = Ciphertext(dataclasses.replace(prm, plain_modulus=8192), a.data)
    relinless = dataclasses.replace(pk, relin=None)
    big = ctx.encrypt(PLAIN_TYPES["u256"].encode((1 << 200) + 5, prm),
                      golden.public_key, b"\x07" * 64)
    bad_offset = bytearray(mul_cc)
    bad_offset[4:8] = (len(mul_cc) + 1).to_bytes(4, "big")
    size0 = Ciphertext(prm, np.zeros((0, k, n), dtype=np.uint64))
    return [
        ("truncated calldata", "mul_cipheru64_cipheru64", mul_cc[:1000], 1),
        ("offset past the end", "mul_cipheru64_cipheru64",
         bytes(bad_offset), 1),
        ("truncated offsets", "encrypt_u64", b"\x00\x00", 1),
        ("random bytes", "mul_cipheru64_cipheru64", rng.bytes(300), 1),
        ("random ciphertext bytes", "decrypt_u64",
         pack.pack_one_argument(rng.bytes(400), pack.BYTES), 3),
        ("residue equal to its modulus", "mul_cipheru64_cipheru64",
         binary(over_bytes, b), 3),
        ("residue equal to its modulus", "add_cipheru64_cipheru64",
         binary(over_bytes, b), 3),
        ("size-3 operand", "mul_cipheru64_cipheru64", binary(size3, b), 7),
        ("foreign parameter set", "mul_cipheru64_cipheru64",
         binary(foreign, b), 7),
        ("foreign parameter set", "decrypt_u64",
         pack.pack_one_argument(foreign, _CT_CODEC), 5),
        ("key without relin keys", "mul_cipheru64_cipheru64",
         binary(a, b, relinless), 7),
        ("decode overflow", "decrypt_u64",
         pack.pack_one_argument(big, _CT_CODEC), 5),
        ("NaN plaintext", "encrypt_frac64",
         pack.pack_two_arguments(float("nan"), pack.FRAC64, b"x",
                                 pack.BYTES), 6),
        ("scalar of the wrong width", "encrypt_u64",
         pack.pack_two_arguments(b"\x01\x02\x03", pack.BYTES, b"x",
                                 pack.BYTES), 3),
        ("unknown name", "mul_cipheru64_cipheru65", mul_cc, 3),
        ("size-3 operand into add", "add_cipheru64_cipheru64",
         binary(size3, b), 0),
        ("size-0 operand into mul cp", "mul_cipheru64_u64",
         pack.pack_binary_operation(pk, size0, _CT_CODEC, 5, pack.U64), 0),
        ("boundary ciphertext", "decrypt_frac64",
         pack.pack_one_argument(boundary_ciphertext(ctx), _CT_CODEC), 0),
    ]


def app_pinned_hashes(app: FheApp) -> dict:
    """sha512 of the encrypt and of the refresh (reencrypt to the network
    key) of u256 12 with public data 010203, as ``tests/data/
    golden_hashes.json`` pins them."""
    enc_in = pack.pack_two_arguments(12, pack.U256, b"\x01\x02\x03",
                                     pack.BYTES)
    code, ct = app.call("encrypt_u256", enc_in)
    re_in = pack.pack_binary_operation(app.public_key,
                                       Ciphertext.from_bytes(ct), _CT_CODEC,
                                       b"\x01\x02\x03", pack.BYTES)
    code2, refreshed = app.call("reencrypt_u256", re_in)
    if code or code2:
        raise AssertionError(f"pinned-hash inputs: codes {code}, {code2}")
    return {"encrypt_u256_12_010203": hashlib.sha512(ct).hexdigest(),
            "refresh_u256_12_010203": hashlib.sha512(refreshed).hexdigest()}


def app_call_ms(app: FheApp, name: str, data: bytes, reps: int):
    """Host milliseconds of `reps` calls, each waited for on the card."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        code, _ = app.call(name, data)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if code:
            raise AssertionError(f"timed {name}: code {code}")
    return times


def phase_app(torch_app: FheApp, golden: FheApp, rows: dict,
              card: str) -> dict:
    """The 49 precompiles through ``FheApp(TESTNET_ONE, engine="torch")`` on
    the card and the port's golden app, on the embedded network keys and one
    set of user keys from the script's seed: code 0 and the same bytes on
    both, each result decrypting to its plaintext; every call with the
    launch counters set to 0 before it and read after; a dozen invalid
    inputs with the same code on both; the two hashes pinned in
    ``tests/data/golden_hashes.json`` from the card.  Then the median host
    time of a call on each app by op class, and of a ``mul`` cc on the
    torch app split into unpack, engine and ``to_bytes``."""
    if torch_app._engine.device.type != "cuda":
        raise AssertionError("the torch app is not on the card")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        canonical = zstd_probes.check_python_zstd_canonical()
    user_keys = golden.ctx.generate_keys(
        seed=hashlib.sha512(str(SEED).encode()).digest())
    calldata = {name: app_calldata(golden, user_keys[0], name)
                for name in PRECOMPILE_NAMES}

    totals = {name: 0 for name in KERNEL_NAMES}
    by_class = {}
    for name in PRECOMPILE_NAMES:
        data = calldata[name]
        reset_launch_counts()
        got = torch_app.call(name, data)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = golden.call(name, data)
        if got[0] != 0 or want[0] != 0:
            raise AssertionError(f"{name}: code {got[0]} on the card, "
                                 f"{want[0]} on the golden app")
        if got[1] != want[1]:
            raise AssertionError(f"{name}: bytes differ from the golden app")
        app_check_value(golden, user_keys[1], name, got[1])
        cls = app_op_class(name)
        if counts != expected_counts(APP_CALLS[cls]):
            raise AssertionError(f"{name}: launch counts {counts}, expected "
                                 f"{expected_counts(APP_CALLS[cls])}")
        by_class[cls] = {k: v for k, v in counts.items() if v}
        for k, v in counts.items():
            totals[k] += v
    path = set(CALLS_PER_MUL_RELIN)
    if any(totals[k] == 0 for k in path):
        raise AssertionError(f"a kernel of the app path never ran: {totals}")
    for k in path:
        rows[k]["launches_app"] = totals[k]

    errors = []
    for label, name, data, code in app_error_cases(golden, user_keys,
                                                   calldata):
        reset_launch_counts()
        got = torch_app.call(name, data)
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        want = golden.call(name, data)
        if got != want or want[0] != code:
            raise AssertionError(
                f"{label} ({name}): card code {got[0]}, golden code "
                f"{want[0]}, expected {code}; bytes equal: "
                f"{got[1] == want[1]}")
        # a size-0 ciphertext has no rows: only the plain's transform runs
        if label.startswith("size-0") and counts != {"ntt": 1}:
            raise AssertionError(f"{label}: launch counts {counts}")
        errors.append({"case": label, "name": name, "code": code,
                       "launches": counts})

    # the canonical bytes: the outputs of uniform residues compress to the
    # pinned frames whichever zstd codec runs
    with open(GOLDEN_HASHES) as f:
        pinned = json.load(f)
    got_hashes = app_pinned_hashes(torch_app)
    for key, digest in got_hashes.items():
        if digest != pinned[key]:
            raise AssertionError(f"{key}: the card's bytes are not the "
                                 "pinned canonical bytes")

    ms = {"torch": {}, "golden": {}}
    ms_all = {"torch": {}, "golden": {}}
    for cls, name in APP_TIMED.items():
        for label, app, reps in (("torch", torch_app, 15),
                                 ("golden", golden, 5)):
            times = app_call_ms(app, name, calldata[name], reps)
            ms[label][cls] = statistics.median(times)
            ms_all[label][cls] = times

    # one mul cc on the torch app, step by step (the pk cache is warm)
    data = calldata["mul_cipheru64_cipheru64"]
    eng = torch_app._engine
    split = {"unpack": [], "engine": [], "to_bytes": [], "relin_keys": []}
    for _ in range(15):
        t0 = time.perf_counter()
        pk, a, b = pack.unpack_binary_operation(data, _PK_CODEC, _CT_CODEC,
                                                _CT_CODEC)
        t1 = time.perf_counter()
        out = eng.mul_relin(a, b, pk.relin)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        blob = out.to_bytes()
        t3 = time.perf_counter()
        eng._rk(pk.relin)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            split[key].append(dt * 1e3)
        if blob != golden.call("mul_cipheru64_cipheru64", data)[1]:
            raise AssertionError("the split mul cc differs from the golden "
                                 "app")
    return {"phase": "app", "ok": True, "card": card,
            "shared": (user_keys, calldata),
            "preset": "testnet.one", "zstd_codec": zstd_codec.codec_name(),
            "zstd_canonical": canonical,
            "zstd_warning": [str(w.message) for w in caught],
            "ops_equal_to_golden": len(PRECOMPILE_NAMES),
            "values_ok": True, "pinned_hashes_equal": sorted(got_hashes),
            "launches_by_class": by_class,
            "launches": totals, "errors_same_code": errors,
            "ms_median": ms,
            "mul_cc_split_ms_median": {k: statistics.median(v)
                                       for k, v in split.items()},
            "ms_all": ms_all}


# ---------------------------------------------------------------------------
# phase native_engine: the CPU validator's engine against the card's
# ---------------------------------------------------------------------------

def host_cpu() -> dict:
    """The host CPU as ``/proc/cpuinfo`` names its first core (model name,
    vendor, family and model number, clock), and the core count."""
    with open("/proc/cpuinfo") as f:
        first = f.read().split("\n\n")[0]
    fields = dict(line.split(":", 1) for line in first.splitlines()
                  if ":" in line)
    fields = {k.strip(): v.strip() for k, v in fields.items()}
    return {"model_name": fields.get("model name"),
            "vendor": fields.get("vendor_id"),
            "family": fields.get("cpu family"), "model": fields.get("model"),
            "mhz": fields.get("cpu MHz"), "cores": os.cpu_count()}


def phase_native_engine(native_app: FheApp, torch_app: FheApp,
                        golden: FheApp, user_keys, calldata: dict,
                        timing: dict, card: str) -> dict:
    """The 49 precompiles on phase app's calldata through ``FheApp(
    TESTNET_ONE, engine="native")`` (`native_app`: the C++ host engine on
    the CPU, the engine of a validator without a card), with the launch
    counters set to 0 before its calls and read after: no kernel ran.
    Each (code, bytes) equal to the card's torch app's and the golden
    app's, each value decrypting right; phase app's invalid inputs with
    the same code on the three (none is a size-1 ciphertext, on which the
    C++ engine and the golden model differ: phase c_abi holds those native
    against native).  Then host ms a call by op class on the native app
    and the torch app in turns, and one ``NativeEngine.mul_relin`` in ms
    beside phase timing's B = 1 and B = 128 ms a multiply on the card."""
    cases = app_error_cases(golden, user_keys, calldata)
    reset_launch_counts()
    outs = {name: native_app.call(name, calldata[name])
            for name in PRECOMPILE_NAMES}
    err_outs = [native_app.call(name, data) for _, name, data, _ in cases]
    torch.cuda.synchronize()
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the native app launched kernels: {counts}")
    for name in PRECOMPILE_NAMES:
        got = outs[name]
        if got[0] != 0 or got != torch_app.call(name, calldata[name]) \
                or got != golden.call(name, calldata[name]):
            raise AssertionError(f"{name} on the native app: code {got[0]}, "
                                 "not the torch and golden apps' bytes")
        app_check_value(golden, user_keys[1], name, got[1])
    for (label, name, data, code), got in zip(cases, err_outs):
        if not got == torch_app.call(name, data) == golden.call(name, data) \
                or got[0] != code:
            raise AssertionError(f"{label} ({name}) on the native app: code "
                                 f"{got[0]}, expected {code}")

    ms, ms_all = {"native": {}, "torch": {}}, {"native": {}, "torch": {}}
    for cls, name in APP_TIMED.items():
        times = {"native": [], "torch": []}
        for _ in range(7):              # in turns
            for label, app in (("native", native_app), ("torch", torch_app)):
                times[label] += app_call_ms(app, name, calldata[name], 1)
        for label, t in times.items():
            ms[label][cls] = statistics.median(t)
            ms_all[label][cls] = t
    pk, a, b = pack.unpack_binary_operation(
        calldata["mul_cipheru64_cipheru64"], _PK_CODEC, _CT_CODEC, _CT_CODEC)
    eng = native_app._engine
    want = torch_app._engine.mul_relin(a, b, pk.relin).data
    mul_relin = []
    for _ in range(7):
        t0 = time.perf_counter()
        out = eng.mul_relin(a, b, pk.relin)
        mul_relin.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(out.data, want):
            raise AssertionError("NativeEngine.mul_relin differs from the "
                                 "card's")
    return {"phase": "native_engine", "ok": True, "card": card,
            "host_cpu": host_cpu(),
            "library": os.path.relpath(build.HOST_ENGINE_LIB),
            "ops_equal_to_torch_and_golden": len(PRECOMPILE_NAMES),
            "errors_same_code": len(cases), "launches": counts,
            "ms_median": ms, "ms_all": ms_all,
            "mul_relin_ms_median": statistics.median(mul_relin),
            "mul_relin_ms_all": mul_relin,
            "card_mul_relin_ms": {
                "batch_1": timing["batch_sizes"]["1"]["ms_per_batch"],
                "batch_128_per_multiply":
                    timing["ms_per_batch_median"] / BATCH}}


# ---------------------------------------------------------------------------
# phase serve: a stream of precompile calls through ByteServer
# ---------------------------------------------------------------------------

def serve_requests(golden: FheApp, stream: RequestStream, user_keys,
                   calldata: dict, cases):
    """The 1,024 requests of phase serve, shuffled with the script's seed,
    and the count of cipher∘cipher multiplies under each user key.

    Two user keys from the seed (phase app's and a second), 16 distinct
    ciphertexts a key, their plain types cycling over the four; then, in
    order: ``make_mixed_requests``' mix (45 % add, 10 % sub, 45 % mul) of
    those, all cipher∘cipher, half under each key; 32 per-request calls
    (cp, pc, encrypt, decrypt, reencrypt; phase app's calldata); the first
    16 of phase app's invalid or odd inputs."""
    ctx, prm = golden.ctx, golden.params
    second = ctx.generate_keys(
        seed=hashlib.sha512(str(SEED + 1).encode()).digest())
    n_cc = SERVE_REQUESTS - SERVE_PER_REQUEST - SERVE_MALFORMED
    tnames = list(SCALARS)
    reqs, muls = [], []
    for u, (pk, _sk) in enumerate((user_keys, second)):
        key = types.SimpleNamespace(to_bytes=lambda b=pk.to_bytes(): b)
        cts, blobs = [], []
        for j in range(SERVE_DISTINCT):
            t = tnames[j % len(tnames)]
            cts.append(ctx.encrypt(
                PLAIN_TYPES[t].encode(app_value(t, j + 1), prm), pk,
                hashlib.sha512(f"serve {u} {j}".encode()).digest()))
            blobs.append(_CT_CODEC.serialize(cts[-1]))
        slot = {id(ct.data): j for j, ct in enumerate(cts)}
        mixed = stream.make_mixed_requests(cts, n_cc // 2, seed=SEED + u)
        for r in mixed:
            i, j = slot[id(r.a)], slot[id(r.b)]
            t = tnames[i % len(tnames)]
            reqs.append((f"{r.op}_cipher{t}_cipher{t}",
                         pack.pack_binary_operation(key, blobs[i], pack.BYTES,
                                                    blobs[j], pack.BYTES)))
        muls.append(sum(r.op == "mul" for r in mixed))
    rng = np.random.default_rng(SEED + 10)
    per_request = [name for name in PRECOMPILE_NAMES
                   if name != "public_key_bytes"
                   and BINARY_SPECS.get(name, ("", ""))[1] != "cc"]
    for name in rng.choice(per_request, SERVE_PER_REQUEST, replace=False):
        reqs.append((str(name), calldata[name]))
    for _label, name, data, _code in cases[:SERVE_MALFORMED]:
        reqs.append((name, data))
    assert len(reqs) == SERVE_REQUESTS
    return [reqs[i] for i in rng.permutation(len(reqs))], muls


def profiled_run(server: ByteServer, reqs, want) -> dict:
    """One ``server.run(reqs)`` under ``torch.profiler``: its wall time, the
    card's busy time (the device events' self time, as the profiler's
    table sums it) and the idle share, and the device-to-host copies'
    part of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        got = server.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if got != want:
        raise AssertionError("the profiled run differs")
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "memcpy_dtoh_ms": sum(e.self_device_time_total for e in dev
                                  if e.key.startswith("Memcpy DtoH")) / 1e3}


def latency_ms(server: ByteServer, reqs) -> list:
    """Submit every request at once; milliseconds from each submit to its
    answer, and the answers."""
    done = {}
    futs = []
    for i, (name, data) in enumerate(reqs):
        t0 = time.perf_counter()
        fut = server.submit(name, data)
        fut.add_done_callback(
            lambda f, i=i, t0=t0: done.__setitem__(i, time.perf_counter()
                                                   - t0))
        futs.append(fut)
    outs = [f.result(timeout=120) for f in futs]
    return [done[i] * 1e3 for i in range(len(reqs))], outs


def measure_server(torch_app: FheApp, reqs, want, golden_out: dict,
                   codec: str, want_fallbacks: dict, expect_counts,
                   launches_key: str, rows: dict) -> dict:
    """Phase serve's stream through ``ByteServer(TESTNET_ONE,
    max_batch=128, codec=codec)`` on the card's torch app: every response
    equal to call by call (`want`) and the sampled ones to the golden app
    (`golden_out`); the fallbacks by reason equal to `want_fallbacks`; the
    launch counters, set to 0 before the run, equal to
    ``expect_counts(server)`` (derived before the run) and every kernel of
    ``_mul_relin`` launched (written into ``rows`` under `launches_key`).
    Then requests a second of ``run`` (median of 3), the run's split, one
    run under the profiler (``profiled_run``), the same on one worker
    thread, continuous mode (a lone ``mul`` cc at flush_ms = 5, ten times,
    and a burst of ``SERVE_BURST`` submits), and no batched fault in any of
    these later runs."""
    server = ByteServer(TESTNET_ONE, max_batch=SERVE_MAX_BATCH, app=torch_app,
                        codec=codec)
    try:
        want_counts = expect_counts(server)
        reset_launch_counts()
        got = server.run(reqs)
        torch.cuda.synchronize()
        counts = launch_counts()
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        if bad:
            raise AssertionError(f"{codec}: {len(bad)} responses differ from "
                                 f"call by call, first {reqs[bad[0]][0]}")
        for i, out in golden_out.items():
            if got[i] != out:
                raise AssertionError(f"{codec}: {reqs[i][0]} differs from the "
                                     "golden app")
        fallbacks = {r: server.fallbacks.get(r, 0) for r in FALLBACK_REASONS}
        if fallbacks != want_fallbacks or \
                set(server.fallbacks) - set(FALLBACK_REASONS):
            raise AssertionError(f"{codec}: fallbacks {dict(server.fallbacks)}"
                                 f", expected {want_fallbacks}")
        pooled = {c: server.pooled.get(c, 0) for c in POOL_COUNTERS}
        if counts != want_counts:
            raise AssertionError(f"{codec}: server launches {counts}, "
                                 f"expected {want_counts}")
        if any(counts[k] == 0 for k in CALLS_PER_MUL_RELIN):
            raise AssertionError(f"{codec}: a kernel of the serve path never "
                                 f"ran: {counts}")
        for k in KERNEL_NAMES:
            rows[k][launches_key] = counts[k]

        run_s, splits = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            again = server.run(reqs)
            torch.cuda.synchronize()
            run_s.append(time.perf_counter() - t0)
            splits.append(server.last_split_ms)
            if again != want:
                raise AssertionError(f"{codec}: a repeated run differs")
        profiled = profiled_run(server, reqs, want)

        # the same run on one worker thread: what the threads buy
        with ByteServer(TESTNET_ONE, workers=1, max_batch=SERVE_MAX_BATCH,
                        app=torch_app, codec=codec) as single:
            t0 = time.perf_counter()
            if single.run(reqs) != want:
                raise AssertionError(f"{codec}: the one-worker run differs")
            one_worker_s = time.perf_counter() - t0
            one_worker_split = single.last_split_ms

        mul_cc = next(r for r, w in zip(reqs, want)
                      if r[0].startswith("mul_")
                      and BINARY_SPECS.get(r[0], ("", ""))[1] == "cc"
                      and w[0] == 0)
        server.start_continuous(flush_ms=5.0)
        try:
            lone = []
            for _ in range(10):
                ms, outs = latency_ms(server, [mul_cc])
                lone += ms
                if outs[0] != torch_app.call(*mul_cc):
                    raise AssertionError(f"{codec} continuous: lone request "
                                         "differs")
            t0 = time.perf_counter()
            burst, outs = latency_ms(server, reqs[:SERVE_BURST])
            burst_s = time.perf_counter() - t0
            if outs != want[:SERVE_BURST]:
                raise AssertionError(f"{codec} continuous: the burst differs")
        finally:
            server.stop_continuous()
        if server.fallbacks["device"] or server.fallbacks["encode"]:
            raise AssertionError(f"{codec}: a batched fault in a later run: "
                                 f"{dict(server.fallbacks)}")
        zstd = {} if server.codec is None else {
            "zstd_source": server.codec.zstd_source,
            "zstd_canonical": server.codec.zstd_canonical()}
    finally:
        server.close()
    return {"workers": server.workers,
            "equal_to_call_by_call": len(reqs),
            "equal_to_golden_sample": len(golden_out),
            "fallbacks": fallbacks, "pooled": pooled, "launches": counts,
            "requests_per_s_median": len(reqs) / statistics.median(run_s),
            "run_s": run_s,
            "run_split_ms_median": {
                k: statistics.median(sp[k] for sp in splits)
                for k in splits[0]},
            "one_worker_s": one_worker_s,
            "one_worker_split_ms": one_worker_split,
            "profiled_run": profiled,
            "continuous": {
                "flush_ms": 5.0, "lone_mul_cc_ms_median":
                statistics.median(lone), "lone_ms": lone,
                "burst": SERVE_BURST,
                "burst_p50_ms": float(np.percentile(burst, 50)),
                "burst_p99_ms": float(np.percentile(burst, 99)),
                "burst_s": burst_s},
            **zstd}


def phase_serve(torch_app: FheApp, golden: FheApp, user_keys, calldata: dict,
                rows: dict, card: str, codec_build) -> dict:
    """A stream of 1,024 precompile calls (``serve_requests``) through
    ``ByteServer`` on the card's torch app, once with each codec
    (``measure_server``), against the torch app's ``FheApp.call`` one at a
    time (each call's launches counted) and 32 of them against the golden
    app.

    The python codec: no cipher∘cipher request falls back; its launches
    are the per-request calls' plus one ``_mul_relin``'s for each batch of
    up to 128 multiplies a key.  The native codec (its library built by g++
    from the repo's sources; `codec_build`: the future of
    ``build_codec_timed``, started beside the CUDA build): the only
    fallbacks are the stream's size-3 ciphertexts, at least one window is
    pooled, and its launches are ``native_serve_counts``'."""
    stream = RequestStream(torch_app._engine, max_batch=SERVE_MAX_BATCH)
    cases = app_error_cases(golden, user_keys, calldata)
    reqs, muls = serve_requests(golden, stream, user_keys, calldata, cases)
    # call by call on the torch app, each call's launches counted
    want, each = [], []
    t0 = time.perf_counter()
    for name, data in reqs:
        reset_launch_counts()
        want.append(torch_app.call(name, data))
        each.append(launch_counts())
    torch.cuda.synchronize()
    call_by_call_s = time.perf_counter() - t0
    sample = np.random.default_rng(SEED + 11).choice(
        len(reqs), SERVE_GOLDEN_SAMPLE, replace=False)
    golden_out = {int(i): golden.call(*reqs[i]) for i in sample}

    is_cc = [BINARY_SPECS.get(name, ("", ""))[1] == "cc" for name, _ in reqs]
    size3 = [name for label, name, _, _ in cases[:SERVE_MALFORMED]
             if label.startswith("size-3")]
    batches = sum(-(-m // SERVE_MAX_BATCH) for m in muls)
    python_counts = {k: batches * CALLS_PER_MUL_RELIN.get(k, 0)
                     + sum(c[k] for c, cc in zip(each, is_cc) if not cc)
                     for k in KERNEL_NAMES}
    python = measure_server(
        torch_app, reqs, want, golden_out, "python",
        {"not_batchable": sum(name in PRECOMPILE_NAMES and not cc
                              for (name, _), cc in zip(reqs, is_cc)),
         "ciphertext_size": sum(BINARY_SPECS.get(name, ("", ""))[1] == "cc"
                                for name in size3),
         "device": 0, "encode": 0},
        lambda _server: python_counts, "launches_serve", rows)

    build_s = codec_build.result()
    want_pooled = []

    def native_counts(server: ByteServer) -> dict:
        counts, pooled = native_serve_counts(server, reqs, want, each)
        want_pooled.append(pooled)
        return counts
    native_out = measure_server(
        torch_app, reqs, want, golden_out, "native",
        {"not_batchable": 0, "ciphertext_size": len(size3), "device": 0,
         "encode": 0}, native_counts, "launches_serve_native", rows)
    if native_out["pooled"]["pooled_windows"] != want_pooled[0] or \
            want_pooled[0] < 1:
        raise AssertionError(f"native: pooled {native_out['pooled']}, "
                             f"expected {want_pooled[0]} pooled windows "
                             "(>= 1)")
    return {"phase": "serve", "ok": True, "card": card,
            "preset": "testnet.one", "requests": len(reqs),
            "max_batch": SERVE_MAX_BATCH,
            "cc_requests": sum(is_cc), "mul_cc_by_key": muls,
            "mul_batches": batches,
            "launches_call_by_call": {k: sum(c[k] for c in each)
                                      for k in KERNEL_NAMES},
            "call_by_call_requests_per_s": len(reqs) / call_by_call_s,
            "call_by_call_s": call_by_call_s,
            **python,
            "native": {"library": os.path.relpath(build.NATIVE_CODEC_LIB),
                       "build_s": build_s, **native_out},
            "shared": (reqs, want, each)}


def native_serve_counts(server: ByteServer, reqs, want, each) -> tuple:
    """The kernel launches and pooled groups that ``server.run(reqs)`` must
    make with the native codec, derived from what ``_run_native`` does with
    each window of ``pipeline_window`` requests as the C++ codec decodes
    them: a cipher∘cipher group of one key whose operands repeat is pooled
    (one _prepare a chunk of max_batch distinct operands where it
    multiplies, one prepared multiply a chunk of max_batch multiplies),
    else one _mul_relin a chunk of multiplies; one dispatch a chunk of each
    plain op, of encrypts and of decrypts; a reencrypt's decrypt in the
    decrypts' kind of chunk, its encrypt in a chunk of its target key where
    the call-by-call result was code 0; a request of another ciphertext
    size its own call's launches (`each`)."""
    cb, W = server.max_batch, server.pipeline_window
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    pooled = 0

    def add(calls: dict, times: int = 1) -> None:
        for k, v in calls.items():
            counts[k] += v * times

    def chunks(n: int) -> int:
        return -(-n // cb)

    for w0 in range(0, len(reqs), W):
        groups, plain, reenc_keys = {}, collections.Counter(), {}
        n_enc = n_dec = n_reenc = 0
        for i in range(w0, min(w0 + W, len(reqs))):
            kind, payload = server._decode_native(*reqs[i])
            ref = None
            if kind in ("fallback", "fallback_pk"):
                add(each[i])
                ref = payload
            elif kind == "enc":
                n_enc += 1
            elif kind == "dec":
                n_dec += 1
            elif kind == "reenc":
                n_reenc += 1
                ref = payload[2]
                if want[i][0] == 0:
                    reenc_keys[ref.id] = reenc_keys.get(ref.id, 0) + 1
            elif kind == "plain_pk":
                plain[payload[0]] += 1
                ref = payload[3]
            elif kind == "cc":
                op, ref, a, b, _digests = payload
                groups.setdefault(ref.id, []).append((op, a.tobytes(),
                                                      b.tobytes()))
            if ref is not None:
                ref.release()
        for items in groups.values():
            distinct = len({x for _, a, b in items for x in (a, b)})
            muls = sum(op == "mul" for op, _, _ in items)
            if distinct < 2 * len(items):
                pooled += 1
                if muls:
                    add(PREPARE_CALLS, chunks(distinct))
                add(PREPARED_MUL_CALLS, chunks(muls))
            else:
                add(CALLS_PER_MUL_RELIN, chunks(muls))
        for fn, n in plain.items():
            add(PLAIN_CALLS[fn], chunks(n))
        add(APP_CALLS["encrypt"], chunks(n_enc)
            + sum(chunks(n) for n in reenc_keys.values()))
        add(APP_CALLS["decrypt"], chunks(n_dec) + chunks(n_reenc))
    return counts, pooled


def build_codec_timed() -> float:
    """Builds the native codec library (g++); returns the seconds it
    took."""
    t0 = time.perf_counter()
    build.build_native_codec()
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase soak: identical windows through the native codec, memory held flat
# ---------------------------------------------------------------------------

def vmrss_kb() -> int:
    """Resident kB of this process after glibc hands its free pages back
    (``malloc_trim``), so that the reading is memory still in use, not the
    tensors a run freed into the allocator's arenas."""
    ctypes.CDLL(None).malloc_trim(0)
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    raise RuntimeError("no VmRSS in /proc/self/status")


def serve_ciphertexts(golden: FheApp, pk) -> list:
    """Phase serve's 16 distinct ciphertexts under `pk` (phase app's user
    key), with their plain types: [(tname, Ciphertext)]."""
    tnames = list(SCALARS)
    out = []
    for j in range(SERVE_DISTINCT):
        t = tnames[j % len(tnames)]
        out.append((t, golden.ctx.encrypt(
            PLAIN_TYPES[t].encode(app_value(t, j + 1), golden.params), pk,
            hashlib.sha512(f"serve 0 {j}".encode()).digest())))
    return out


def soak_requests(golden: FheApp, user_keys, calldata: dict,
                  window: int) -> list:
    """One window of ``tests/test_serve_soak.py``'s mix (48 add / sub /
    mul cipher∘cipher under one user key, then an encrypt and a decrypt,
    in every 50) widened to `window` requests: the operands drawn with the
    script's seed from phase serve's 16 distinct ciphertexts under phase
    app's user key, so that the pooled groups form; phase app's
    ``encrypt_u64`` and ``decrypt_u64`` calldata."""
    pk = user_keys[0]
    key = types.SimpleNamespace(to_bytes=lambda b=pk.to_bytes(): b)
    cts = [(t, _CT_CODEC.serialize(ct))
           for t, ct in serve_ciphertexts(golden, pk)]
    rng = np.random.default_rng(SEED + 12)
    reqs = []
    for i in range(window):
        if i % 50 == 48:
            reqs.append(("encrypt_u64", calldata["encrypt_u64"]))
        elif i % 50 == 49:
            reqs.append(("decrypt_u64", calldata["decrypt_u64"]))
        else:
            x, y = rng.integers(0, SERVE_DISTINCT, 2)
            t = cts[x][0]
            reqs.append((f"{('add', 'sub', 'mul')[i % 3]}_cipher{t}_cipher{t}",
                         pack.pack_binary_operation(key, cts[x][1],
                                                    pack.BYTES, cts[y][1],
                                                    pack.BYTES)))
    return reqs


def phase_soak(torch_app: FheApp, golden: FheApp, user_keys, calldata: dict,
               rows: dict, card: str) -> dict:
    """``ByteServer(TESTNET_ONE, codec="native")`` over the card's torch app
    on one window of ``soak_requests`` (its ``pipeline_window``, 256),
    first equal to ``FheApp.call`` one at a time; every worker's zstd
    contexts made (as ``tests/test_serve_soak.py`` does), ``SOAK_WARM``
    runs, then ``SOAK_MEASURED`` runs, each with the launch counters set to
    0 before it and read after.  Gates: every run byte-equal to the first,
    the same launches every run (kernels 1-7 among them), host RSS growth
    over the measured runs under the reference's 60 MB, and
    ``torch.cuda.memory_allocated()`` after each measured run equal to its
    value after the warm runs.  Reports requests/s and the card's peak
    memory."""
    server = ByteServer(TESTNET_ONE, max_batch=SERVE_MAX_BATCH, app=torch_app,
                        codec="native")
    try:
        reqs = soak_requests(golden, user_keys, calldata,
                             server.pipeline_window)
        want = [torch_app.call(name, data) for name, data in reqs]
        i_mul = next(i for i, (name, _) in enumerate(reqs)
                     if name.startswith("mul_"))
        out_arr = Ciphertext.from_bytes(want[i_mul][1]).data
        barrier = threading.Barrier(server.workers)

        def prime():
            barrier.wait(timeout=60)    # each worker takes one task
            server.codec.pack_ciphertext(out_arr)               # CCtx
            server.codec.unpack_binary(*reqs[i_mul])[7].release()  # DCtx
            barrier.wait(timeout=60)
        for f in [server._pool.submit(prime) for _ in range(server.workers)]:
            f.result(timeout=120)

        torch.cuda.empty_cache()        # earlier phases' cached blocks
        first = server.run(reqs)
        if first != want:
            raise AssertionError("soak: the first run differs from call by "
                                 "call")
        for _ in range(SOAK_WARM - 1):
            if server.run(reqs) != first:
                raise AssertionError("soak: a warm run differs")
        torch.cuda.synchronize()
        gc.collect()
        allocated0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rss0 = vmrss_kb()
        run_s, counts, allocated, rss = [], [], [], []
        for _ in range(SOAK_MEASURED):
            reset_launch_counts()
            t0 = time.perf_counter()
            got = server.run(reqs)
            torch.cuda.synchronize()
            run_s.append(time.perf_counter() - t0)
            counts.append(launch_counts())
            allocated.append(torch.cuda.memory_allocated())
            if got != first:
                raise AssertionError("soak: a measured run differs")
            del got                     # 246 outputs, about 30 MB
            gc.collect()
            rss.append(vmrss_kb() - rss0)
        rss1 = rss0 + rss[-1]
        pooled = dict(server.pooled)
        fallbacks = dict(server.fallbacks)
        zstd = {"zstd_source": server.codec.zstd_source,
                "zstd_canonical": server.codec.zstd_canonical()}
        workers = server.workers
    finally:
        server.close()
    if any(c != counts[0] for c in counts):
        raise AssertionError(f"soak: launches differ run for run: {counts}")
    if any(counts[0][k] == 0 for k in CALLS_PER_MUL_RELIN):
        raise AssertionError(f"a kernel of the soak never ran: {counts[0]}")
    if rss1 - rss0 >= SOAK_RSS_BOUND_KB:
        raise AssertionError(f"soak: RSS grew {rss1 - rss0} kB")
    if any(a != allocated0 for a in allocated):
        raise AssertionError(f"soak: device memory {allocated} after the "
                             f"runs, {allocated0} before")
    for k in KERNEL_NAMES:
        rows[k]["launches_soak"] = counts[0][k]
    return {"phase": "soak", "ok": True, "card": card,
            "preset": "testnet.one", "requests": len(reqs),
            "mul_cc": sum(name.startswith("mul_") for name, _ in reqs),
            "workers": workers, "warm_runs": SOAK_WARM,
            "measured_runs": SOAK_MEASURED,
            "runs_equal_to_the_first": SOAK_MEASURED + SOAK_WARM - 1,
            "launches_per_run": counts[0], "pooled": pooled,
            "fallbacks": fallbacks,
            "rss_growth_kb": rss1 - rss0, "rss_bound_kb": SOAK_RSS_BOUND_KB,
            "rss_growth_kb_by_run": rss,
            "memory_allocated": allocated0,
            "memory_allocated_after_runs": allocated,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "max_memory_reserved": torch.cuda.max_memory_reserved(),
            "requests_per_s_median": len(reqs) / statistics.median(run_s),
            "run_s": run_s, **zstd}


# ---------------------------------------------------------------------------
# phase c_abi: the 51-symbol C library
# ---------------------------------------------------------------------------

def size_one_calls(user_keys) -> list:
    """Decrypt and reencrypt of each plain type on a size-1 ciphertext (its
    one component drawn with the script's seed), and a ``mul`` cc with one:
    (name, calldata).  The C++ engine decrypts such a ciphertext where the
    golden model gives 5, so these are held native against native."""
    rng = np.random.default_rng(SEED + 13)
    prm = TESTNET_ONE
    c1 = Ciphertext(prm, np.stack([rng.integers(0, p, prm.n, dtype=np.uint64)
                                   for p in prm.ct_moduli])[None])
    calls = [("mul_cipheru64_cipheru64", pack.pack_binary_operation(
        user_keys[0], c1, _CT_CODEC, c1, _CT_CODEC))]
    for t in SCALARS:
        calls.append((f"decrypt_{t}", pack.pack_one_argument(c1, _CT_CODEC)))
        calls.append((f"reencrypt_{t}", pack.pack_binary_operation(
            user_keys[0], c1, _CT_CODEC, b"\x01", pack.BYTES)))
    return calls


def exported_names(path) -> set:
    """The functions a loader can resolve in the shared library `path`."""
    out = subprocess.run(["nm", "-D", "--defined-only", str(path)],
                         check=True, capture_output=True, text=True).stdout
    return {f[2] for f in map(str.split, out.splitlines())
            if len(f) == 3 and f[1] == "T"}


def run_host(cmd: list, label: str) -> tuple:
    """Runs a C host as its own process; it must print HOST TEST PASSED.
    Returns its output lines and its seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0 or "HOST TEST PASSED" not in proc.stdout:
        raise AssertionError(f"{label}: exit {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout.strip().splitlines(), seconds


def cpu_library_checks(torch_app: FheApp, native_app: FheApp, user_keys,
                       calldata: dict) -> dict:
    """``libc_fhe_cpu.so`` and ``.a`` (linked from the codec's objects):
    its dynamic names exactly the reference's 51 and the three
    ``fhe_tpu_*`` calls; the 49 precompiles through it by ctypes on this
    process's zstd build, each equal to the torch app's ``FheApp.call``,
    with no launch; the size-1 calls equal to the native app's (native
    against native); ``host_test.c`` linked to the shared library and,
    statically, to the archive (its keys by ``--keys``), each passing in a
    process of its own, with no Python among its dependencies (and no
    ``libc_fhe`` in the static one's); the zstd build it runs.  Returns
    the phase's record and the ctypes view."""
    t0 = time.perf_counter()
    path = native.build_cpu()
    build_s = time.perf_counter() - t0
    names = exported_names(path)
    want_names = ({f"c_fhe_{n}" for n in PRECOMPILE_NAMES}
                  | {"fhe_free", "fhe_error", "fhe_tpu_init_keys",
                     "fhe_tpu_use_libzstd", "fhe_tpu_zstd_canonical"})
    if names != want_names:
        raise AssertionError("libc_fhe_cpu.so: names beyond or short of the "
                             f"51 and the three: {sorted(names ^ want_names)}")
    cpu = native.NativeFhe(path)
    zstd_source = codec_mod.process_zstd()
    cpu.use_zstd(zstd_source)
    reset_launch_counts()
    outs = {name: cpu.call(name, calldata[name]) for name in PRECOMPILE_NAMES}
    size1 = [(name, data, cpu.call(name, data))
             for name, data in size_one_calls(user_keys)]
    torch.cuda.synchronize()
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the CPU library launched kernels: {counts}")
    for name in PRECOMPILE_NAMES:
        if outs[name][0] != 0 or \
                outs[name] != torch_app.call(name, calldata[name]):
            raise AssertionError(f"{name} through libc_fhe_cpu.so: code "
                                 f"{outs[name][0]}, not the torch app's")
    for name, data, got in size1:
        if got != native_app.call(name, data):
            raise AssertionError(f"size-1 {name}: libc_fhe_cpu.so and the "
                                 "native app differ")

    hosts, host_s = {}, {}
    t0 = time.perf_counter()
    exes = {link: native.build_host_test(link)
            for link in ("cpu", "cpu_static")}
    hosts_build_s = time.perf_counter() - t0
    for link, exe in exes.items():
        deps = subprocess.run(["ldd", exe], capture_output=True,
                              text=True).stdout.lower()
        if "python" in deps or (link == "cpu_static" and "libc_fhe" in deps):
            raise AssertionError(f"host_test ({link}) depends on:\n{deps}")
    data_dir = os.path.normpath(os.path.join(os.path.dirname(native.__file__),
                                             os.pardir, "data"))
    keys = [os.path.join(data_dir, f"network.{x}") for x in ("pub", "pri")]
    hosts["cpu"], host_s["cpu"] = run_host([exes["cpu"]], "host_test_cpu")
    hosts["cpu_static"], host_s["cpu_static"] = run_host(
        [exes["cpu_static"], "--keys", *keys], "host_test_cpu_static")
    return {"library": os.path.relpath(path),
            "static": os.path.relpath(build.NATIVE_CPU_STATIC),
            "build_s": build_s, "hosts_build_s": hosts_build_s,
            "exports": {"c_fhe_*": sum(n.startswith("c_fhe_") for n in names),
                        "others": sorted(n for n in names
                                         if not n.startswith("c_fhe_"))},
            "ops_equal_to_torch_app": len(outs),
            "size_one_equal_to_native_app": [name for name, _, _ in size1],
            "launches": counts, "host_test": hosts, "host_test_s": host_s,
            "zstd_source": zstd_source,
            "zstd_canonical": cpu.zstd_canonical()}, cpu


def phase_c_abi(torch_app: FheApp, native_app: FheApp, user_keys,
                calldata: dict, rows: dict, card: str) -> dict:
    """Builds ``libc_fhe.so`` and ``host_test.c``, runs the host as its own
    process (a C ``main``, its own interpreter, the default app: the torch
    engine on the card; it must print HOST TEST PASSED), then calls the 49
    precompiles through the ctypes view in this process, on the default
    app: each gives the torch app's code 0 and bytes and launches the
    kernels phase app counted for its class.  Then the CPU library
    (``cpu_library_checks``).  Then the host milliseconds of a call through
    each library against ``FheApp.call`` by op class."""
    t0 = time.perf_counter()
    lib = native.build()
    exe = native.build_host_test()
    build_s = time.perf_counter() - t0
    host_lines, host_s = run_host([exe], "host_test")

    abi = native.NativeFhe(lib)
    native.use_app(None)
    app = native.current_app()          # built here, not inside a count
    if app._engine.device.type != "cuda":
        raise AssertionError("the ABI's default app is not on the card")
    totals = {name: 0 for name in KERNEL_NAMES}
    for name in PRECOMPILE_NAMES:
        data = calldata[name]
        reset_launch_counts()
        got = abi.call(name, data)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = torch_app.call(name, data)
        if got[0] != 0 or got != want:
            raise AssertionError(f"{name} through the ABI: code {got[0]}, "
                                 f"bytes equal {got[1] == want[1]}")
        cls = app_op_class(name)
        if counts != expected_counts(APP_CALLS[cls]):
            raise AssertionError(f"{name} through the ABI: launch counts "
                                 f"{counts}, expected "
                                 f"{expected_counts(APP_CALLS[cls])}")
        for k, v in counts.items():
            totals[k] += v
    if any(totals[k] == 0 for k in CALLS_PER_MUL_RELIN):
        raise AssertionError(f"a kernel of the ABI path never ran: {totals}")
    for k in KERNEL_NAMES:
        rows[k]["launches_abi"] = totals[k]

    cpu, cpu_abi = cpu_library_checks(torch_app, native_app, user_keys,
                                      calldata)
    ms = {"abi": {}, "app": {}, "cpu_abi": {}}
    for cls, name in APP_TIMED.items():
        data = calldata[name]
        times = {label: [] for label in ms}
        for _ in range(15):             # in turns
            for label, fn in (("abi", abi.call), ("app", torch_app.call),
                              ("cpu_abi", cpu_abi.call)):
                t0 = time.perf_counter()
                code, _ = fn(name, data)
                torch.cuda.synchronize()
                times[label].append((time.perf_counter() - t0) * 1e3)
                if code:
                    raise AssertionError(f"timed {name}: code {code}")
        for label, t in times.items():
            ms[label][cls] = statistics.median(t)
    return {"phase": "c_abi", "ok": True, "card": card,
            "library": os.path.relpath(lib), "build_s": build_s,
            "host_test": host_lines, "host_test_s": host_s,
            "ops_equal_to_torch_app": len(PRECOMPILE_NAMES),
            "launches": totals, "cpu_library": cpu, "ms_median": ms,
            "host_cpu": host_cpu()}


# ---------------------------------------------------------------------------
# phase multi_device: the port's mesh on torch.distributed
# ---------------------------------------------------------------------------

MD_STREAM_REQUESTS = 256
MD_SERVE_REQUESTS = 64
MD_PIPE_M = 8
MD_WORLD = 4
MD_WORLD_LIMIT_S = 120
MD_RUNS = 3                 # timed runs of each gate after it (median)
MD_WORKERS = 2              # ByteServer threads a rank: 4 ranks, 8 cores
MD_LABEL = "one card shared by 4 ranks, gloo through host memory"
MD_DEVICE = "cuda:0"        # every rank's device: the one card
MD_NTT_MESHES = {2: {"dp": 2, "sp": 2}, 4: {"sp": 4}}
MD_STREAM_MESHES = {"dp2_tp2_shard_limbs": (2, 2, True),
                    "dp4": (4, 1, False)}
MD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fhe_precompiles_tpu_torch", "_build", "multi_device")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sha256(x) -> str:
    """Hex digest of a tensor's, an array's or a byte string's contents."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous().numpy()
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x).tobytes()
    return hashlib.sha256(x).hexdigest()


def response_digests(outs) -> list:
    return [f"{code}:{sha256(payload)}" for code, payload in outs]


def timed(fn):
    """(fn(), host seconds), the card waited for on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def counted(fn):
    """(fn(), seconds, launches): the counters set to 0 just before."""
    torch.cuda.synchronize()
    reset_launch_counts()
    out, seconds = timed(fn)
    return out, seconds, launch_counts()


def chunk_calls(calls: dict, rows: int, cb: int = SERVE_MAX_BATCH) -> dict:
    """Every kernel's launches of `calls` once a chunk of at most `cb` of
    `rows` rows."""
    return expected_counts({k: v * -(-rows // cb) for k, v in calls.items()})


def python_serve_counts(server: ByteServer, reqs, each) -> dict:
    """The launches ``server.run(reqs)`` makes with the python codec, on
    one device or on each rank of a mesh: one ``_mul_relin`` a chunk of
    ``max_batch`` multiplies of one key (the cipher∘cipher requests of
    size 2 that decode), and their own call's launches (`each`) for the
    requests that take the per-request path (ops the codec does not batch,
    ciphertexts of another size); one that fails to decode launches
    nothing."""
    k, n = len(TESTNET_ONE.ct_moduli), TESTNET_ONE.n
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    muls: dict = {}
    for (name, data), calls in zip(reqs, each):
        if name not in PRECOMPILE_NAMES:
            continue
        if BINARY_SPECS.get(name, ("", ""))[1] != "cc":
            for key, v in calls.items():
                counts[key] += v
            continue
        try:
            op, key, _pk, a, b = server._decode_cc(name, data)
        except Exception:
            continue
        if a.data.shape != (2, k, n) or b.data.shape != a.data.shape:
            for key, v in calls.items():
                counts[key] += v
            continue
        muls[key] = muls.get(key, 0) + (op == "mul")
    for m in muls.values():
        for key, v in chunk_calls(CALLS_PER_MUL_RELIN, m,
                                  server.max_batch).items():
            counts[key] += v
    return counts


def multi_device_rank(rank: int, address: str, root: str) -> int:
    """One rank of phase multi_device's gloo world on the card (this script
    run with ``--multi-device-rank``): the distributed NTT, RequestStream
    on two meshes, pipeline_chain and ByteServer with both codecs, each
    gate run with the launch counters set to 0 just before, then timed;
    writes ``rank<r>.json`` under `root` (digests, launches, the launches
    its batches imply, seconds).  It loads the kernel library the main
    process built and builds nothing."""
    with open(os.path.join(root, "inputs.json")) as f:
        meta = json.load(f)
    if not os.path.isfile(meta["kernel_library"]):
        raise RuntimeError("the kernel library is not built")
    build.load_library()
    if build.build_seconds is not None or \
            build._lib._name != meta["kernel_library"]:
        raise RuntimeError("a rank built the kernel library")
    device = MD_DEVICE
    multihost.initialize(address, MD_WORLD, rank, device=device,
                         backend="gloo")
    # every rank builds every mesh, in this order
    ntt_meshes = {d: Mesh(shape, device=device)
                  for d, shape in MD_NTT_MESHES.items()}
    stream_meshes = {name: make_mesh(dp, tp, device=device)
                     for name, (dp, tp, _) in MD_STREAM_MESHES.items()}
    pp = Mesh({"pp": MD_WORLD}, device=device)
    app = FheApp(TESTNET_ONE, engine="torch", device=device)
    eng = app._engine
    data = np.load(os.path.join(root, "inputs.npz"))
    out: dict = {"rank": rank, "ntt": {}, "stream": {}, "serve": {}}

    rows = data["ntt_rows"]
    tb = eng.ntts["all"].tables
    for d, mesh in ntt_meshes.items():
        fwd, inv = make_distributed_ntt(tb, mesh)
        x = shard_coeff_axis(rows, mesh)
        y, _s, fwd_counts = counted(lambda: fwd(x))
        z, _s, inv_counts = counted(lambda: inv(y))
        out["ntt"][d] = {
            "sp_index": mesh.axis_index("sp"), "fwd_sha256": sha256(y),
            "round_trip_equal": bool(torch.equal(z, x)),
            "fwd_s": [timed(lambda: fwd(x))[1] for _ in range(MD_RUNS)],
            "inv_s": [timed(lambda: inv(y))[1] for _ in range(MD_RUNS)],
            "launches": {k: fwd_counts[k] + inv_counts[k]
                         for k in KERNEL_NAMES}}

    pk = types.SimpleNamespace(
        relin=types.SimpleNamespace(data=data["rk"]))
    reqs = RequestStream(eng).make_mixed_requests(
        [types.SimpleNamespace(data=c) for c in data["cts"]],
        MD_STREAM_REQUESTS, seed=meta["stream_seed"])
    muls = sum(r.op == "mul" for r in reqs)
    for name, (_dp, _tp, limbs) in MD_STREAM_MESHES.items():
        stream = RequestStream(eng, mesh=stream_meshes[name],
                               shard_limbs=limbs)
        res, gate_s, counts = counted(lambda: stream.run(reqs, pk))
        runs = [timed(lambda: stream.run(reqs, pk)) for _ in range(MD_RUNS)]
        out["stream"][name] = {
            "sha256": [sha256(r) for r in res],
            "repeats_equal": all(all(np.array_equal(a, b)
                                     for a, b in zip(again, res))
                                 for again, _s in runs),
            "launches": counts,
            "expected_launches": chunk_calls(CALLS_PER_MUL_RELIN, muls),
            "gate_s": gate_s, "run_s": [s for _r, s in runs]}

    rk = convert.relin_keys_from_numpy(data["rk"], device)
    mbs = convert.from_numpy(data["pipe_mbs"], device)

    def chain():
        return pipeline_chain(lambda x, key: eng._mul_relin(x, x, key), pp,
                              mbs, rk)
    res, gate_s, counts = counted(chain)
    runs = [timed(chain)[1] for _ in range(MD_RUNS)]
    out["pipeline"] = {
        "sha256": [sha256(r) for r in res], "launches": counts,
        "expected_launches": expected_counts(
            {k: v * MD_PIPE_M for k, v in CALLS_PER_MUL_RELIN.items()}),
        "gate_s": gate_s, "run_s": runs}

    blob, offsets = data["serve_blob"].tobytes(), data["serve_offsets"]
    serve_reqs = [(name, blob[offsets[i]:offsets[i + 1]])
                  for i, name in enumerate(meta["serve_names"])]
    each = meta["serve_each"]
    codes = [(code, None) for code in meta["serve_codes"]]
    for codec in ("python", "native"):
        with ByteServer(TESTNET_ONE, mesh=stream_meshes["dp4"], app=app,
                        codec=codec, workers=MD_WORKERS) as server:
            expected = (python_serve_counts(server, serve_reqs, each)
                        if codec == "python" else
                        native_serve_counts(server, serve_reqs, codes,
                                            each)[0])
            got, gate_s, counts = counted(lambda: server.run(serve_reqs))
            runs = [timed(lambda: server.run(serve_reqs))
                    for _ in range(MD_RUNS)]
            out["serve"][codec] = {
                "digests": response_digests(got),
                "repeats_equal": all(again == got for again, _s in runs),
                "launches": counts, "expected_launches": expected,
                "fallbacks": dict(server.fallbacks),
                "pooled": dict(server.pooled),
                "gate_s": gate_s, "run_s": [s for _r, s in runs]}
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def start_ranks(flag: str, world: int, root: str) -> tuple:
    """Starts `world` processes of this script with `flag`, a rank, a
    rendezvous address and `root`, each logging to ``<root>/<flag
    name>_rank<r>.log``; returns (processes, logs)."""
    address = f"127.0.0.1:{free_port()}"
    stem = flag.strip("-").replace("-", "_")
    logs = [open(os.path.join(root, f"{stem}_rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r), address,
         root], stdout=log, stderr=subprocess.STDOUT,
        cwd=os.path.dirname(os.path.abspath(__file__)))
        for r, log in enumerate(logs)]
    return procs, logs


def finish_ranks(procs, logs, limit_s: float, t0: float) -> list:
    """Waits for `procs` until `limit_s` seconds after `t0`, kills every
    one still running, and returns their exit codes (negative: killed)."""
    try:
        for p in procs:
            p.wait(timeout=max(t0 + limit_s - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
    return [p.returncode for p in procs]


def run_world(root: str) -> list:
    """Starts the MD_WORLD ranks of ``multi_device_rank`` (this script in
    processes of its own, all on the card); waits for them at most
    MD_WORLD_LIMIT_S seconds, killing every one still running on the way
    out.  Returns the ranks' records; raises if a rank fails or the limit
    passes."""
    t0 = time.monotonic()
    procs, logs = start_ranks("--multi-device-rank", MD_WORLD, root)
    rcs = finish_ranks(procs, logs, MD_WORLD_LIMIT_S, t0)
    if any(rc != 0 for rc in rcs):
        tails = []
        for r, rc in enumerate(rcs):
            with open(os.path.join(root,
                                   f"multi_device_rank_rank{r}.log")) as f:
                tails.append(f"--- rank {r} (exit {rc}):\n"
                             + f.read()[-4000:])
        print("\n".join(tails), file=sys.stderr, flush=True)
        raise AssertionError("multi_device: a rank failed or the world ran "
                             f"past {MD_WORLD_LIMIT_S} s")
    records = []
    for r in range(MD_WORLD):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            records.append(json.load(f))
    return records


def phase_multi_device(torch_app: FheApp, golden: FheApp, user_keys,
                       serve_stream, rows: dict, card: str) -> dict:
    """The port's multi-device layer on the one card.

    A. An NCCL world of one in this process (``multihost.initialize`` with
    an address, one process, rank 0): ``RequestStream`` over
    ``global_mesh()`` on 256 mixed requests from phase serve's 16
    ciphertexts, byte-equal to ``RequestStream(eng).run`` with one
    ``_mul_relin`` a chunk of multiplies; ``make_distributed_ntt`` at
    D = 1 on (128, 2, 5, 4096) rows, word-equal to the ``ntt`` kernel and,
    inverse, to the ``intt`` kernel.  The group is destroyed before B.

    B. A gloo world of 4 ranks on cuda:0 (``run_world``), with keys,
    ciphertexts and calldata from this process through files: the
    distributed NTT at D = 2 and 4, each rank's shard word-equal to the
    butterfly kernel's slice and back again; ``RequestStream`` on
    {"dp": 2, "tp": 2} with shard_limbs and on {"dp": 4}, each rank's list
    byte-equal to A's; ``pipeline_chain`` with P = 4 and M = 8 squarings of
    (1, 2, 2, 4096) ciphertexts equal to sequential ``_mul_relin``;
    ``ByteServer(mesh={"dp": 4})`` with both codecs on the first 64 of
    phase serve's requests, equal to call by call; on every rank each
    gate's launches equal to those its batches imply.  Times of B are
    those of one card shared by four ranks: not a scaling figure."""
    t_phase = time.perf_counter()
    eng = torch_app._engine
    pk = user_keys[0]
    cts = [ct for _t, ct in serve_ciphertexts(golden, pk)]
    stream_seed = SEED + 13
    reqs = RequestStream(eng).make_mixed_requests(cts, MD_STREAM_REQUESTS,
                                                  seed=stream_seed)
    muls = sum(r.op == "mul" for r in reqs)
    plain = RequestStream(eng).run(reqs, pk)
    x = ntt_rows(np.random.default_rng(SEED + 14), (BATCH, 2),
                 eng.golden.q_mods + eng.golden.Bsk, eng.n)
    tb = eng.ntts["all"].tables
    want_fwd = nttm.ntt(x, tb)
    want_inv = nttm.intt(want_fwd, tb)
    torch.cuda.synchronize()

    # ---- A: NCCL world of one --------------------------------------------
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        backend = dist.get_backend()
        mesh = multihost.global_mesh()
        meshed, a_stream_s, a_counts = counted(
            lambda: RequestStream(eng, mesh=mesh).run(reqs, pk))
        sp = Mesh({"sp": 1}, device=eng.device)
        fwd, inv = make_distributed_ntt(tb, sp)
        y, a_fwd_s, fwd_counts = counted(lambda: fwd(x))
        z, a_inv_s, inv_counts = counted(lambda: inv(want_fwd))
    finally:
        dist.destroy_process_group()
    if backend != "nccl":
        raise AssertionError(f"multi_device A: backend {backend}")
    if any(not np.array_equal(a, b) for a, b in zip(meshed, plain)):
        raise AssertionError("multi_device A: the meshed stream differs")
    if a_counts != chunk_calls(CALLS_PER_MUL_RELIN, muls):
        raise AssertionError(f"multi_device A: launches {a_counts}")
    if not (torch.equal(y, want_fwd) and torch.equal(z, want_inv)
            and torch.equal(z, x)):
        raise AssertionError("multi_device A: the D = 1 NTT differs")
    if any(fwd_counts.values()) or any(inv_counts.values()):
        raise AssertionError("multi_device A: the distributed NTT launched "
                             "a kernel")

    # ---- B: gloo world of four ranks on the card ----------------------------
    rk = pk.relin.data
    seq = []
    rk_dev = convert.relin_keys_from_numpy(rk, eng.device)
    for ct in cts[:MD_PIPE_M]:
        v = dev(ct.data[None])
        for _ in range(MD_WORLD):
            v = eng._mul_relin(v, v, rk_dev)
        seq.append(sha256(v))
    serve_reqs, serve_want, serve_each = (part[:MD_SERVE_REQUESTS]
                                          for part in serve_stream)
    blob = b"".join(data for _n, data in serve_reqs)
    offsets = np.cumsum([0] + [len(data) for _n, data in serve_reqs])
    shutil.rmtree(MD_DIR, ignore_errors=True)
    os.makedirs(MD_DIR)
    try:
        np.savez(os.path.join(MD_DIR, "inputs.npz"),
                 ntt_rows=convert.to_numpy(x),
                 cts=np.stack([ct.data for ct in cts]), rk=rk,
                 pipe_mbs=np.stack([ct.data[None]
                                    for ct in cts[:MD_PIPE_M]]),
                 serve_blob=np.frombuffer(blob, dtype=np.uint8),
                 serve_offsets=offsets)
        with open(os.path.join(MD_DIR, "inputs.json"), "w") as f:
            json.dump({"kernel_library": build._lib._name,
                       "stream_seed": stream_seed,
                       "serve_names": [name for name, _d in serve_reqs],
                       "serve_codes": [code for code, _p in serve_want],
                       "serve_each": serve_each}, f)
        t0 = time.perf_counter()
        ranks = run_world(MD_DIR)
        world_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(MD_DIR, ignore_errors=True)

    want_stream = [sha256(r) for r in plain]
    want_serve = response_digests(serve_want)
    bad = []
    for rec in ranks:
        r = rec["rank"]
        for d, g in rec["ntt"].items():
            S = eng.n // int(d)
            s = g["sp_index"]
            if g["fwd_sha256"] != sha256(want_fwd[..., s * S:(s + 1) * S]) \
                    or not g["round_trip_equal"] or any(
                        g["launches"].values()):
                bad.append(f"rank {r} ntt D={d}")
        for name, g in rec["stream"].items():
            if g["sha256"] != want_stream or not g["repeats_equal"] or \
                    g["launches"] != g["expected_launches"] or \
                    g["launches"] != chunk_calls(CALLS_PER_MUL_RELIN, muls):
                bad.append(f"rank {r} stream {name}")
        g = rec["pipeline"]
        if g["sha256"] != seq or g["launches"] != g["expected_launches"]:
            bad.append(f"rank {r} pipeline")
        for codec, g in rec["serve"].items():
            if g["digests"] != want_serve or not g["repeats_equal"] or \
                    g["launches"] != g["expected_launches"] or \
                    g["fallbacks"].get("device") or \
                    g["fallbacks"].get("encode"):
                bad.append(f"rank {r} serve {codec}")
    if bad:
        raise AssertionError(f"multi_device B: {bad}")
    if any(ranks[0]["stream"]["dp4"]["launches"][k] == 0
           for k in CALLS_PER_MUL_RELIN):
        raise AssertionError("multi_device B: a kernel of the path never ran")
    for k in KERNEL_NAMES:
        rows[k]["launches_mesh"] = ranks[0]["stream"]["dp4"]["launches"][k]

    def median_ms(g):
        return statistics.median(g["run_s"]) * 1e3
    return {
        "phase": "multi_device", "ok": True, "card": card,
        "preset": "testnet.one", "seconds": time.perf_counter() - t_phase,
        "nccl_world_of_one": {
            "backend": backend, "mesh": mesh.shape,
            "stream_requests": len(reqs), "mul": muls,
            "stream_equal": True, "stream_s": a_stream_s,
            "launches": a_counts, "ntt_rows": list(x.shape),
            "ntt_d1_equal": True, "ntt_d1_fwd_ms": a_fwd_s * 1e3,
            "ntt_d1_inv_ms": a_inv_s * 1e3},
        "gloo_world": {
            "label": MD_LABEL, "ranks": MD_WORLD, "world_s": world_s,
            "every_gate_equal": True, "launches_as_derived": True,
            "ntt_ms_median_rank0": {
                d: {"fwd": statistics.median(g["fwd_s"]) * 1e3,
                    "inv": statistics.median(g["inv_s"]) * 1e3}
                for d, g in ranks[0]["ntt"].items()},
            "stream_ms_median_rank0": {
                name: median_ms(g)
                for name, g in ranks[0]["stream"].items()},
            "stream_launches_rank0": {
                name: g["launches"] for name, g in ranks[0]["stream"].items()},
            "pipeline": {"stages": MD_WORLD, "microbatches": MD_PIPE_M,
                         "ms_median_rank0": median_ms(ranks[0]["pipeline"]),
                         "launches_rank0": ranks[0]["pipeline"]["launches"]},
            "serve": {
                codec: {"requests": len(serve_reqs), "workers": MD_WORKERS,
                        "smoke_run_s_median_rank0": median_ms(g) / 1e3,
                        "run_s_by_rank": [rec["serve"][codec]["run_s"]
                                          for rec in ranks],
                        "launches_rank0": g["launches"],
                        "fallbacks_rank0": g["fallbacks"],
                        "pooled_rank0": g["pooled"]}
                for codec, g in ranks[0]["serve"].items()}}}


# ---------------------------------------------------------------------------
# phase hardening: the port's native code under checkers
# ---------------------------------------------------------------------------

HARDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "fhe_precompiles_tpu_torch", "_build", "hardening")
HARDEN_FUZZ_S = 15          # the fuzzer's budget in the phase
HARDEN_KERNELS_LIMIT_S = 300
GUARD_WORDS = 4096          # poisoned words before and after every buffer
POISONS = (0x5A5A5A5A5A5A5A5A, -1)


class Guarded:
    """`numel` int64 words on the card between GUARD_WORDS words of
    `poison` on each side, the words themselves poisoned too."""

    def __init__(self, numel: int, poison: int, device):
        self.numel, self.poison = numel, poison
        self.buf = torch.full((2 * GUARD_WORDS + numel,), poison,
                              dtype=torch.int64, device=device)

    def body(self) -> torch.Tensor:
        return self.buf[GUARD_WORDS:GUARD_WORDS + self.numel]

    def guards_intact(self) -> bool:
        rest = torch.cat([self.buf[:GUARD_WORDS],
                          self.buf[GUARD_WORDS + self.numel:]])
        return bool((rest == self.poison).all())


def guarded_launch(kern, plain, bases, views, poison: int) -> list:
    """Runs the wrapper `kern` once on copies of the tensors `bases` (each
    seen through its view of `views`) that sit between poisoned guard
    words, into an output between guards filled with `poison` (passed as
    its ``out=``), and holds the result to `plain` on the clean inputs.
    Returns what went wrong: a word that differs (the poison of an unwritten
    word, or a read beyond an input reaching the result), a guard or an
    input written."""
    want = plain(*[v(b) for b, v in zip(bases, views)])
    ins = []
    for b in bases:
        g = Guarded(b.numel(), poison, b.device)
        g.body().copy_(b.reshape(-1))
        ins.append(g)
    out = Guarded(want.numel(), poison, want.device)
    kern(*[v(g.body().view(b.shape)) for g, b, v in zip(ins, bases, views)],
         out=out.body().view(want.shape))
    torch.cuda.synchronize()
    problems = []
    got = out.body().view(want.shape)
    if not torch.equal(got, want):
        problems.append(f"{count_diff(got, want)} words differ from the "
                        "plain version")
    for what, gs in (("input", ins), ("output", [out])):
        if not all(g.guards_intact() for g in gs):
            problems.append(f"a guard of an {what} was written")
    if not all(torch.equal(g.body(), b.reshape(-1))
               for g, b in zip(ins, bases)):
        problems.append("an input was written")
    return problems


def transform_rows(rng, lead, mods, n) -> torch.Tensor:
    """``ntt_rows`` where the batch holds its four edge blocks, else
    uniform residues."""
    if int(np.prod(lead)) >= 4:
        return ntt_rows(rng, lead, mods, n)
    return dev(rand_rows(rng, lead, mods, n))


def ragged_batch(rows_a_block: int, limbs: int) -> int:
    """The least batch B > 1 whose B * limbs rows leave a partial block; 3
    where a block takes one row (no count leaves a partial one)."""
    if rows_a_block == 1:
        return 3
    return next(b for b in range(2, 64) if (b * limbs) % rows_a_block)


def hardening_kernel_cases(rng) -> list:
    """The ten kernels at their smallest shape, a ragged row count that
    leaves a partial last block, and their largest n: (kernel, label,
    wrapper, plain version, base tensors, views), the wrapper and the plain
    version taking the views."""
    def same(t):
        return t

    def bound(fn, *tables):
        return lambda *xs, **kw: fn(*xs, *tables, **kw)

    cases = []
    contexts = {"testnet.one": BfvContext(TESTNET_ONE),
                "bench.n1024": BfvContext(BENCH_N1024),
                "bench.n8192": BfvContext(BENCH_N8192)}
    consts = {name: tail.TailConstants(g, "cuda")
              for name, g in contexts.items()}
    g1, c1 = contexts["testnet.one"], consts["testnet.one"]
    n, k = g1.n, g1.k
    allm = g1.q_mods + g1.Bsk
    for B in (1, 3):
        a = tail_cases.place_r_cases(rand_rows(rng, (B * 2,), g1.q_mods, n),
                                     g1).reshape(B, 2, k, n)
        label = f"testnet.one, B = {B}"
        cases += [
            ("to_bsk_ext", label, bound(tail.to_bsk_ext, c1),
             bound(tail.to_bsk_ext_plain, c1), [dev(a)], [same]),
            ("dyadic", label, bound(tail.dyadic, c1),
             bound(tail.dyadic_plain, c1),
             [dev(rand_rows(rng, (B, 2), allm, n)),
              dev(rand_rows(rng, (B, 2), allm, n))], [same, same]),
            ("relin_dot", label, bound(tail.relin_dot, c1),
             bound(tail.relin_dot_plain, c1),
             [dev(rand_rows(rng, (B, k), g1.key_mods, n)),
              dev(rand_rows(rng, (k, 2), g1.key_mods, n))], [same, same]),
            ("mod_down", label + ", strided ct3[:, :2]",
             bound(tail.mod_down, c1), bound(tail.mod_down_plain, c1),
             [dev(rand_rows(rng, (B, 2), g1.key_mods, n)),
              dev(rand_rows(rng, (B, 3), g1.q_mods, n))],
             [same, lambda t: t[:, :2]])]
    for name, B in (("testnet.one", 1), ("testnet.one", 3),
                    ("bench.n1024", 3), ("bench.n8192", 1)):
        g, c = contexts[name], consts[name]
        tq = tail_cases.place_alpha_cases(
            rand_rows(rng, (B * 3,), g.q_mods + g.Bsk, g.n), g)
        cases.append(("floor_sk", f"{name}, B = {B} (k = {g.k}, |Bsk| = "
                      f"{len(g.Bsk)})", bound(tail.floor_sk, c),
                      bound(tail.floor_sk_plain, c),
                      [dev(tq.reshape(B, 3, c.nb, g.n))], [same]))
    butterfly = (("ntt", nttm.ntt, nttm.ntt_plain),
                 ("intt", nttm.intt, nttm.intt_plain))
    for name in ("testnet.one", "bench.n8192"):
        g = contexts[name]
        mods = g.q_mods + g.Bsk
        L = len(mods)
        tb = nttm.build_tables(mods, g.n, "cuda")
        for B in ((1, 7) if name == "testnet.one" else (2,)):
            x = transform_rows(rng, (B,), mods, g.n)
            for kern_name, kern, plain in butterfly:
                cases.append((kern_name, f"{name} q+bsk, B = {B}",
                              bound(kern, tb), bound(plain, tb), [x], [same]))
        if name == "testnet.one":
            qtb = nttm.build_tables(g.q_mods, g.n, "cuda")
            ct = ntt_rows(rng, (3, 2), g.q_mods, g.n)
            for kern_name, kern, plain in butterfly:
                cases.append((kern_name, "testnet.one q, strided ct[:, 1]",
                              bound(kern, qtb), bound(plain, qtb), [ct],
                              [lambda t: t[:, 1]]))
        ftb = fsm.build_mxu_tables(mods, g.n, "cuda")
        rpb = fsm.kernel_fit(ftb.R, ftb.C)[0]
        for B in (1, ragged_batch(rpb, L)):
            x = transform_rows(rng, (B,), mods, g.n)
            for kern_name, kern, plain in (
                    ("four_step_ntt", fsm.ntt, fsm.ntt_plain),
                    ("four_step_intt", fsm.intt, fsm.intt_plain)):
                cases.append((kern_name, f"{name}, R = {ftb.R}, B = {B} "
                              f"({B * L} rows, {rpb} a block)",
                              bound(kern, ftb), bound(plain, ftb), [x],
                              [same]))
        # kernel 9 on R x R matrices with the R-side weights: 64 x 64 on
        # testnet.one, 128 x 128 on bench.n8192 (a random grid)
        K = ftb.R
        rpb = fsm.phase_fit(K, K)[0]
        grid = dev(rand_rows(rng, (), mods, K * K)).view(L, K, K)
        for B in (1, ragged_batch(rpb, L)):
            m = dev(rand_rows(rng, (B,), mods, K * K)).view(B, L, K, K)
            for mode in fsm.PHASE_MODES:
                args = (ftb.A_wg, None if mode == "none" else grid, mode, ftb)
                cases.append((
                    "four_step_phase", f"{name}, {mode}, K = J = {K}, B = "
                    f"{B} ({B * L} rows, {rpb} a block)",
                    bound(fsm.phase, *args), bound(fsm.phase_plain, *args),
                    [m], [same]))
    return cases


def sanitize_kernels() -> int:
    """The child of ``--sanitize-kernels``: every case of
    ``hardening_kernel_cases`` through ``guarded_launch`` with each of
    POISONS (tolerance 0), in this process alone so that a checker may run
    it.  Prints one JSON line; exits 1 if any case went wrong."""
    t0 = time.perf_counter()
    build.load_library()
    cases = hardening_kernel_cases(np.random.default_rng(SEED + 40))
    reset_launch_counts()
    out = {name: {"cases": [], "launches": 0, "problems": 0}
           for name in KERNEL_NAMES}
    for name, label, kern, plain, bases, views in cases:
        problems = []
        for poison in POISONS:
            problems += [f"poison {poison & (2 ** 64 - 1):#x}: {p}"
                         for p in guarded_launch(kern, plain, bases, views,
                                                 poison)]
        out[name]["cases"].append({"case": label, "problems": problems})
        out[name]["problems"] += len(problems)
    for name, n in launch_counts().items():
        out[name]["launches"] = n
    emit({"kernels": out, "guard_words": GUARD_WORDS,
          "poisons": [p & (2 ** 64 - 1) for p in POISONS],
          "seconds": time.perf_counter() - t0})
    return 1 if any(r["problems"] or not r["launches"]
                    for r in out.values()) else 0


def kernel_checks() -> dict:
    """Runs ``--sanitize-kernels`` as a process of its own (the process a
    checker such as compute-sanitizer wraps, where it supports the card).
    Returns its record with the process's seconds; raises if it fails."""
    cmd = [sys.executable, os.path.abspath(__file__), "--sanitize-kernels"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=HARDEN_KERNELS_LIMIT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"kernel checks: exit {proc.returncode}\n"
                             f"{proc.stdout[-6000:]}\n{proc.stderr[-6000:]}")
    rec = json.loads(lines[-1])
    rec["seconds_process"] = seconds
    return rec


def build_sanitizers_timed() -> float:
    """Builds the fuzzer and the two sanitizer drivers (their objects side
    by side); returns the seconds it took."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda a: build.build_sanitized(*a), (
            ("asan", "fuzz_native.cpp", ()),
            ("asan", "sanitize_driver.c", ("sanitize_cases.h",)),
            ("tsan", "tsan_driver.c", ("sanitize_cases.h",)))))
    return time.perf_counter() - t0


def phase_hardening(torch_app: FheApp, card: str, sanitizer_build) -> dict:
    """The port's native code under checkers.

    Kernels: ``--sanitize-kernels`` in a process of its own, each of the
    ten kernels at its smallest shape, a ragged row count and its largest
    n, every buffer between poisoned guards, the output poisoned, two
    poisons: equal to the plain version word for word, no guard or input
    written.  Then the coverage fuzzer (ASan + UBSan)
    for HARDEN_FUZZ_S seconds from the synthesized corpus and the JAX
    package's 132 seeds; the ASan drive on testnet.one, bench.n8192 and
    bench.n1024 and the TSan drive on testnet.one, the expected bytes from
    the torch app on the card; the install into a temporary prefix and
    ``host_test.c`` linked through ``pkg-config``, shared and static,
    passing with ``--keys`` from ``keydir``."""
    t_phase = time.perf_counter()
    build_s = sanitizer_build.result()
    kernels = kernel_checks()

    shutil.rmtree(HARDEN_DIR, ignore_errors=True)
    os.makedirs(HARDEN_DIR)
    try:
        fz = fuzz_mod.run(HARDEN_FUZZ_S, seed=SEED,
                          corpus_dir=os.path.join(HARDEN_DIR, "fuzz"))
        if fz["replayed"].get(str(fuzz_mod.REFERENCE_SEEDS)) != 132:
            raise AssertionError(f"fuzzer: replayed {fz['replayed']}, not "
                                 "the reference's 132 seeds")
        apps = {"testnet.one": torch_app}
        for name in ("bench.n8192", "bench.n1024"):
            apps[name] = sanitize_mod.preset_app(name, engine="torch")
        drives = sanitize_mod.run_all(apps, os.path.join(HARDEN_DIR,
                                                         "drives"))
        prefix = os.path.join(HARDEN_DIR, "prefix")
        t0 = time.perf_counter()
        files = install_mod.install(prefix)
        hosts = {}
        for link in ("shared", "static"):
            exe = install_mod.build_host(
                prefix, os.path.join(HARDEN_DIR, f"host_test_{link}"),
                link == "static")
            lines, host_s = run_host([str(exe),
                                      *install_mod.host_keys(prefix)],
                                     f"installed host_test ({link})")
            hosts[link] = {"lines": lines, "seconds": host_s}
        install_s = time.perf_counter() - t0
        libs = install_mod.pkg_config(prefix, "--libs")
    finally:
        shutil.rmtree(HARDEN_DIR, ignore_errors=True)
    return {
        "phase": "hardening", "ok": True, "card": card,
        "seconds": time.perf_counter() - t_phase,
        "sanitizer_build_s": build_s,
        "kernels": {
            "seconds": kernels["seconds_process"],
            "kernels_checked": sum(1 for r in kernels["kernels"].values()
                                   if r["launches"]),
            "cases": sum(len(r["cases"]) for r in kernels["kernels"].values()),
            "errors": sum(r["problems"] for r in kernels["kernels"].values()),
            "launches": {k: r["launches"]
                         for k, r in kernels["kernels"].items()},
            "cases_by_kernel": {k: [c["case"] for c in r["cases"]]
                                for k, r in kernels["kernels"].items()}},
        "fuzz": {**fz, "iterations_per_s": fz["iterations"]
                 / fz["seconds_budget"]},
        "asan_drive": drives["asan"],
        "tsan_drive": drives["tsan"],
        "install": {"files": sorted(files), "libs": libs, "hosts": hosts,
                    "seconds": install_s}}


# ---------------------------------------------------------------------------
# phase examples: the port's three demos on the card
# ---------------------------------------------------------------------------

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "examples")
EXAMPLES = ("torch_demo", "torch_consensus_demo", "torch_byte_server_demo")
EXAMPLES_REQUESTS = 100     # the consensus demo's stream
EXAMPLES_CLI_ARGS: list = []    # the command-line run's arguments
EXAMPLES_CLI_LIMIT_S = 300


def load_example(name: str):
    """The demo ``examples/<name>.py`` as a module; its ``main`` not run."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES_DIR, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(mod, argv: list):
    """``mod.main(argv)``, the lines it prints kept out of this script's
    standard output (it returns them)."""
    with contextlib.redirect_stdout(io.StringIO()):
        return mod.main(argv)


def call_counts(requests, results) -> dict:
    """The launches of the precompile calls `requests`, made one at a time
    on the torch app with `results`: those of each call's op class
    (``APP_CALLS``) where it returned code 0.  The demos' only failing call
    stops while its calldata is parsed and launches nothing."""
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    for (name, _), (code, _) in zip(requests, results):
        for k, v in (APP_CALLS[app_op_class(name)] if code == 0
                     else {}).items():
            counts[k] += v
    return counts


def check_launches(label: str, counts: dict, want: dict) -> dict:
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts}, expected "
                             f"{want}")
    return {k: v for k, v in counts.items() if v}


def phase_examples(rows: dict, card: str) -> dict:
    """The port's demos, ``examples/torch_*.py``, imported by path and their
    ``main`` called on the card, the launch counters set to 0 just before
    each and read just after, held to what its calls imply: ``torch_demo``
    (16 * 4 = 64, error code 1, and its lines, bytes and noise budget equal
    to the same ``main`` on the golden model), ``torch_consensus_demo`` on
    EXAMPLES_REQUESTS requests (the card validator against the CPU golden
    validator, 0 divergences) and ``torch_byte_server_demo``
    (``ByteServer(codec="native")``, every response equal to
    ``FheApp.call``; its launches those of the server's windows and of the
    calls one at a time).  Then ``python examples/torch_demo.py`` once as
    a process of its own, on the card, printing the same lines."""
    t_phase = time.perf_counter()
    demos = {name: load_example(name) for name in EXAMPLES}
    seconds, launches = {}, {}

    got, seconds["torch_demo"], counts = counted(
        lambda: run_example(demos["torch_demo"], []))
    golden, seconds["torch_demo_golden"] = timed(
        lambda: run_example(demos["torch_demo"], ["--engine", "golden"]))
    if got["value"] != 64 or got["error_code"] != 1:
        raise AssertionError(f"torch_demo: 16 * 4 = {got['value']}, error "
                             f"code {got['error_code']}")
    keys = ("lines", "results", "ciphertext_bytes", "mul_in_bytes",
            "product_bytes", "noise_budget_bits")
    differ = [k for k in keys if got[k] != golden[k]]
    if differ:
        raise AssertionError(f"torch_demo on the card differs from the "
                             f"golden model in {differ}")
    launches["torch_demo"] = check_launches(
        "torch_demo", counts, call_counts(got["requests"], got["results"]))
    demo_lines = got["lines"]

    got, seconds["torch_consensus_demo"], counts = counted(
        lambda: run_example(demos["torch_consensus_demo"],
                            ["--requests", str(EXAMPLES_REQUESTS)]))
    if got["divergences"] or len(got["results"]) != EXAMPLES_REQUESTS:
        raise AssertionError(f"torch_consensus_demo: {got['divergences']} "
                             f"divergences in {len(got['results'])}")
    launches["torch_consensus_demo"] = check_launches(
        "torch_consensus_demo", counts,
        call_counts(got["requests"], got["results"]))
    consensus = {"requests": len(got["requests"]),
                 "mul_requests": sum(name.startswith("mul_")
                                     for name, _ in got["requests"]),
                 "divergences": got["divergences"], "digest": got["digest"]}

    got, seconds["torch_byte_server_demo"], counts = counted(
        lambda: run_example(demos["torch_byte_server_demo"], []))
    reqs, want = got["requests"], got["want"]
    if got["results"] != want or any(code for code, _ in want):
        raise AssertionError("torch_byte_server_demo: a response differs "
                             "from FheApp.call or failed")
    each = [APP_CALLS[app_op_class(name)] for name, _ in reqs]
    served, _pooled = native_serve_counts(got["server"], reqs, want, each)
    one_by_one = call_counts(reqs, want)
    launches["torch_byte_server_demo"] = check_launches(
        "torch_byte_server_demo", counts,
        {k: served[k] + one_by_one[k] for k in KERNEL_NAMES})
    server_s = got["seconds"]

    totals = {k: sum(c.get(k, 0) for c in launches.values())
              for k in CALLS_PER_MUL_RELIN}
    if not all(totals.values()):
        raise AssertionError(f"a kernel of the demos' path never ran: "
                             f"{totals}")
    for k, v in totals.items():
        rows[k]["launches_examples"] = v

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES_DIR, "torch_demo.py"),
         *EXAMPLES_CLI_ARGS], capture_output=True, text=True,
        timeout=EXAMPLES_CLI_LIMIT_S)
    seconds["torch_demo_cli"] = time.perf_counter() - t0
    if proc.returncode != 0 or proc.stdout.splitlines() != demo_lines:
        raise AssertionError(f"python examples/torch_demo.py: exit "
                             f"{proc.returncode}\n{proc.stdout}"
                             f"{proc.stderr[-4000:]}")
    return {"phase": "examples", "ok": True, "card": card,
            "seconds": time.perf_counter() - t_phase,
            "seconds_by_demo": seconds, "torch_demo_lines": demo_lines,
            "consensus": consensus, "byte_server_run_s": server_s,
            "byte_server_requests": len(reqs), "launches": launches}


def main() -> int:
    if sys.argv[1:2] == ["--multi-device-rank"]:
        return multi_device_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:2] == ["--sanitize-kernels"]:
        return sanitize_kernels()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    try:
        triton_version = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton_version = None       # not needed: every kernel here is CUDA C++
    emit({"phase": "device", "ok": True, "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "triton": triton_version,
          "python": sys.version.split()[0]})

    # the codec library's g++ build runs beside the kernels' nvcc build
    beside_nvcc = ThreadPoolExecutor(max_workers=2)
    codec_build = beside_nvcc.submit(build_codec_timed)
    sanitizer_build = beside_nvcc.submit(build_sanitizers_timed)
    beside_nvcc.shutdown(wait=False)
    t0 = time.perf_counter()
    build.load_library(verbose="--ptxas" in sys.argv)
    emit({"phase": "build", "ok": True,
          "sources": sorted(set(SOURCES.values())),
          "flags": " ".join(build.NVCC_FLAGS),
          "nvcc_seconds": build.build_seconds,
          "seconds": time.perf_counter() - t0})
    # no timed phase shares the host with a compile: where nvcc had nothing
    # to build, the g++ builds would run on into phases kernels and timing
    codec_build.result()
    sanitizer_build.result()

    eng = TorchEngine(TESTNET_ONE)            # default device: the card
    eng4 = TorchEngine(TESTNET_ONE, ntt_backend="four_step")
    rows, checks = phase_kernels(eng, eng4, np.random.default_rng(SEED))
    emit({"phase": "kernels", "ok": True, "card": card, "tolerance": 0,
          "kernels": list(checks.values())})
    bad = [n for n, r in checks.items()
           if r["mismatches"] or r.get("mismatches_n8192")]
    if bad:
        raise AssertionError(f"kernels differ from their plain versions: {bad}")

    keys = make_keys_and_plains(eng.golden)
    main_path = phase_main_path(eng, rows, keys)
    inputs, host_cts = main_path.pop("inputs"), main_path.pop("host_cts")
    emit(main_path)
    emit(phase_round_trip(eng, rows, keys, host_cts))
    timing = phase_timing(eng, inputs, card, rows)
    emit(timing)
    emit(phase_four_step_path(eng4, eng, rows, keys, host_cts, inputs, card))
    torch_app = FheApp(TESTNET_ONE, engine="torch")
    golden = FheApp(TESTNET_ONE, engine="golden")
    app = phase_app(torch_app, golden, rows, card)
    user_keys, calldata = app.pop("shared")
    emit(app)
    serve = phase_serve(torch_app, golden, user_keys, calldata, rows, card,
                        codec_build)
    serve_stream = serve.pop("shared")
    emit(serve)
    native_app = FheApp(TESTNET_ONE, engine="native")
    emit(phase_native_engine(native_app, torch_app, golden, user_keys,
                             calldata, timing, card))
    emit(phase_soak(torch_app, golden, user_keys, calldata, rows, card))
    emit(phase_c_abi(torch_app, native_app, user_keys, calldata, rows, card))
    emit(phase_multi_device(torch_app, golden, user_keys, serve_stream, rows,
                            card))
    emit(phase_hardening(torch_app, card, sanitizer_build))
    emit(phase_examples(rows, card))

    print(card, flush=True)
    emit({"kernels": [rows[name] for name in KERNEL_NAMES]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
