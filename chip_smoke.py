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
form.  Before that it builds the CUDA kernels from
``fhe_precompiles_tpu_torch/csrc/`` and holds each of the ten (five BEHZ
tail segments, forward and inverse butterfly NTT, forward and inverse
four-step NTT, one four-step product) against its plain PyTorch version on
the card (``floor_sk`` also on bench.n1024 and at ragged batches, as it has
one instance per limb-count pair), and the four-step transforms against the
butterfly kernels too (exact integer arithmetic: the tolerance is 0, every
word must be equal).

Phases, one JSON line each: device, build, kernels, main_path, round_trip,
timing, four_step_path.  Any failure ends the run with a non-zero exit code
and without the last line.  Then, in this order: the card's name and power
limit as ``nvidia-smi`` gives them, one ``{"kernels": [...]}`` line (per
kernel: launches counted during its path's run and during its round trip,
error against the plain version, measured times, and the least time the
card could take, with its bytes and operations terms; ``ms`` is taken with
the inputs cold in the cache and is the time ``bound_ms`` is held against,
``same_buffers_ms`` repeats one input set, ``path_ms`` is one call inside
``_mul_relin``, for the NTTs the call of the shape that ``ms`` was taken at,
for the four-step product its launch inside the two-launch transform), and
the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

It imports ``fhe_precompiles_tpu_torch`` only, never JAX.
"""
from __future__ import annotations

import importlib.metadata
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from fhe_precompiles_tpu_torch import convert
from fhe_precompiles_tpu_torch.bfv import BfvContext, Ciphertext
from fhe_precompiles_tpu_torch.ops import build, tail, tail_cases
from fhe_precompiles_tpu_torch.ops import four_step as fsm
from fhe_precompiles_tpu_torch.ops import ntt as nttm
from fhe_precompiles_tpu_torch.ops.engine import TorchEngine
from fhe_precompiles_tpu_torch.ops.modmath import csub_reduce
from fhe_precompiles_tpu_torch.params import (BENCH_N1024, BENCH_N8192,
                                              TESTNET_ONE)

BATCH = 128          # the main path's batch
DISTINCT = 8         # distinct ciphertexts, tiled up to BATCH
SWEEP = (1, 16, 32, 64, 256, 512)   # other batch sizes timed beside BATCH
SEED = 20240607

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


def four_step_kernel_checks(eng4: TorchEngine, eng: TorchEngine, rng,
                            rows: dict, checks: dict) -> None:
    """Kernel 8 (``four_step_ntt`` / ``four_step_intt``, one launch) and
    kernel 9 (``four_step_phase``, the two-launch transform) at every shape
    of ``four_step_cases``, each against the plain version and against the
    butterfly kernels on the same input, and there and back again; then
    kernel 9 alone in its three modes at the main path's shape.  Fills the
    three kernels' rows and checks."""
    fused = {"ntt": fsm.ntt, "intt": fsm.intt}
    two = {"ntt": fsm.ntt_two_launch, "intt": fsm.intt_two_launch}
    plain = {"ntt": fsm.ntt_plain, "intt": fsm.intt_plain}
    bfly = {"ntt": nttm.ntt, "intt": nttm.intt}
    back = {"ntt": "intt", "intt": "ntt"}
    for name in fsm.KERNEL_NAMES:
        checks[name] = {"name": name, "mismatches": 0, "cases": []}
    max_err = {name: 0 for name in fsm.KERNEL_NAMES}
    main_input = None
    for label, d, tb, btb, there_and_back, x in four_step_cases(eng4, eng,
                                                                rng):
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
            nbytes, imads, int8_ops = four_step_work(k8, x, tb)
            rows[k8], terms = timed_row(k8, fused[d], plain[d], (x,), tb,
                                        nbytes, imads, 0, int8_ops)
            checks[k8].update(terms)
            checks[k8]["cases"][-1]["ms"] = rows[k8]["ms"]
            if main_input is None:
                main_input = (x, tb)
        elif tb.n == 4096:
            checks[k8]["cases"][-1]["ms"] = cold_ms(fused[d], (x,), tb)
        del want

    # kernel 9 alone: the forward's operand, (B, 2, nb, R, C), every mode
    x, tb = main_input
    m = x.view(x.shape[:-1] + (tb.R, tb.C))
    grid = (tb.T, tb.T_shoup)
    for mode in fsm.PHASE_MODES:
        g = None if mode == "none" else grid

        def kern(v, t, mode=mode, g=g):
            return fsm.phase(v, t.A_dig, g, mode, t)

        def ref(v, t, mode=mode, g=g):
            return fsm.phase_plain(v, t.A_dig, g, mode, t)
        _, mism, err = compare(kern, ref, (m,), tb)
        checks["four_step_phase"]["mismatches"] += mism
        checks["four_step_phase"]["cases"].append(
            {"case": f"phase {mode}, prepare q+bsk", "shape": list(m.shape),
             "mismatches": mism})
        max_err["four_step_phase"] = max(max_err["four_step_phase"], err)
        if mode == "pre":            # the row of the kernels line
            nbytes, imads, int8_ops = four_step_work("four_step_phase", m,
                                                     tb)
            rows["four_step_phase"], terms = timed_row(
                "four_step_phase", kern, ref, (m,), tb, nbytes, imads, 0,
                int8_ops)
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
    """(bytes, 32-bit multiply-adds, int8 tensor-core operations) of one
    launch on `x`, as csrc/four_step.cu does the work; a phase launch with
    its grid.  Bytes: each input and output word once, the limbs' digit
    planes, grid and scalars once.  Tensor cores: 25 digit-pair products of
    each multiply-add of each matrix product, two operations each.  Integer
    pipe: for each output of each product a Barrett step and a Shoup product
    (the recombination), and one Shoup product a word for the grid."""
    if name == "four_step_phase":
        K, J = x.shape[-2:]
        n, depth, products, weights = K * J, K, 1, 5 * K * K
    else:
        n, depth, products = tb.n, tb.R + tb.C, 2
        weights = 5 * (tb.R ** 2 + tb.C ** 2)
    rows = x.numel() // n
    nbytes = 16 * x.numel() + tb.p.shape[0] * (weights + 16 * n + 32)
    imads = rows * n * (products * (BARRETT + SHOUP) + SHOUP)
    int8_ops = 2 * 25 * rows * n * depth
    return nbytes, imads, int8_ops


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


def staged_two_launch(x: torch.Tensor, tb: fsm.MxuNttTables):
    """``fsm.ntt_two_launch`` step by step with a CUDA event before each, as
    ``staged_mul_relin`` does: the result and the milliseconds of the two
    launches of kernel 9 and of the two torch transposes."""
    marks = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    hold_device(1.0)
    mark("phase_none")
    y = fsm.phase(x.view(x.shape[:-1] + (tb.R, tb.C)), tb.A_dig, None,
                  "none", tb)
    mark("transpose")
    yt = y.transpose(-1, -2).contiguous()
    mark("phase_pre")
    zt = fsm.phase(yt, tb.B0_dig, (tb.TT, tb.TT_shoup), "pre", tb)
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


def main() -> int:
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

    t0 = time.perf_counter()
    build.load_library(verbose="--ptxas" in sys.argv)
    emit({"phase": "build", "ok": True,
          "sources": sorted(set(SOURCES.values())),
          "flags": " ".join(build.NVCC_FLAGS),
          "nvcc_seconds": build.build_seconds,
          "seconds": time.perf_counter() - t0})

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
    emit(phase_timing(eng, inputs, card, rows))
    emit(phase_four_step_path(eng4, eng, rows, keys, host_cts, inputs, card))

    print(card, flush=True)
    emit({"kernels": [rows[name] for name in KERNEL_NAMES]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
