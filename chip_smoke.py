"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Drives the port's main path -- a batch of 128 ciphertext x ciphertext BFV
multiplies followed by relinearization on ``testnet.one`` (n = 4096) --
through ``TorchEngine`` on the card, and checks it byte for byte against the
port's host golden model.  Before that it builds the CUDA kernels from
``fhe_precompiles_tpu_torch/csrc/`` and holds each of them against its plain
PyTorch version on the card (exact integer arithmetic: the tolerance is 0,
every word must be equal).

Phases, one JSON line each: device, build, kernels, main_path, timing.  Any
failure ends the run with a non-zero exit code and without the last line.
Then, in this order: the card's name and power limit as ``nvidia-smi`` gives
them, one ``{"kernels": [...]}`` line (per kernel: launches counted during the
main-path run, error against the plain version, measured times, and the least
time the card could take; ``ms`` is taken with the inputs cold in the cache
and is the time ``bound_ms`` is held against, ``same_buffers_ms`` repeats one
input set, ``path_ms`` is one call inside ``_mul_relin``), and the last line
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
from fhe_precompiles_tpu_torch.ops.engine import TorchEngine
from fhe_precompiles_tpu_torch.ops.modmath import csub_reduce
from fhe_precompiles_tpu_torch.ops.ntt import intt, ntt
from fhe_precompiles_tpu_torch.params import BENCH_N8192, TESTNET_ONE

BATCH = 128          # the main path's batch
DISTINCT = 8         # distinct ciphertexts, tiled up to BATCH
SWEEP = (16, 32, 64, 256, 512)   # other batch sizes timed beside BATCH
SEED = 20240607

# Published peaks of one H100 SXM.  Memory: 3.35 TB/s.  The kernels do 64-bit
# integer arithmetic on the 32-bit integer pipe, which has half the lanes of
# the float32 pipe (67 TFLOP/s = 33.5e12 multiply-adds a second): 16.75e12
# 32-bit integer multiply-adds a second.  Operations are counted in those:
# the high half of a 64 x 64-bit product takes four, the low half three.
PEAK_BYTES_PER_S = 3.35e12
PEAK_IMAD_PER_S = 16.75e12
MULHI, MULLO = 4, 3
SHOUP = MULHI + 2 * MULLO         # hi(a * ws), a * w, q * p
BARRETT = MULHI + MULLO           # hi(x * mu), q * p
# general product kept lazy: hi(a * b), a * b, hi * (2^64 mod p), one Barrett
# step (2^64 mod p is the same for a whole launch and is not counted)
MUL_LAZY = MULHI + 2 * MULLO + BARRETT
MULMOD = MUL_LAZY + BARRETT
L2_BYTES = 50 * 2 ** 20           # the card's L2 cache

# launches of each kernel in one _mul_relin
CALLS_PER_MUL_RELIN = {"to_bsk_ext": 2, "dyadic": 1, "floor_sk": 1,
                       "relin_dot": 1, "mod_down": 1}

SOURCE = "fhe_precompiles_tpu_torch/csrc/tail.cu"
REPLACES = {
    "to_bsk_ext": "fhe_precompiles_tpu/ops/pallas_tail.py:147",
    "dyadic": "fhe_precompiles_tpu/ops/pallas_tail.py:214",
    "floor_sk": "fhe_precompiles_tpu/ops/pallas_tail.py:254",
    "relin_dot": "fhe_precompiles_tpu/ops/pallas_tail.py:353",
    "mod_down": "fhe_precompiles_tpu/ops/pallas_tail.py:415",
}


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
    `reps` calls queued behind a spin kernel (0.15 ms of it for each call;
    the host issues one in 0.02-0.04 ms).  `fn` takes the call's number."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold_device(0.15 * reps)
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
    of to_bsk_ext multiplies 16-bit values: one each."""
    k, nbsk, nB, kk, n = c.k, c.nbsk, c.nB, c.k_key, c.n
    per_pos = {
        "to_bsk_ext": (k * SHOUP + k + 1
                       + nbsk * (k * SHOUP + BARRETT + 2 * SHOUP)),
        "dyadic": c.nb * 3 * MULMOD,
        "floor_sk": (nbsk * (k * SHOUP + BARRETT + SHOUP) + nB * SHOUP
                     + nB * SHOUP + BARRETT + SHOUP
                     + k * (nB * SHOUP + 2 * BARRETT + SHOUP)),
        "relin_dot": kk * (2 * k * MUL_LAZY + 2 * BARRETT),
        "mod_down": 2 * k * (BARRETT + SHOUP),
    }[name]
    rows = {"to_bsk_ext": 2 * batch, "floor_sk": 3 * batch}.get(name, batch)
    return per_pos * rows * n


def kernel_cases(ctx: BfvContext, c: tail.TailConstants, batch: int, rng):
    """For every kernel: (wrapper, plain version, input tensors) at the shapes
    the multiply path gives it for `batch` ciphertext pairs, with the
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


def io_bytes(inputs, out) -> int:
    """Each input word read once, each output word written once."""
    return 8 * (sum(x.numel() for x in inputs) + out.numel())


def compare(kern, plain, inputs, c):
    got = kern(*inputs, c)
    want = plain(*inputs, c)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype or not got.is_cuda:
        raise AssertionError("kernel output differs in shape, type or device")
    diff = got != want
    mism = int(diff.sum().item())
    max_err = int((got - want).abs().max().item()) if mism else 0
    return got, mism, max_err


def phase_kernels(eng: TorchEngine, rng):
    """Kernel against plain version on the card, at the main path's shapes on
    testnet.one and at a small batch on bench.n8192 (other limb counts).
    Returns the rows of the last ``kernels`` line and, per kernel, the
    comparison's counts with the two terms of the bound."""
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
        imads = imads_per_launch(name, eng.consts, BATCH)
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = imads / PEAK_IMAD_PER_S * 1e3
        del out
        rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": max(max_err, max_err8),
            "ms": cold_ms(kern, inputs, eng.consts),
            "plain_ms": cuda_ms(lambda i: plain(*inputs, eng.consts), reps=5,
                                warmup=1),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "same_buffers_ms": cuda_ms(lambda i: kern(*inputs, eng.consts)),
            "path_ms": None,
        }
        checks[name] = {"name": name, "mismatches": mism,
                        "mismatches_n8192": mism8, "bytes": nbytes,
                        "imads": imads, "bytes_bound_ms": bytes_ms,
                        "operations_bound_ms": ops_ms,
                        "host_issue_ms": host_ms(
                            lambda i: kern(*inputs, eng.consts))}
    return rows, checks


def negacyclic_mul_mod_t(a: np.ndarray, b: np.ndarray, t: int) -> np.ndarray:
    n = a.shape[0]
    full = np.convolve(a.astype(np.int64), b.astype(np.int64))
    out = full[:n].copy()
    out[:n - 1] -= full[n:]
    return np.mod(out, t).astype(np.uint64)


def phase_main_path(eng: TorchEngine, rows: dict) -> dict:
    """Keys and ciphertexts from the host model, B = 128 distinct-operand
    multiply + relinearize on the card, checked against the host golden
    model and by decryption."""
    ctx, prm = eng.golden, eng.params
    rng = np.random.default_rng(SEED + 1)
    pk, sk = ctx.generate_keys(seed=b"\x42" * 64)
    plains = np.zeros((DISTINCT, ctx.n), dtype=np.uint64)
    plains[:, :8] = rng.integers(0, 16, size=(DISTINCT, 8), dtype=np.uint64)
    cts = [ctx.encrypt(plains[i], pk, bytes([i + 1]) * 64)
           for i in range(DISTINCT)]
    tiled = np.tile(np.stack([c.data for c in cts]),
                    (BATCH // DISTINCT, 1, 1, 1))

    tail.reset_launch_counts()
    a = convert.ciphertexts_from_numpy(tiled, eng.device, prm, check=True)
    b = torch.roll(a, 1, dims=0)              # distinct operands
    rk = convert.relin_keys_from_numpy(pk.relin.data, eng.device, prm,
                                       check=True)
    out = eng._mul_relin(a, b, rk)
    single = eng.mul_relin(cts[0], cts[1], pk.relin)
    torch.cuda.synchronize()
    counts = dict(tail.launch_counts)

    if not out.is_cuda or tuple(out.shape) != (BATCH, 2, ctx.k, ctx.n):
        raise AssertionError(f"main path output: {out.device} {out.shape}")
    got = convert.to_numpy(out)
    for i in range(DISTINCT):
        j = (i - 1) % DISTINCT
        want = ctx.mul_relin(cts[i], cts[j], pk.relin)
        for row in range(i, BATCH, DISTINCT):
            if not np.array_equal(got[row], want.data):
                raise AssertionError(f"row {row} differs from the host golden "
                                     "mul_relin")
        dec = ctx.decrypt(Ciphertext(prm, got[i]), sk)
        if not np.array_equal(
                dec, negacyclic_mul_mod_t(plains[i], plains[j], prm.t)):
            raise AssertionError(f"row {i} does not decrypt to the product")
    if not np.array_equal(single.data,
                          ctx.mul_relin(cts[0], cts[1], pk.relin).data):
        raise AssertionError("single-ciphertext mul_relin differs from the "
                             "host golden model")
    # one batched _mul_relin and one single-ciphertext mul_relin
    expected = {name: 2 * calls for name, calls in CALLS_PER_MUL_RELIN.items()}
    if counts != expected:
        raise AssertionError(f"launch counts {counts}, expected {expected}")
    for name, n_launch in counts.items():
        rows[name]["launches"] = n_launch
    return {"phase": "main_path", "ok": True, "preset": "testnet.one",
            "batch": BATCH, "distinct_pairs_checked": DISTINCT,
            "rows_equal_to_golden": BATCH, "decrypt_ok": True,
            "launches": counts, "output_device": str(out.device),
            "inputs": (a, b, rk)}


def staged_mul_relin(eng: TorchEngine, a, b, rk):
    """The steps of ``_mul_relin`` one by one (as ``ops/behz.py`` runs them)
    with a CUDA event before each.  Returns the result and the milliseconds
    spent under each label."""
    bz, c = eng.behz, eng.consts
    marks = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    hold_device(3.0)        # the host queues ahead of the card from here on
    mark("to_bsk_ext")
    ea = tail.to_bsk_ext(a, c)
    mark("torch_ntt")
    fa = ntt(ea, bz.tb_all)
    mark("to_bsk_ext")
    eb = tail.to_bsk_ext(b, c)
    mark("torch_ntt")
    fb = ntt(eb, bz.tb_all)
    mark("dyadic")
    stacked = tail.dyadic(fa, fb, c)
    mark("torch_ntt")
    tq = intt(stacked, bz.tb_all_t)
    mark("floor_sk")
    ct3 = tail.floor_sk(tq, c)
    mark("digit_lift")
    d = csub_reduce(ct3[:, 2, :, None, :], c.key, bz.steps_ct_mod_key)
    mark("torch_ntt")
    d_ntt = ntt(d, bz.tb_key)
    mark("relin_dot")
    acc_ntt = tail.relin_dot(d_ntt, rk, c)
    mark("torch_ntt")
    acc = intt(acc_ntt, bz.tb_key)
    mark("mod_down")
    out = tail.mod_down(acc, ct3[:, :2], c)
    mark("end")
    torch.cuda.synchronize()
    ms = {}
    for (label, ev), (_, nxt) in zip(marks, marks[1:]):
        ms[label] = ms.get(label, 0.0) + ev.elapsed_time(nxt)
    return out, ms


def mul_relin_times(eng: TorchEngine, a, b, rk, reps: int):
    """CUDA-event milliseconds of `reps` single ``_mul_relin`` calls."""
    for _ in range(2):
        eng._mul_relin(a, b, rk)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        eng._mul_relin(a, b, rk)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def phase_timing(eng: TorchEngine, inputs, card: str, rows: dict) -> dict:
    """CUDA-event time of ``_mul_relin`` at B = 128 (median of 12), where it
    goes (the plain torch NTTs against the five kernels), and the same call
    at other batch sizes (median of 5 each).  Writes each kernel's time for
    one call inside the pipeline into `rows`."""
    a, b, rk = inputs
    want = eng._mul_relin(a, b, rk)
    times = mul_relin_times(eng, a, b, rk, 12)
    batch_ms = statistics.median(times)
    sweep = {}
    for size in SWEEP:
        reps_of_a = -(-size // BATCH)
        xa = a.repeat(reps_of_a, 1, 1, 1)[:size].contiguous()
        xb = torch.roll(xa, 1, dims=0)
        ms = statistics.median(mul_relin_times(eng, xa, xb, rk, 5))
        sweep[str(size)] = {"ms_per_batch": ms,
                            "mul_relin_per_s": size / ms * 1e3}

    runs = []
    for _ in range(5):
        out, ms = staged_mul_relin(eng, a, b, rk)
        if not torch.equal(out, want):
            raise AssertionError("the staged run differs from _mul_relin")
        runs.append(ms)
    stage_ms = {label: statistics.median(r[label] for r in runs)
                for label in runs[0]}
    staged_total = sum(stage_ms.values())
    kern_ms = sum(stage_ms[name] for name in tail.KERNEL_NAMES)
    for name in tail.KERNEL_NAMES:
        rows[name]["path_ms"] = stage_ms[name] / CALLS_PER_MUL_RELIN[name]
    return {"phase": "timing", "ok": True, "card": card, "batch": BATCH,
            "ms_per_batch_median": batch_ms, "ms_per_batch_all": times,
            "mul_relin_per_s": BATCH / batch_ms * 1e3,
            "other_batch_sizes": sweep,
            "staged_ms": stage_ms, "staged_total_ms": staged_total,
            "torch_ntt_share": stage_ms["torch_ntt"] / staged_total,
            "tail_kernels_share": kern_ms / staged_total}


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
    emit({"phase": "build", "ok": True, "source": SOURCE,
          "flags": " ".join(build.NVCC_FLAGS),
          "nvcc_seconds": build.build_seconds,
          "seconds": time.perf_counter() - t0})

    eng = TorchEngine(TESTNET_ONE)            # default device: the card
    rows, checks = phase_kernels(eng, np.random.default_rng(SEED))
    emit({"phase": "kernels", "ok": True, "card": card, "tolerance": 0,
          "kernels": list(checks.values())})
    bad = [n for n, r in checks.items()
           if r["mismatches"] or r["mismatches_n8192"]]
    if bad:
        raise AssertionError(f"kernels differ from their plain versions: {bad}")

    main_path = phase_main_path(eng, rows)
    inputs = main_path.pop("inputs")
    emit(main_path)
    emit(phase_timing(eng, inputs, card, rows))

    print(card, flush=True)
    emit({"kernels": list(rows.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
