"""A kernel of this checkout against the same kernel of an earlier checkout
of the port, on one NVIDIA GPU, in turns: ``floor_sk`` (the default),
kernel 8, the fused four-step NTT (``--kernel four_step``), or kernel 9, the
four-step product of the two-launch transform (``--kernel
four_step_phase``).

    git archive <commit> fhe_precompiles_tpu_torch | tar -x -C <dir>
    python3 chip_compare.py --parent <dir>
                            [--kernel floor_sk|four_step|four_step_phase]
                            [--out <dir for listings>]

`<dir>` holds the earlier ``fhe_precompiles_tpu_torch`` (a git-ignored
folder such as ``fhe_precompiles_tpu_torch/_build/parent``); it is imported
under another name and builds its own kernels into its own ``_build``.
Prints one JSON line each:

  build      registers a thread and spill stores of each instance of the
             kernel, from ``ptxas``;
  sass       instructions of each instance by opcode, from ``cuobjdump
             -sass`` (the listings go to ``--out``, by default the
             git-ignored ``fhe_precompiles_tpu_torch/_build/compare``);

floor_sk:
  copy       a kernel that only moves floor_sk's words, on each launch shape:
             one 8-byte word of each limb a thread, and two positions a
             thread in 16-byte words;
  turns      floor_sk cold (``chip_smoke.cold_ms``) on testnet.one at B = 128
             and bench.n8192 at B = 32, old, new, new, old, each launch first
             held word for word against the plain version; then
             ``_mul_relin`` at B = 128 (median of 12), its staged floor_sk row
             (``chip_smoke.staged_medians``) and B = 256 / 512 (median of 6)
             with each kernel in the engine, in the same order.

four_step:
  ablations  kernel 8 built again with one part taken out, cold at both
             shapes below (outputs unused): its tensor-core products (the
             wgmma instruction made a PTX comment), the fold of its group
             sums, both: what each part costs;
  turns      four_step_ntt at (128, 2, 5, 4096) and four_step_intt at
             (128, 3, 5, 4096) with t * q_hat_inv folded (the main path's
             shapes on the four-step engine) cold, old, new, new, old, each
             launch first held word for word against the plain version;
             then ``_mul_relin`` on ``TorchEngine(TESTNET_ONE,
             ntt_backend="four_step")`` at B = 128 (median of 12) and its
             staged NTT rows and total, with each kernel in the engine, in
             the same order.

four_step_phase:
  ablations  kernel 9 built again with one part taken out, cold in mode
             "pre" and "none" at (128, 2, 5, 64, 64) (outputs unused): its
             tensor-core products, the fold of its group sums, both, and
             the grid's staging in shared memory (the words read from
             device memory instead);
  turns      four_step_phase cold at (128, 2, 5, 64, 64) in each mode, old,
             new, new, old, each launch first held word for word against
             the plain version; then ``FourStepNtt(fused=False)`` there and
             back on the prepared operand (median of 12) and
             ``chip_smoke.staged_two_launch``'s rows (median of 5), in the
             same order.

Then the card's name and power limit.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib
import importlib.util
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from fhe_precompiles_tpu_torch import convert
from fhe_precompiles_tpu_torch.bfv import BfvContext
from fhe_precompiles_tpu_torch.ops import build, tail, tail_cases
from fhe_precompiles_tpu_torch.ops import four_step as fsm
from fhe_precompiles_tpu_torch.ops.engine import TorchEngine
from fhe_precompiles_tpu_torch.params import BENCH_N8192, TESTNET_ONE

COPY_SOURCE = r"""
#include <cuda_runtime.h>
typedef unsigned long long u64;
// reads nb words and writes k a position, as floor_sk does
__global__ void __launch_bounds__(256)
copy_words(const u64* __restrict__ t, u64* __restrict__ out, long long rows,
           int n, int k, int nb) {
    const int pos = blockIdx.x * 256 + threadIdx.x;
    if (pos >= n) return;
    for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
        const u64* tp = t + row * nb * n + pos;
        u64 s = 0;
        for (int l = 0; l < nb; ++l) s ^= tp[(long long)l * n];
        for (int i = 0; i < k; ++i) out[(row * k + i) * n + pos] = s + i;
    }
}
__global__ void __launch_bounds__(256)
copy_pairs(const ulonglong2* __restrict__ t, ulonglong2* __restrict__ out,
           long long rows, int n2, int k, int nb) {
    const int pos = blockIdx.x * 256 + threadIdx.x;
    if (pos >= n2) return;
    for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
        const ulonglong2* tp = t + row * nb * n2 + pos;
        ulonglong2 s = make_ulonglong2(0, 0);
        for (int l = 0; l < nb; ++l) {
            ulonglong2 v = tp[l * n2];
            s.x ^= v.x;
            s.y ^= v.y;
        }
        for (int i = 0; i < k; ++i)
            out[(row * k + i) * n2 + pos] = make_ulonglong2(s.x + i, s.y);
    }
}
extern "C" int copy_launch(int pairs, const void* t, void* out,
                           long long rows, int n, int k, int nb,
                           void* stream) {
    const int width = pairs ? n / 2 : n;
    dim3 grid((width + 255) / 256, rows < 65535 ? (unsigned)rows : 65535);
    if (pairs)
        copy_pairs<<<grid, 256, 0, (cudaStream_t)stream>>>(
            (const ulonglong2*)t, (ulonglong2*)out, rows, n / 2, k, nb);
    else
        copy_words<<<grid, 256, 0, (cudaStream_t)stream>>>(
            (const u64*)t, (u64*)out, rows, n, k, nb);
    return (int)cudaGetLastError();
}
"""


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def load_parent(root: Path):
    """The earlier package under the name ``fhe_parent``."""
    pkg = root / "fhe_precompiles_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "fhe_parent", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["fhe_parent"] = mod
    spec.loader.exec_module(mod)
    return {name: importlib.import_module("fhe_parent." + name)
            for name in ("ops.tail", "ops.build", "ops.four_step", "bfv",
                         "params")}


def built_library(bld) -> Path:
    return max(bld.BUILD_DIR.glob("libfhe_kernels_*.so"),
               key=lambda p: p.stat().st_mtime)


def ptxas_registers(text: str, kernel: str) -> dict:
    """Registers and spill stores of each function whose name holds `kernel`
    in ``nvcc -Xptxas -v`` output."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1) if kernel in m.group(1) else None
        m = re.search(r"(\d+) bytes spill stores", line)
        if current and m:
            out.setdefault(current, {})["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if current and m:
            out.setdefault(current, {})["registers"] = int(m.group(1))
            current = None
    return out


def sass_counts(so: Path, dump: Path, kernel: str) -> dict:
    """Instructions of each function whose name holds `kernel`, by opcode
    (``cuobjdump``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out, name, lines = {}, None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                out[name] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                      line)
        if name and m:
            out[name][m.group(1)] += 1
            lines.append(line)
    dump.write_text("\n".join(lines))
    return {f: {"total": sum(c.values()), **dict(c.most_common())}
            for f, c in out.items()}


def copy_library(out_dir: Path):
    src = out_dir / "copy_only.cu"
    src.write_text(COPY_SOURCE)
    so = out_dir / "libcopy_only.so"
    subprocess.run([build._find_nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.copy_launch.argtypes = [i, vp, vp, ll, i, i, i, vp]
    lib.copy_launch.restype = i
    return lib


def copy_only(lib, pairs: bool):
    """A wrapper in the shape of ``tail.floor_sk`` around the copy kernel."""
    def kern(tq, c):
        out = torch.empty(tq.shape[:-2] + (c.k, c.n), dtype=torch.int64,
                          device=tq.device)
        rc = lib.copy_launch(int(pairs), tq.data_ptr(), out.data_ptr(),
                             tq.numel() // (c.nb * c.n), c.n, c.k, c.nb,
                             torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"copy kernel: cudaError {rc}")
        return out
    return kern


def floor_sk_input(ctx, c, batch: int, rng) -> torch.Tensor:
    tq = cs.rand_rows(rng, (batch * 3,), ctx.q_mods + ctx.Bsk, ctx.n)
    tq = tail_cases.place_alpha_cases(tq, ctx)
    return cs.dev(tq.reshape(batch, 3, c.nb, ctx.n))


def mul_relin_inputs(eng: TorchEngine):
    """The main path's operands (``chip_smoke.phase_main_path``)."""
    ctx, prm = eng.golden, eng.params
    pk, _, plains = cs.make_keys_and_plains(ctx)
    cts = [ctx.encrypt(plains[i], pk, cs.seed_of(i))
           for i in range(cs.DISTINCT)]
    tiled = np.tile(np.stack([c.data for c in cts]),
                    (cs.BATCH // cs.DISTINCT, 1, 1, 1))
    a = convert.ciphertexts_from_numpy(tiled, eng.device, prm, check=True)
    rk = convert.relin_keys_from_numpy(pk.relin.data, eng.device, prm)
    return a, torch.roll(a, 1, dims=0), rk


def build_both(old, args, card: str) -> None:
    """Both libraries rebuilt with ptxas's report (the reports are wanted);
    the build and sass lines for the compared kernel."""
    regs = {}
    for label, bld in (("old", old["ops.build"]), ("new", build)):
        for so in bld.BUILD_DIR.glob("libfhe_kernels_*.so"):
            so.unlink()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bld.load_library(verbose=True)
        (args.out / f"ptxas_{label}.txt").write_text(buf.getvalue())
        regs[label] = ptxas_registers(buf.getvalue(), args.kernel)
    emit({"phase": "build", "card": card, "registers": regs})
    emit({"phase": "sass",
          "old": sass_counts(built_library(old["ops.build"]),
                             args.out / "sass_old.txt", args.kernel),
          "new": sass_counts(built_library(build), args.out / "sass_new.txt",
                             args.kernel)})


def compare_floor_sk(old, args, card: str) -> None:
    rng = np.random.default_rng(cs.SEED)
    eng = TorchEngine(TESTNET_ONE)
    ctx8 = BfvContext(BENCH_N8192)
    c_new = {"testnet.one": eng.consts,
             "bench.n8192": tail.TailConstants(ctx8, "cuda")}
    old_tail, old_params = old["ops.tail"], old["params"]
    c_old = {name: old_tail.TailConstants(old["bfv"].BfvContext(prm), "cuda")
             for name, prm in (("testnet.one", old_params.TESTNET_ONE),
                               ("bench.n8192", old_params.BENCH_N8192))}
    inputs = {"testnet.one": floor_sk_input(eng.golden, eng.consts, 128, rng),
              "bench.n8192": floor_sk_input(ctx8, c_new["bench.n8192"], 32,
                                            rng)}
    kern = {"old": lambda x, c: old_tail.floor_sk(x, c_old[c]),
            "new": lambda x, c: tail.floor_sk(x, c_new[c])}

    copy_lib = copy_library(args.out)
    copy_ms = {}
    for shape, x in inputs.items():
        c = c_new[shape]
        for label, pairs in (("one_word_a_thread", False),
                             ("two_positions_a_thread", True)):
            copy_ms[f"{shape} {label}"] = cs.cold_ms(copy_only(copy_lib, pairs),
                                                     (x,), c)
    emit({"phase": "copy", "card": card, "ms": copy_ms,
          "bytes_bound_ms": {s: cs.io_bytes((x,), x[..., :c_new[s].k, :])
                             / cs.PEAK_BYTES_PER_S * 1e3
                             for s, x in inputs.items()}})

    # the kernels in turns
    for shape, x in inputs.items():
        want = tail.floor_sk_plain(x, c_new[shape])
        for label in ("old", "new"):
            if not torch.equal(kern[label](x, shape), want):
                raise AssertionError(f"{label} floor_sk differs from the "
                                     f"plain version on {shape}")
    turns = {}
    for label in ("old", "new", "new", "old"):
        for shape, x in inputs.items():
            turns.setdefault(f"{label} {shape}", []).append(
                cs.cold_ms(kern[label], (x,), shape))

    # the engine with each kernel
    a, b, rk = mul_relin_inputs(eng)
    want = eng._mul_relin(a, b, rk)
    cs.call_times(lambda: eng._mul_relin(a, b, rk), 12)     # warm-up only
    new_floor_sk = tail.floor_sk
    path = {}
    try:
        for label in ("old", "new", "new", "old"):
            tail.floor_sk = (new_floor_sk if label == "new" else
                             lambda x, c: old_tail.floor_sk(
                                 x, c_old["testnet.one"]))
            if not torch.equal(eng._mul_relin(a, b, rk), want):
                raise AssertionError(f"_mul_relin with the {label} floor_sk "
                                     "differs")
            r = path.setdefault(label, {"batch_ms": [], "staged_floor_sk": [],
                                        "staged_total": [], "b256": [],
                                        "b512": []})
            r["batch_ms"] += cs.call_times(lambda: eng._mul_relin(a, b, rk), 6)
            st = cs.staged_medians(eng, (a, b, rk), want, 5)
            r["staged_floor_sk"].append(st["floor_sk"])
            r["staged_total"].append(sum(st.values()))
            for size in (256, 512):
                xa = a.repeat(size // cs.BATCH, 1, 1, 1).contiguous()
                xb = torch.roll(xa, 1, dims=0)
                r[f"b{size}"] += cs.call_times(
                    lambda: eng._mul_relin(xa, xb, rk), 3)
    finally:
        tail.floor_sk = new_floor_sk
    for r in path.values():
        r["batch_ms_median"] = statistics.median(r["batch_ms"])
        r["b256_median"] = statistics.median(r["b256"])
        r["b512_median"] = statistics.median(r["b512"])
    emit({"phase": "turns", "card": card, "cold_ms": turns,
          "mul_relin": path})


# kernel 8 with a part taken out (text of csrc/four_step.cu -> its stand-in)
WGMMA_TEXT = '"wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 "'
FOLD_TEXT = """        if (s == 8) x[e] = v << 32;
        else x[e] += v << (8 * (s >= 4 ? s - 4 : s));
    }
    if (s != 4) return;"""
NO_FOLD = """        x[e] = v;
    }
    return;"""
ABLATIONS = {
    "no_tensor_core_products": {WGMMA_TEXT: '"// "'},
    "no_fold": {FOLD_TEXT: NO_FOLD},
    "neither": {WGMMA_TEXT: '"// "', FOLD_TEXT: NO_FOLD},
}


# kernel 9's grid staging taken out: the grid words read from device
# memory
GRID_STAGED_TEXT = """f.rows, f.grid_staged,
        f.in_staged, groups"""
PHASE_ABLATIONS = {**ABLATIONS, "grid_from_device_memory": {
    GRID_STAGED_TEXT: "f.rows, 0,\n        f.in_staged, groups"}}


def ablation_libraries(out_dir: Path, ablations: dict) -> dict:
    """csrc/four_step.cu with each ablation's substitutions applied, each
    built into its own library, the nvcc runs side by side."""
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    procs = {}
    for name, subs in ablations.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        text = (build.CSRC / "four_step.cu").read_text()
        for old, new in subs.items():
            if old not in text:
                raise AssertionError(f"ablation {name}: text not found: "
                                     f"{old!r}")
            text = text.replace(old, new)
        (d / "four_step.cu").write_text(text)
        for h in build.CSRC.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [build._find_nvcc(), *build.NVCC_FLAGS, "-I", str(d), "-o",
             str(d / "lib.so"), str(d / "four_step.cu")],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablation {name}: nvcc failed\n"
                               + err.decode())
        lib = libs[name] = ctypes.CDLL(str(so))
        lib.fhe_four_step_ntt.argtypes = [vp, vp, ll, i, i, i, ll, vp, vp,
                                          vp, vp, vp, i, vp]
        lib.fhe_four_step_phase.argtypes = [vp, vp, ll, i, i, i, ll, vp, vp,
                                            vp, i, vp]
    return libs


def kernel8_of(lib, d: str):
    """A wrapper in the shape of ``fsm.ntt`` / ``fsm.intt`` around the
    kernel 8 entry point of `lib`."""
    inverse = d == "intt"

    def kern(x, tb):
        out = torch.empty_like(x)
        L = tb.p.shape[0]
        w_r, w_c, grid, grid_s = ((tb.Ai_wg, tb.B0i_wg, tb.TiT,
                                   tb.TiT_shoup40) if inverse else
                                  (tb.A_wg, tb.B0_wg, tb.T, tb.T_shoup40))
        rc = lib.fhe_four_step_ntt(
            x.data_ptr(), out.data_ptr(), x.numel() // tb.n, L, tb.R, tb.C,
            L * tb.n, tb.fold_scalars.data_ptr(), w_r.data_ptr(),
            w_c.data_ptr(), grid.data_ptr(), grid_s.data_ptr(), int(inverse),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"ablation launch: cudaError {rc}")
        return out
    return kern


def compare_four_step(old, args, card: str) -> None:
    old_fs = old["ops.four_step"]
    eng4 = TorchEngine(TESTNET_ONE, ntt_backend="four_step")
    g, prm = eng4.golden, eng4.params
    all_mods = g.q_mods + g.Bsk
    folded = ([prm.t * int(g.q_hat_inv[i]) % int(p)
               for i, p in enumerate(g.q_mods)] + [prm.t] * len(g.Bsk))
    # the parent's tables of each of the engine's stacks, by the new tables
    old_tables = {}
    for stack, mods, factors in (("q", g.q_mods, None),
                                 ("all", all_mods, None),
                                 ("all_t", all_mods, folded),
                                 ("key", g.key_mods, None)):
        old_tables[id(eng4.ntts[stack].tables)] = old_fs.build_mxu_tables(
            mods, g.n, "cuda", n_inv_factors=factors)
    rng = np.random.default_rng(cs.SEED)
    cases = {"four_step_ntt (128, 2, 5, 4096)":
             ("ntt", eng4.ntts["all"].tables,
              cs.ntt_rows(rng, (cs.BATCH, 2), all_mods, g.n)),
             "four_step_intt (128, 3, 5, 4096), folded":
             ("intt", eng4.ntts["all_t"].tables,
              cs.ntt_rows(rng, (cs.BATCH, 3), all_mods, g.n))}
    new_k = {"ntt": fsm.ntt, "intt": fsm.intt}
    plain = {"ntt": fsm.ntt_plain, "intt": fsm.intt_plain}
    kern = {"new": lambda d: new_k[d],
            "old": lambda d: (lambda x, tb: getattr(old_fs, d)(
                x, old_tables[id(tb)]))}
    for label, (d, tb, x) in cases.items():
        want = plain[d](x, tb)
        for who in ("old", "new"):
            if not torch.equal(kern[who](d)(x, tb), want):
                raise AssertionError(f"the {who} kernel differs from the "
                                     f"plain version: {label}")
    turns = {}
    for who in ("old", "new", "new", "old"):
        for label, (d, tb, x) in cases.items():
            turns.setdefault(f"{who} {label}", []).append(
                cs.cold_ms(kern[who](d), (x,), tb))

    # the whole kernel and each ablation, in turns, there and back
    libs = ablation_libraries(args.out / "ablations", ABLATIONS)
    order = ["whole", *ABLATIONS]
    parts = {name: {} for name in order}
    for name in order + order[::-1]:
        for label, (d, tb, x) in cases.items():
            k = new_k[d] if name == "whole" else kernel8_of(libs[name], d)
            parts[name].setdefault(label, []).append(
                cs.cold_ms(k, (x,), tb))
    emit({"phase": "ablations", "card": card, "cold_ms": parts})

    # the four-step engine with each kernel
    a, b, rk = mul_relin_inputs(eng4)
    want = eng4._mul_relin(a, b, rk)
    cs.call_times(lambda: eng4._mul_relin(a, b, rk), 12)    # warm-up only
    path = {}
    try:
        for who in ("old", "new", "new", "old"):
            fsm.ntt, fsm.intt = kern[who]("ntt"), kern[who]("intt")
            if not torch.equal(eng4._mul_relin(a, b, rk), want):
                raise AssertionError(f"_mul_relin with the {who} kernel "
                                     "differs")
            r = path.setdefault(who, {"batch_ms": [], "staged": []})
            r["batch_ms"] += cs.call_times(lambda: eng4._mul_relin(a, b, rk),
                                           6)
            r["staged"].append(cs.staged_medians(eng4, (a, b, rk), want, 5))
    finally:
        fsm.ntt, fsm.intt = new_k["ntt"], new_k["intt"]
    for r in path.values():
        r["batch_ms_median"] = statistics.median(r["batch_ms"])
        r["staged_total"] = [sum(st.values()) for st in r["staged"]]
    emit({"phase": "turns", "card": card, "cold_ms": turns,
          "mul_relin": path})


def phase_of(lib):
    """A wrapper in the shape of ``fsm.phase`` around the kernel 9 entry
    point of `lib` (contiguous input)."""
    def kern(m, weights, grid, mode, tb):
        out = torch.empty_like(m)
        L, (K, J) = tb.p.shape[0], m.shape[-2:]
        rc = lib.fhe_four_step_phase(
            m.data_ptr(), out.data_ptr(), m.numel() // (K * J), L, K, J,
            L * K * J, tb.fold_scalars.data_ptr(), weights.data_ptr(),
            None if grid is None else grid.data_ptr(),
            fsm.PHASE_MODES.index(mode),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"ablation launch: cudaError {rc}")
        return out
    return kern


def compare_phase(old, args, card: str) -> None:
    """Kernel 9 of the parent checkout (its ``phase``, its own tables and
    argument forms) against this one."""
    old_fs = old["ops.four_step"]
    eng4 = TorchEngine(TESTNET_ONE, ntt_backend="four_step")
    g = eng4.golden
    all_mods = g.q_mods + g.Bsk
    two = fsm.FourStepNtt(all_mods, g.n, "cuda", fused=False)
    tb, otb = two.tables, old_fs.build_mxu_tables(all_mods, g.n, "cuda")
    rng = np.random.default_rng(cs.SEED)
    x = cs.ntt_rows(rng, (cs.BATCH, 2), all_mods, g.n)
    m = x.view(x.shape[:-1] + (tb.R, tb.C))
    # each mode's grid: (this checkout's, the parent's)
    grid = (tb.T, (otb.T, otb.T_shoup))
    grids = {"none": (None, None), "pre": grid, "post": grid}

    def kern(who, mode):
        new_g, old_g = grids[mode]
        if who == "new":
            return lambda v, t: fsm.phase(v, t.A_wg, new_g, mode, t)
        return lambda v, t: old_fs.phase(v, otb.A_dig, old_g, mode, otb)

    for mode in fsm.PHASE_MODES:
        want = fsm.phase_plain(m, tb.A_wg, grids[mode][0], mode, tb)
        for who in ("old", "new"):
            if not torch.equal(kern(who, mode)(m, tb), want):
                raise AssertionError(f"the {who} kernel differs from the "
                                     f"plain version in mode {mode}")
    turns = {}
    for who in ("old", "new", "new", "old"):
        for mode in fsm.PHASE_MODES:
            turns.setdefault(f"{who} {mode} (128, 2, 5, 64, 64)", []).append(
                cs.cold_ms(kern(who, mode), (m,), tb))

    # the whole kernel and each ablation, in turns, there and back
    libs = ablation_libraries(args.out / "ablations", PHASE_ABLATIONS)
    order = ["whole", *PHASE_ABLATIONS]
    parts = {name: {} for name in order}
    for name in order + order[::-1]:
        ph = fsm.phase if name == "whole" else phase_of(libs[name])
        for mode in ("pre", "none"):
            parts[name].setdefault(mode, []).append(cs.cold_ms(
                lambda v, t, ph=ph, mode=mode: ph(v, t.A_wg,
                                                  grids[mode][0], mode, t),
                (m,), tb))
    emit({"phase": "ablations", "card": card, "cold_ms": parts})

    # the two-launch transform with each kernel, there and back, and its
    # staged rows
    ext = tail.to_bsk_ext(mul_relin_inputs(eng4)[0], eng4.consts)
    want = eng4._ntt_all(ext)
    old_two = old_fs.FourStepNtt(all_mods, g.n, "cuda", fused=False)
    transform = {"new": two, "old": old_two}
    staged = {"new": None, "old": (
        lambda v: old_fs.phase(v, otb.A_dig, None, "none", otb),
        lambda v: old_fs.phase(v, otb.B0_dig, (otb.TT, otb.TT_shoup), "pre",
                               otb))}
    path = {}
    for who in ("old", "new", "new", "old"):
        t = transform[who]
        y = t.ntt(ext)
        if not (torch.equal(y, want) and torch.equal(t.intt(y), ext)):
            raise AssertionError(f"the two-launch transform with the {who} "
                                 "kernel differs")
        r = path.setdefault(who, {"there_and_back_ms": [], "staged": []})
        r["there_and_back_ms"] += cs.call_times(lambda: t.intt(t.ntt(ext)),
                                                6)
        runs = [cs.staged_two_launch(ext, tb, staged[who])[1]
                for _ in range(5)]
        r["staged"].append({label: statistics.median(run[label]
                                                     for run in runs)
                            for label in runs[0]})
    for r in path.values():
        r["there_and_back_ms_median"] = statistics.median(
            r["there_and_back_ms"])
    emit({"phase": "turns", "card": card, "cold_ms": turns,
          "two_launch": path})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--kernel",
                    choices=("floor_sk", "four_step", "four_step_phase"),
                    default="floor_sk")
    ap.add_argument("--out", type=Path,
                    default=Path("fhe_precompiles_tpu_torch/_build/compare"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    args.out.mkdir(parents=True, exist_ok=True)
    old = load_parent(args.parent)
    build_both(old, args, card)
    if args.kernel == "four_step":
        compare_four_step(old, args, card)
    elif args.kernel == "four_step_phase":
        compare_phase(old, args, card)
    else:
        compare_floor_sk(old, args, card)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
