"""The ``floor_sk`` kernel of this checkout against the one of an earlier
checkout of the port, on one NVIDIA GPU, in turns.

    git archive <commit> fhe_precompiles_tpu_torch | tar -x -C <dir>
    python3 chip_compare.py --parent <dir> [--out <dir for listings>]

`<dir>` holds the earlier ``fhe_precompiles_tpu_torch`` (a git-ignored
folder such as ``fhe_precompiles_tpu_torch/_build/parent``); it is imported
under another name and builds its own kernels into its own ``_build``.
Prints one JSON line each:

  build      registers a thread of each floor_sk instance, from ``ptxas``;
  sass       instructions of each floor_sk instance by opcode, from
             ``cuobjdump -sass`` (the listings go to ``--out``, by default
             the git-ignored ``fhe_precompiles_tpu_torch/_build/compare``);
  copy       a kernel that only moves floor_sk's words, on each launch shape:
             one 8-byte word of each limb a thread, and two positions a
             thread in 16-byte words;
  turns      floor_sk cold (``chip_smoke.cold_ms``) on testnet.one at B = 128
             and bench.n8192 at B = 32, old, new, new, old, each launch first
             held word for word against the plain version; then
             ``_mul_relin`` at B = 128 (median of 12), its staged floor_sk row
             (``chip_smoke.staged_medians``) and B = 256 / 512 (median of 6)
             with each kernel in the engine, in the same order.

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
    return (importlib.import_module("fhe_parent.ops.tail"),
            importlib.import_module("fhe_parent.ops.build"),
            importlib.import_module("fhe_parent.bfv"),
            importlib.import_module("fhe_parent.params"))


def built_library(bld) -> Path:
    return max(bld.BUILD_DIR.glob("libfhe_kernels_*.so"),
               key=lambda p: p.stat().st_mtime)


def ptxas_registers(text: str) -> dict:
    """Registers and spill stores of each floor_sk function in ``nvcc
    -Xptxas -v`` output."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1) if "floor_sk" in m.group(1) else None
        m = re.search(r"(\d+) bytes spill stores", line)
        if current and m:
            out.setdefault(current, {})["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if current and m:
            out.setdefault(current, {})["registers"] = int(m.group(1))
            current = None
    return out


def sass_counts(so: Path, dump: Path) -> dict:
    """Instructions of each floor_sk function, by opcode (``cuobjdump``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out, name, lines = {}, None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "floor_sk" in m.group(1) else None
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path)
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
    old_tail, old_build, old_bfv, old_params = load_parent(args.parent)

    # build both with ptxas's report (a rebuild: the reports are wanted)
    regs = {}
    for label, bld in (("old", old_build), ("new", build)):
        for so in bld.BUILD_DIR.glob("libfhe_kernels_*.so"):
            so.unlink()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bld.load_library(verbose=True)
        (args.out / f"ptxas_{label}.txt").write_text(buf.getvalue())
        regs[label] = ptxas_registers(buf.getvalue())
    emit({"phase": "build", "card": card, "registers": regs})
    emit({"phase": "sass", "old": sass_counts(built_library(old_build),
                                              args.out / "sass_old.txt"),
          "new": sass_counts(built_library(build), args.out / "sass_new.txt")})

    rng = np.random.default_rng(cs.SEED)
    eng = TorchEngine(TESTNET_ONE)
    ctx8 = BfvContext(BENCH_N8192)
    c_new = {"testnet.one": eng.consts,
             "bench.n8192": tail.TailConstants(ctx8, "cuda")}
    c_old = {name: old_tail.TailConstants(old_bfv.BfvContext(prm), "cuda")
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
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
