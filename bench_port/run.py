"""The benchmark of ``fhe_precompiles_tpu_torch`` on an NVIDIA GPU: one run
of one cell of ``BENCHMARK.json``.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the reference beside its limit, which also end the
standard error.  Exits with another code than 0, and prints no result, where
no CUDA device is there (or fewer than the cell asks for), where the program
is not in the checkout, or where ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PROGRAM = "fhe_precompiles_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "fhe_precompiles_tpu")


def banned_modules(names) -> list:
    """Loaded modules whose top-level name (the part before the first dot,
    compared whole) is one of ``BANNED``."""
    return sorted(n for n in names if n.split(".", 1)[0] in BANNED)


def power_limit_w():
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def fail(msg: str) -> int:
    print(f"bench_port: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench_port import check, harness, manifest, traffic
    man = manifest.load()
    cell = manifest.workload(man, args.workload)

    import torch
    loading = {"import_torch": time.perf_counter() - T_START}
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{args.workload} needs {cell['chips']} devices, "
                    f"{torch.cuda.device_count()} found")
    loading["cuda_query"] = time.perf_counter() - T_START
    try:
        import fhe_precompiles_tpu_torch as program
    except ImportError as e:
        return fail(f"the program is not in the checkout: {e}")
    if ROOT not in Path(program.__file__).resolve().parents:
        return fail(f"{PROGRAM} was loaded from {program.__file__}, "
                    f"outside the checkout {ROOT}")

    loading["import_program"] = time.perf_counter() - T_START
    cfg = manifest.config(man, cell["config"])
    mix = traffic.load(manifest.traffic_path(cell["traffic"]))
    out = harness.run_cell(cfg, mix, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    found = banned_modules(sys.modules)
    if found:
        return fail(f"modules loaded that the run must not load: {found}")

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": out.memory_peak_bytes,
              "power_limit_w": power_limit_w()}
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed}
    if args.trace:
        from bench_port import trace as tracing
        obs = out.observed
        metrics = {}
        for m in man["per_layer"]:
            value = manifest.load_metric(m["name"]).read(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = tracing.busy_seconds(obs.trace)
        device["window_s"] = obs.trace.window_s
        result["metrics"] = metrics
        result["device"] = device
        result["breakdown"] = tracing.breakdown(obs.trace)
    else:
        result["metrics"] = {
            m["name"]: {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
            for m in man["end_to_end"]}
        result["device"] = device
    result["checks"] = check.checks_line(out.numbers)
    print(f"bench_port: {args.workload} seed {args.seed}: "
          f"{out.attempted} requests, {out.failed} failed, power limit "
          f"{device['power_limit_w']} W, {device['kind']}", file=sys.stderr)
    print("bench_port: set-up (s) " + json.dumps(out.setup_phases)
          + ", loading at (s) " + json.dumps(loading), file=sys.stderr)
    print("bench_port: window's blocks (ms) " + json.dumps(out.block_ms),
          file=sys.stderr)
    check.print_checks(out.numbers)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
