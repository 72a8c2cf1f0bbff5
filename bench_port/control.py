"""The two readings that the limit of ``check.LIMITS`` is set between, at a
cell's own size, on the card:

    python3 bench_port/control.py --workload <cell> --seeds 1 2 3 \\
        [--seconds 2]

For each seed, one process runs the cell's set-up and a short window at the
cell's own load (``harness.run_cell``), then compares the kept results twice:
the program's (the lower reading) and the control's in their place (the
upper reading: ``reference/control.py``, the reference with relinearization
rounding down).  Prints one JSON line a seed, then one with the largest
program reading and the smallest control reading.  The benchmark's own runs
do not run the control.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(cfg: dict, mix: dict, seed: int, seconds: float,
             device: str) -> dict:
    from bench_port import check, harness
    out = harness.run_cell(cfg, mix, seed, seconds, False, device)
    control = check.compare(out.reference, out.samples,
                            got_of=out.reference.control)
    return {"seed": seed, "correct": out.correct,
            "results_compared": out.numbers["results_compared"],
            "program": {k: out.numbers[k] for k in check.LIMITS},
            "control": {k: control[k] for k in check.LIMITS}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch
    from bench_port import check, manifest, traffic
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    man = manifest.load()
    cell = manifest.workload(man, args.workload)
    cfg = manifest.config(man, cell["config"])
    mix = traffic.load(manifest.traffic_path(cell["traffic"]))
    rows = []
    for seed in args.seeds:
        rows.append(readings(cfg, mix, seed, args.seconds, "cuda"))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({
        "workload": args.workload, "seeds": len(rows),
        "lower": {k: max(r["program"][k] for r in rows)
                  for k in check.LIMITS},
        "upper": {k: min(r["control"][k] for r in rows)
                  for k in check.LIMITS}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
