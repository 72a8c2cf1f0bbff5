"""One short run of each cell on the card through the benchmark's command:
exit 0, ``correct`` true, the cell's metrics there.  Skips without a CUDA
device."""
import json
import subprocess
import sys

import pytest

from bench_port import manifest

MAN = manifest.load()


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_a_short_run_on_the_card(card, cell):
    res = subprocess.run(
        [sys.executable, str(manifest.HERE / "run.py"), "--workload", cell,
         "--seed", "2147483701", "--seconds", "2", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {
        m["name"] for m in manifest.reported(MAN, "end_to_end", cell)}
    assert list(line)[-1] == "checks"
