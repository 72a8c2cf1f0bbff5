"""The port's hardening tools over its C++ byte path (``native/fuzz.py``,
``native/sanitize.py``): the counterparts of the JAX package's
``tools/make_fuzz_corpus.py``, ``tools/fuzz_native.sh`` and
``tools/sanitize_native.sh``.

The synthesized fuzz seeds are the JAX tool's, name for name and byte for
byte; the coverage fuzzer, built with ASan and UBSan, replays the JAX
package's 132 coverage finds in place and runs a short budget without a
crash; the ASan drive holds every case to the port's golden ``FheApp`` on
``testnet.one`` and ``bench.n1024``, and the TSan drive runs the calls on
four threads and the batched codec beside the zstd swapper.  Every build
goes to ``fhe_precompiles_tpu_torch/_build/sanitize/``.
"""
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from fhe_precompiles_tpu_torch.native import fuzz, sanitize
from fhe_precompiles_tpu_torch.ops import build

REPO = Path(__file__).resolve().parent.parent
REFERENCE_SEEDS = REPO / "fhe_precompiles_tpu" / "native" / "fuzz_seeds"


def _bins(d: Path) -> set:
    return {f.name for f in d.iterdir() if f.suffix == ".bin"}


def test_corpus_equals_the_jax_tools(tmp_path):
    """The port's ``make_corpus`` writes the seeds ``tools/
    make_fuzz_corpus.py`` synthesizes: same names, same bytes (the JAX tool
    also copies ``fuzz_seeds/`` in, which the port's fuzzer reads in
    place)."""
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    proc = subprocess.run([sys.executable, "tools/make_fuzz_corpus.py",
                           str(jax_dir)], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    written = fuzz.make_corpus(port_dir)
    synthesized = _bins(jax_dir) - _bins(REFERENCE_SEEDS)
    assert set(written) == _bins(port_dir) == synthesized
    assert len(written) == 21
    for name in written:
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes()


def test_fuzzer_replays_the_reference_seeds_and_runs(tmp_path):
    before = _bins(REFERENCE_SEEDS)
    assert len(before) == 132
    out = fuzz.run(5, seed=14, corpus_dir=tmp_path)
    assert out["exit_code"] == 0
    assert out["replayed"] == {str(tmp_path): 21, str(REFERENCE_SEEDS): 132}
    assert out["baseline_edges"] > 0
    assert out["iterations"] > 0 and out["edges"] >= out["baseline_edges"]
    found = {f for f in _bins(tmp_path) if f.startswith("cov_")}
    assert len(found) == out["new_coverage_inputs"]
    # the reference's seeds are read in place, never written
    assert _bins(REFERENCE_SEEDS) == before
    assert (tmp_path / fuzz.LAST_INPUT).is_file()


def test_sanitized_builds(tmp_path):
    objs = build.build_sanitized_objects("asan")
    assert [p.parent for p in objs] == [build.SANITIZE_DIR] * 2
    cmd = build.sanitized_object_command("asan", "precompiles.o", tmp_path)
    assert "-fsanitize=address,undefined" in cmd
    assert "-fsanitize-coverage=trace-pc" in cmd
    tsan = build.sanitized_object_command("tsan", "host_engine.o", tmp_path)
    assert "-fsanitize=thread" in tsan
    with pytest.raises(ValueError, match="unknown instrumentation"):
        build.build_sanitized_objects("msan")


@pytest.fixture(scope="module")
def apps():
    return {name: sanitize.preset_app(name)
            for name in ("testnet.one", "bench.n1024")}


@pytest.mark.parametrize("preset", ["testnet.one", "bench.n1024"])
def test_asan_drive(apps, preset, tmp_path):
    out = sanitize.drive_asan(apps[preset], tmp_path)
    assert out["ok"] and out["n"] == apps[preset].params.n
    kinds = out["by_kind"]
    # the 49, eight malformed inputs, 16 size pairs x add / sub
    assert kinds["call"] == 49 + 8 + 32
    assert kinds["unpack_binary"] == 36 + 2 * 8
    assert all(v > 0 for v in kinds.values())


def test_asan_drive_holds_the_library_to_the_expected_bytes(apps, tmp_path):
    """A case file whose expected bytes are wrong in one place fails the
    drive, naming the case."""
    app = apps["bench.n1024"]
    cases = sanitize.make_cases(app)
    kind, name, data, aux, want, outs = cases.records[0]
    wrong = bytearray(outs[0])
    wrong[len(wrong) // 2] ^= 1
    cases.records[0] = (kind, name, data, aux, want, (bytes(wrong),))
    with pytest.raises(sanitize.SanitizerFailure,
                       match=f"case 0 \\(call {name}\\): output bytes"):
        sanitize.drive_asan(app, tmp_path, cases)


def test_tsan_drive(apps, tmp_path):
    out = sanitize.drive_tsan(apps["testnet.one"], tmp_path)
    assert out["ok"] and out["calls"] == 89
    assert any("on each of 4 threads, all equal" in line
               for line in out["lines"])
    assert any("swapper: 20 swaps" in line for line in out["lines"])
