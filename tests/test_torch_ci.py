"""The port's CI workflow (``.github/workflows/ci_torch.yml``) is held to the
files it names, and the repository's tests collect where torch is missing
(the JAX package's CI installs no torch)."""
import fnmatch
import importlib.util
import re
import shlex
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

ROOT = Path(__file__).resolve().parent.parent
WORKFLOW = ROOT / ".github" / "workflows" / "ci_torch.yml"
JOBS = ("test", "hardening", "install", "examples")


@pytest.fixture(scope="module")
def workflow():
    return yaml.safe_load(WORKFLOW.read_text())


def runs(job: dict) -> list:
    """The shell text of each ``run`` step of `job`."""
    return [step["run"] for step in job["steps"] if "run" in step]


def commands(workflow) -> list:
    return [cmd for job in workflow["jobs"].values() for cmd in runs(job)]


def test_jobs_and_triggers(workflow):
    assert tuple(workflow["jobs"]) == JOBS
    # PyYAML reads the key `on` as True
    on = workflow.get("on", workflow.get(True))
    assert on["push"]["branches"] == ["main"] and "pull_request" in on
    for job in workflow["jobs"].values():
        assert job["runs-on"] == "ubuntu-latest"


def test_every_port_test_file_is_selected(workflow):
    files = sorted(p.relative_to(ROOT).as_posix()
                   for p in (ROOT / "tests").glob("test_torch_*.py"))
    assert len(files) >= 24
    patterns = [w for cmd in runs(workflow["jobs"]["test"])
                if "pytest" in cmd for w in shlex.split(cmd)
                if w.startswith("tests/")]
    assert patterns
    missed = [f for f in files
              if not any(fnmatch.fnmatch(f, p) for p in patterns)]
    assert not missed, missed


def test_named_modules_and_demos_exist(workflow):
    text = "\n".join(commands(workflow))
    modules = re.findall(r"-m (fhe_precompiles_tpu_torch[\w.]*)", text)
    assert set(modules) == {"fhe_precompiles_tpu_torch.native.fuzz",
                            "fhe_precompiles_tpu_torch.native.sanitize",
                            "fhe_precompiles_tpu_torch.native.install"}
    for name in modules:
        assert importlib.util.find_spec(name) is not None, name
    demos = re.findall(r"examples/(torch_\w+\.py)", text)
    assert sorted(demos) == sorted(p.name for p in
                                   (ROOT / "examples").glob("torch_*.py"))
    assert len(demos) == 3
    for cmd in runs(workflow["jobs"]["examples"]):
        if "examples/" in cmd:
            assert cmd.split()[-2:] == ["--device", "cpu"], cmd


def test_no_step_touches_the_jax_package_or_needs_a_card(workflow):
    for cmd in commands(workflow):
        # builds and writes of the JAX package's own tree (its Makefile,
        # its native/ directory) belong to ci.yml
        assert "fhe_precompiles_tpu/" not in cmd, cmd
        assert "make " not in cmd, cmd
        assert "chip_smoke" not in cmd, cmd
        assert "cuda" not in cmd.replace("--device cpu", ""), cmd
        assert "nvidia-smi" not in cmd and "nvcc" not in cmd, cmd


def test_tests_collect_without_torch():
    """With torch blocked, the smoke selection of the JAX package's CI
    collects without an error: the port's test files skip."""
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "import pytest\n"
            "sys.exit(pytest.main(['tests/', '--collect-only', '-q', "
            "'-m', 'smoke', '-p', 'no:cacheprovider']))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    assert not re.search(r"^ERROR |\d+ errors?\b|Interrupted", out,
                         re.M), out[-4000:]
    assert re.search(r"\d+/\d+ tests collected", out), out[-2000:]
