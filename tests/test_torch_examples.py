"""The port's three demos (``examples/torch_*.py``) on the CPU, held against
the JAX package's demos and its golden ``FheApp``.

Each demo runs with ``--device cpu`` (the kernels' plain versions); without
a card and without ``--device cpu`` each raises.  Keys are random in the
demos, so the tests that compare key-dependent bytes fix both packages'
``bfv.golden._random_seed`` to one seed.
"""
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

from fhe_precompiles_tpu import FheApp as JFheApp
from fhe_precompiles_tpu.bfv import golden as jgolden
from fhe_precompiles_tpu.params import TESTNET_ONE as J_ONE

torch = pytest.importorskip("torch")

from fhe_precompiles_tpu_torch.bfv import golden as tgolden

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
DEMOS = ("torch_demo", "torch_consensus_demo", "torch_byte_server_demo")
SEED = bytes(range(64))


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def demos():
    return {name: load(EXAMPLES / f"{name}.py", name) for name in DEMOS}


@pytest.fixture
def fixed_seed(monkeypatch):
    """Both packages' keygen from one seed, so user keys are equal."""
    monkeypatch.setattr(jgolden, "_random_seed", lambda: SEED)
    monkeypatch.setattr(tgolden, "_random_seed", lambda: SEED)


@pytest.fixture(scope="module")
def reference_demo_lines():
    """The five value lines of ``python examples/demo.py`` (the JAX
    package's golden engine)."""
    proc = subprocess.run([sys.executable, str(EXAMPLES / "demo.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.splitlines()


@pytest.mark.parametrize("engine", ["torch", "golden"])
def test_torch_demo_prints_the_reference_lines(demos, reference_demo_lines,
                                               engine):
    got = demos["torch_demo"].main(["--device", "cpu", "--engine", engine])
    assert got["lines"] == reference_demo_lines
    assert len(got["lines"]) == 5
    assert got["value"] == 64 and got["error_code"] == 1
    assert (got["ciphertext_bytes"], got["mul_in_bytes"],
            got["product_bytes"]) == (88603, 588255, 88644)
    assert f"{got['noise_budget_bits']:.1f}" == "38.5"
    assert [code for code, _ in got["results"]] == [0, 0, 0, 0, 1]


def test_torch_consensus_demo_digest_equals_the_reference(
        demos, fixed_seed, monkeypatch, capsys):
    monkeypatch.delenv("FHE_TPU_ENGINE", raising=False)
    ref = load(EXAMPLES / "consensus_demo.py", "consensus_demo")
    # the reference's accelerator validator, held to golden by the JAX
    # package's own tests, stands in as its golden app: no jit compile
    monkeypatch.setattr(ref, "FheApp",
                        lambda params, engine=None: JFheApp(params))
    monkeypatch.setattr(sys, "argv", ["consensus_demo.py", "--requests", "8"])
    capsys.readouterr()
    ref.main()
    want = capsys.readouterr().out.splitlines()
    got = demos["torch_consensus_demo"].main(["--requests", "8",
                                              "--device", "cpu"])
    assert got["lines"] == want
    assert got["lines"][-2:] == ["8 requests, 0 divergences",
                                 f"stream digest (both validators): "
                                 f"{got['digest']}"]
    assert got["divergences"] == 0 and len(got["requests"]) == 8
    assert all(code == 0 for code, _ in got["results"])


def test_torch_byte_server_demo_equals_the_jax_golden_app(demos, fixed_seed):
    got = demos["torch_byte_server_demo"].main(["--device", "cpu"])
    ref = JFheApp(J_ONE)
    assert len(got["requests"]) == len(got["results"]) == 7
    for (name, data), result in zip(got["requests"], got["results"]):
        assert result[0] == 0, name
        assert result == ref.call(name, data), name
    assert got["results"] == got["want"]
    assert got["lines"][-1].startswith("every (code, payload) byte-equal")


@pytest.mark.parametrize("name", DEMOS)
def test_demo_raises_without_a_card(demos, monkeypatch, name):
    """The card is the default: no environment read, no fallback to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demos[name].main([])
