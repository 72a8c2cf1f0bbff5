"""The PyTorch port stands alone: importing it pulls in neither JAX nor the
JAX package, it runs on the card unless the caller names the CPU, and a
kernel wrapper never gives way to its plain version off the CPU.
"""
import importlib
import pkgutil
import subprocess
import sys

import pytest
import torch

import fhe_precompiles_tpu_torch
from fhe_precompiles_tpu_torch.ops import build, tail
from fhe_precompiles_tpu_torch.ops import ntt as torch_ntt
from fhe_precompiles_tpu_torch.ops.engine import TorchEngine
from fhe_precompiles_tpu_torch.params import TESTNET_ONE


def _submodules():
    names = ["fhe_precompiles_tpu_torch"]
    for m in pkgutil.walk_packages(fhe_precompiles_tpu_torch.__path__,
                                   "fhe_precompiles_tpu_torch."):
        names.append(m.name)
    return names


def test_every_submodule_is_listed():
    names = _submodules()
    for want in ("params", "sampling", "convert", "bfv.golden", "bfv.ntt",
                 "bfv.modmath", "bfv.uint128", "ops.modmath", "ops.ntt",
                 "ops.tail", "ops.tail_cases", "ops.behz", "ops.engine",
                 "ops.build", "ops.wide", "ops.four_step"):
        assert "fhe_precompiles_tpu_torch." + want in names


def test_import_pulls_in_no_jax_and_no_jax_package():
    code = (
        "import sys, importlib\n"
        f"for name in {_submodules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'jaxlib' or m == 'fhe_precompiles_tpu'\n"
        "       or m.startswith('fhe_precompiles_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_sources_name_no_jax_import():
    import pathlib
    import re
    root = pathlib.Path(fhe_precompiles_tpu_torch.__file__).parent
    # _build/ holds what is made at run time, not the package's sources
    files = [f for f in root.rglob("*.py")
             if "_build" not in f.relative_to(root).parts]
    files += [root.parent / "chip_smoke.py", root.parent / "chip_compare.py"]
    pat = re.compile(r"^\s*(import|from)\s+(jax|fhe_precompiles_tpu)(\.|\s|$)",
                     re.M)
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f


def test_default_device_is_the_card_and_is_not_replaced():
    """No "cuda if available else cpu": without a card the default raises."""
    if torch.cuda.is_available():
        assert TorchEngine(TESTNET_ONE).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchEngine(TESTNET_ONE)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchEngine(TESTNET_ONE, device="cuda:0")
    assert TorchEngine(TESTNET_ONE, device="cpu").device.type == "cpu"


def test_wrappers_do_not_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a card is refused by every
    wrapper; none of them quietly runs its plain version."""
    eng = TorchEngine(TESTNET_ONE, device="cpu")
    c, n, k, kk, nb = eng.consts, eng.n, eng.k, eng.k_key, eng.nb

    def meta(*shape):
        return torch.empty(shape, dtype=torch.int64, device="meta")

    tail.reset_launch_counts()
    torch_ntt.reset_launch_counts()
    ntts = eng.ntts
    calls = {
        "to_bsk_ext": lambda: tail.to_bsk_ext(meta(1, 2, k, n), c),
        "dyadic": lambda: tail.dyadic(meta(1, 2, nb, n), meta(1, 2, nb, n),
                                      c),
        "floor_sk": lambda: tail.floor_sk(meta(1, 3, nb, n), c),
        "relin_dot": lambda: tail.relin_dot(meta(1, k, kk, n),
                                            meta(k, 2, kk, n), c),
        "mod_down": lambda: tail.mod_down(meta(1, 2, kk, n),
                                          meta(1, 2, k, n), c),
        "ntt": lambda: torch_ntt.ntt(meta(1, 2, nb, n), ntts["all"].tables),
        "intt": lambda: torch_ntt.intt(meta(1, 2, kk, n),
                                       ntts["key"].tables),
    }
    assert set(calls) == set(tail.KERNEL_NAMES + torch_ntt.KERNEL_NAMES)
    for name, call in calls.items():
        with pytest.raises(ValueError, match="no kernel for a tensor"):
            call()
    # a CPU operand mixed with an off-CPU one is refused too
    with pytest.raises(ValueError, match="no kernel for a tensor"):
        tail.dyadic(torch.zeros((1, 2, nb, n), dtype=torch.int64),
                    meta(1, 2, nb, n), c)
    assert not any(tail.launch_counts.values())
    assert not any(torch_ntt.launch_counts.values())
    # the engine's own entry points refuse it too: no NTT on the way quietly
    # takes the stage loops
    with pytest.raises(ValueError, match="no kernel for a tensor"):
        eng._mul_plain(meta(1, 2, k, n), meta(1, n))
    with pytest.raises(ValueError, match="no kernel for a tensor"):
        eng._decrypt_fn(2)(meta(1, 2, k, n), meta(k, n))


def test_kernel_library_needs_nvcc_and_says_so(monkeypatch):
    """Where there is no CUDA toolkit the build raises; it does not return a
    stand-in."""
    import shutil
    if shutil.which("nvcc") or torch.cuda.is_available():
        pytest.skip("this machine has a CUDA toolkit; the build would succeed")
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library()


def test_importing_builds_nothing():
    importlib.reload(build)
    assert build._lib is None and build.build_seconds is None
