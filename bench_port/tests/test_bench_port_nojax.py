"""The run's check for modules it must not load compares top-level names
whole: the port's name begins with the JAX package's and must pass."""
import ast
from pathlib import Path

import pytest

from bench_port.run import banned_modules

HERE = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("names,found", [
    (["fhe_precompiles_tpu_torch", "fhe_precompiles_tpu_torch.x"], []),
    (["fhe_precompiles_tpu.x", "numpy"], ["fhe_precompiles_tpu.x"]),
    (["fhe_precompiles_tpu"], ["fhe_precompiles_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax", "jaxlib.xla_client"]),
    (["jaxtyping", "flaxen", "torch"], []),
])
def test_banned_modules_by_whole_top_level_name(names, found):
    assert banned_modules(names) == found


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_imports_jax_and_the_reference_imports_no_program():
    for path in HERE.rglob("*.py"):
        tops = imported_tops(path)
        assert not tops & {"jax", "jaxlib", "flax", "fhe_precompiles_tpu"}, \
            path
        if "reference" in path.parts:
            assert "fhe_precompiles_tpu_torch" not in tops, path
            assert not tops - {"__future__", "dataclasses", "functools",
                               "hashlib", "math", "os", "typing",
                               "numpy"}, path
