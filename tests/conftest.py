"""The `slow` marks of tests under tests/ (the marker is registered in
pyproject.toml; `smoke` comes from conftest.py at the root).

The tier-1 command (ROADMAP.md) runs ``-m 'not slow'``. CI's full job on
main, which has no marker filter, still runs these, as does
``python -m pytest tests/ -m slow``.
"""
import pytest

# file::item -> its own seconds with --durations=0, the file alone in one
# process on an 8-core host; each is minutes of the u32-pair backend's XLA
# CPU compiles
SLOW = {
    "test_jax_engine.py::test_relin_shoup_table_bitexact[pair]": 794.05,
    "test_jax_engine.py::test_prepared_multiply_bitexact[pair]": 380.27,
    "test_jax_engine.py::test_batched_mul_relin_matches_per_element[pair]": 300.02,
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        seconds = SLOW.get(item.nodeid.rsplit("/", 1)[-1])
        if seconds is not None:
            item.add_marker(pytest.mark.slow(reason=f"{seconds} s alone, over 300 s"))
