"""The traffic generator: the same seed gives the same blocks, every block
holds the mix's exact counts (45 / 10 / 45 in the cells' mixes), operands
lie in the pool, and seeds up to past 2**31 work."""
import numpy as np
import pytest

from bench_port import manifest, traffic

SEEDS = [0, 7, 2 ** 31 + 11, 3_000_000_019]


def mixes():
    return sorted({w["traffic"] for w in manifest.load()["workloads"]})


@pytest.mark.parametrize("name", mixes())
@pytest.mark.parametrize("seed", SEEDS)
def test_blocks_repeat_per_seed_and_keep_the_mix(name, seed):
    t = traffic.load(manifest.traffic_path(name))
    a, b = traffic.make_blocks(t, seed), traffic.make_blocks(t, seed)
    assert len(a) == traffic.DISTINCT_BLOCKS
    for x, y in zip(a, b):
        assert x.ops == y.ops and np.array_equal(x.idx, y.idx)
        assert len(x.ops) == t["requests"]
        assert {op: x.ops.count(op) for op in t["mix"]} == t["mix"]
        assert x.idx.shape == (t["requests"], 2)
        assert x.idx.min() >= 0 and x.idx.max() < t["pool"]
    assert t["mix"] == {"add": 4500, "sub": 1000, "mul": 4500}


def test_seeds_change_the_order_not_the_counts():
    t = traffic.load(manifest.traffic_path(mixes()[0]))
    a = traffic.make_blocks(t, 1)[0]
    b = traffic.make_blocks(t, 2)[0]
    assert a.ops != b.ops and not np.array_equal(a.idx, b.idx)
    assert sorted(a.ops) == sorted(b.ops)


def test_blocks_of_one_run_differ():
    t = traffic.load(manifest.traffic_path(mixes()[0]))
    blocks = traffic.make_blocks(t, 5)
    assert len({tuple(b.idx[:8, 0]) for b in blocks}) == len(blocks)


@pytest.mark.parametrize("bad", [
    {"fresh": 32}, {"mix": {"add": 1}}, {"pool": 0},
    {"extra": 1}])
def test_bad_mixes_are_refused(bad):
    t = dict(traffic.load(manifest.traffic_path(mixes()[0])))
    t.update(bad)
    with pytest.raises(ValueError):
        traffic.validate(t)


def test_negative_seed_is_refused():
    with pytest.raises(ValueError):
        traffic.rng(-1, traffic.STREAM_BLOCKS)
