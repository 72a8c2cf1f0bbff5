"""The traffic generator: the same seed gives the same blocks, every block
holds its mix's exact counts (45 / 10 / 45 in the pooled cells' mixes),
operands lie in their pools (a plain op's second operand in the plaintext
pool), plain indices come from a stream of their own, and seeds up to past
2**31 work."""
import numpy as np
import pytest

from bench_port import manifest, traffic
from bench_port.tests import small

SEEDS = [0, 7, 2 ** 31 + 11, 3_000_000_019]


def mixes():
    return sorted({w["traffic"] for w in manifest.load()["workloads"]})


def assert_block_keeps(t, x):
    """`x` holds `t`'s exact counts, each operand inside its pool."""
    assert len(x.ops) == t["requests"]
    assert {op: x.ops.count(op) for op in t["mix"]} == t["mix"]
    assert x.idx.shape == (t["requests"], 2)
    plain = np.isin(x.ops, traffic.PLAIN_OPS)
    assert x.idx.min() >= 0 and x.idx[:, 0].max() < t["pool"]
    assert (x.idx[~plain, 1] < t["pool"]).all()
    assert (x.idx[plain, 1] < t.get("plain_pool", 0)).all()


@pytest.mark.parametrize("name", mixes())
@pytest.mark.parametrize("seed", SEEDS)
def test_blocks_repeat_per_seed_and_keep_the_mix(name, seed):
    t = traffic.load(manifest.traffic_path(name))
    a, b = traffic.make_blocks(t, seed), traffic.make_blocks(t, seed)
    assert len(a) == traffic.DISTINCT_BLOCKS
    for x, y in zip(a, b):
        assert x.ops == y.ops and np.array_equal(x.idx, y.idx)
        assert_block_keeps(t, x)


@pytest.mark.parametrize("name", ["block10k.distinct", "block10k.shared"])
def test_the_pooled_cells_mix_45_10_45(name):
    t = traffic.load(manifest.traffic_path(name))
    assert t["mix"] == {"add": 4500, "sub": 1000, "mul": 4500}


@pytest.mark.parametrize("seed", SEEDS)
def test_a_plain_mix_keeps_its_counts_and_pools(seed):
    t = small.plain_mix()
    blocks = traffic.make_blocks(t, seed)
    assert blocks[0].ops != traffic.make_blocks(t, seed + 1)[0].ops
    for x in blocks:
        assert_block_keeps(t, x)
    plain = np.isin(blocks[0].ops, traffic.PLAIN_OPS)
    assert plain.sum() == 28 and blocks[0].idx[plain, 1].max() > 0


def test_plain_indices_come_from_a_stream_of_their_own():
    t, seed = small.plain_mix(), 9
    g = traffic.rng(seed, traffic.STREAM_BLOCKS)
    g_plain = traffic.rng(seed, traffic.STREAM_PLAIN_IDX)
    base = np.repeat(np.arange(len(traffic.OPS)),
                     [t["mix"].get(op, 0) for op in traffic.OPS])
    for x in traffic.make_blocks(t, seed):
        # the block stream draws the order and the (requests, 2) indices
        # alone; the plain stream the plaintext indices
        order = g.permutation(base)
        idx = g.integers(0, t["pool"], size=(t["requests"], 2),
                         dtype=np.int64)
        plain = np.isin(x.ops, traffic.PLAIN_OPS)
        assert x.ops == [traffic.OPS[i] for i in order]
        assert np.array_equal(x.idx[:, 0], idx[:, 0])
        assert np.array_equal(x.idx[~plain], idx[~plain])
        assert np.array_equal(x.idx[plain, 1], g_plain.integers(
            0, t["plain_pool"], size=int(plain.sum()), dtype=np.int64))


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


WITH_MUL_PLAIN = {"add": 4500, "sub": 1000, "mul": 4000, "mul_plain": 500}


@pytest.mark.parametrize("bad", [
    {"fresh": 32}, {"mix": {"add": 1}}, {"pool": 0},
    {"extra": 1},
    {"plain_pool": 16},
    {"mix": WITH_MUL_PLAIN},
    {"mix": WITH_MUL_PLAIN, "plain_pool": 0}])
def test_bad_mixes_are_refused(bad):
    t = dict(traffic.load(manifest.traffic_path(mixes()[0])))
    t.update(bad)
    with pytest.raises(ValueError):
        traffic.validate(t)


def test_negative_seed_is_refused():
    with pytest.raises(ValueError):
        traffic.rng(-1, traffic.STREAM_BLOCKS)
