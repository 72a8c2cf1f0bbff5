"""The roofline readers' counts against hand counts on one small shape, and
the trace reductions on a hand-made trace."""
import pytest

from bench_port import manifest, peaks
from bench_port.harness import Observed
from bench_port.trace import (Op, Trace, block_issue_seconds, busy_seconds,
                               idle_gaps, short_name)

NTT = manifest.load_metric("ntt_roofline_pct")
TAIL = manifest.load_metric("tail_roofline_pct")

# n = 16, k = 2, |Bsk| = 3 (nB = 2), kk = 3; 2 multiplies on a pool of 8
SHAPE = {"n": 16, "k": 2, "k_key": 3, "nbsk": 3,
         "q_moduli": [0xFFFFEE001, 0xFFFFC4001], "m_sk": 0x1FFFFE0001 - 64,
         "pool": 8, "requests": 5, "mix": {"add": 2, "sub": 1, "mul": 2}}


def test_ntt_bytes_and_operations_by_hand():
    # not pooled (8 > 2 * 2): forward over q u Bsk for 4 operands, 2 x 5 rows
    # each = 40 rows; inverse 3 x 5 x 2 = 30; key forward 2 x 3 x 2 = 12;
    # key inverse 2 x 3 x 2 = 12.  A row: 16 words in, 16 out = 256 bytes.
    # Tables: forward L + 2 L n words, inverse L + 2 L n + 2 L.
    want_bytes = [40 * 256 + 8 * (5 + 160), 30 * 256 + 8 * (5 + 160 + 10),
                  12 * 256 + 8 * (3 + 96), 12 * 256 + 8 * (3 + 96 + 6)]
    # 8 butterflies x 4 stages x 4 FMAs = 128 a row; the inverse 64 more
    want_fmas = [40 * 128, 30 * 192, 12 * 128, 12 * 192]
    assert NTT.block_work(SHAPE) == list(zip(want_bytes, want_fmas))


def test_ntt_counts_pooled_ciphertexts_once():
    pooled = dict(SHAPE, pool=3)               # 3 <= 2 * 2
    rows = NTT.transforms(pooled)[0][1]
    assert rows == 2 * 5 * 3


def test_tail_bytes_by_hand():
    w = 8 * 16
    work = TAIL.block_work(SHAPE)
    assert work["to_bsk_ext"][0] == w * 8 * (2 + 5)      # 4 operands x 2
    assert work["dyadic"][0] == w * 2 * 7 * 5
    assert work["floor_sk"][0] == w * 3 * 2 * (5 + 2)
    assert work["relin_dot"][0] == w * (2 * 2 * 3 + 2 * 2 * 3 + 2 * 2 * 3)
    assert work["mod_down"][0] == w * 2 * (2 * 3 + 4 * 2)
    # floor_sk's FP64 products: nB (k + 1) + (nB + 1 + k) + k (nB + 1)
    assert work["floor_sk"][2] == 16 * 3 * 2 * (6 + 5 + 6) * 4
    assert work["dyadic"][1] == 16 * 2 * 5 * 3 * peaks.MULMOD


def trace_of(ops, blocks=1, start=0.0, end=10.0, host=()):
    return Trace(ops, list(host), start, end, blocks)


def test_readers_on_a_hand_made_trace():
    bound = NTT.block_bound_s(SHAPE)
    ops = [Op("void ntt_kernel<false>(unsigned long long const*)", 0, bound),
           Op("void ntt_kernel<true>(unsigned long long const*)", 1,
              1 + bound),
           Op("Memcpy HtoD (Pageable -> Device)", 3, 4),
           Op("void at::native::(anonymous namespace)::k<1>(int)", 5, 6)]
    host = [Op("bench_port.block", 0, 0.004), Op("cudaMemcpyAsync", 0, 0.001),
            Op("cudaStreamSynchronize", 0.001, 0.002),
            Op("bench_port.block", 0.004, 0.010),
            Op("cudaDeviceSynchronize", 0.007, 0.010)]
    obs = Observed(SHAPE, trace_of(ops, host=host))
    assert NTT.read(obs) == pytest.approx(50.0)
    assert TAIL.read(obs) is None
    assert manifest.load_metric("plain_torch_ms").read(obs) == \
        pytest.approx(1e3)
    assert manifest.load_metric("host_issue_ms").read(obs) == \
        pytest.approx(3.0)
    idle = manifest.load_metric("device_idle_pct").read(obs)
    assert idle == pytest.approx(100 * (1 - (2 * bound + 2) / 10))
    assert short_name(ops[3].name) == "at::native::{anon}::k<1>"


def test_readers_find_nothing_in_an_empty_trace():
    obs = Observed(SHAPE, trace_of([]))
    for m in manifest.load()["per_layer"]:
        assert manifest.load_metric(m["name"]).read(obs) is None


def test_busy_union_and_idle_gaps_by_host_op():
    dev = [Op("a", 1, 3), Op("b", 2, 4), Op("c", 6, 7)]
    host = [Op("bench_port.block", 0, 10), Op("aten::cat", 4.5, 5.5),
            Op("cudaMemcpyAsync", 4.8, 5.2)]
    tr = Trace(dev, host, 0, 8, 1)
    assert busy_seconds(tr) == pytest.approx(4.0)
    gaps = dict(idle_gaps(tr))
    assert gaps["aten::cat > cudaMemcpyAsync"] == pytest.approx(2.0)
    assert gaps["the stream's Python between calls"] == pytest.approx(2.0)


def test_issue_seconds_leave_out_the_waits_inside_each_block():
    host = [Op("bench_port.block", 0, 5), Op("aten::copy_", 1, 3),
            Op("cudaStreamSynchronize", 1.5, 2.5),
            Op("cudaDeviceSynchronize", 4, 5), Op("bench_port.block", 5, 7),
            Op("cudaMemcpy", 6, 6.5), Op("cudaStreamSynchronize", 8, 9)]
    assert block_issue_seconds(Trace([], host, 0, 9, 2)) == \
        pytest.approx([3.0, 1.5])
