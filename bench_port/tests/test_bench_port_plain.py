"""A mix with every op, cipher∘plain included, driven through
``harness.run_cell`` on the CPU at a small size (the card's look skipped).

The port's ``RequestStream.run_pooled_fused`` serves the cipher∘cipher ops
only, so a stand-in stream, defined here, takes the ``plains=`` keyword the
harness passes for such a mix: it serves the plain ops, batch by batch, with
``TorchEngine``'s ``_add_plain``, ``_sub_plain``, ``_plain_sub`` and
``_mul_plain``, and hands the rest of the block to the port's method.  On it:

* sound runs read 0 mismatched words on two seeds, every op compared;
* the control (``reference/control.py``) fails on each plain op;
* with a plain op broken underneath, ``correct`` comes out false for each
  fault of ``test_bench_port_control.py``: the state returned unchanged,
  half of a batch left out, an answer altered;
* on the card (``card``), a block of 10,000 requests of every op on
  testnet.one, traced, reads 0 mismatched words.
"""
import numpy as np
import pytest
import torch

from bench_port import check, harness, manifest, traffic
from bench_port.tests import small

from fhe_precompiles_tpu_torch.ops.engine import TorchEngine
from fhe_precompiles_tpu_torch.parallel import stream as port_stream

SEEDS = [2 ** 31 + 41, 3_000_000_043]
SECONDS = 0.3


class PlainStream(port_stream.RequestStream):
    """``run_pooled_fused`` with a plaintext pool: the plain ops served
    here, the others by the port."""

    calls = []

    def run_pooled_fused(self, ops, idx_pairs, ct_pool, pk, plains=None):
        self.calls.append(plains)
        ops, idx = list(ops), np.asarray(idx_pairs, dtype=np.int64)
        cc = [r for r, op in enumerate(ops) if op not in traffic.PLAIN_OPS]
        out = {}
        if cc:
            got = super().run_pooled_fused([ops[r] for r in cc], idx[cc],
                                           ct_pool, pk)
            out = {op: ([cc[i] for i in rs], arr)
                   for op, (rs, arr) in got.items()}
        for op in traffic.PLAIN_OPS:
            rs = [r for r, o in enumerate(ops) if o == op]
            fn = getattr(self.engine, "_" + op)
            outs = []
            for c0 in range(0, len(rs), self.max_batch):
                rows = torch.as_tensor(idx[rs[c0:c0 + self.max_batch]],
                                       device=ct_pool.device)
                ct = ct_pool.index_select(0, rows[:, 0])
                m = plains.index_select(0, rows[:, 1])
                outs.append(fn(m, ct) if op == "plain_sub" else fn(ct, m))
            if outs:
                out[op] = (rs, torch.cat(outs))
        return out


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(port_stream, "RequestStream", PlainStream)
    monkeypatch.setattr(PlainStream, "calls", [])
    return PlainStream


def run(seed=SEEDS[0]):
    return harness.run_cell(small.CONFIG, small.plain_mix(), seed, SECONDS,
                            False, "cpu")


def compared(samples):
    return {op: sum(s.op == op for s in samples) for op in traffic.OPS}


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_runs_read_zero(stand_in, seed):
    out = run(seed)
    assert out.correct and out.failed == 0
    assert out.numbers["word_mismatches"] == 0
    kept = {op: min(harness.SAMPLE[op], n)
            for op, n in small.PLAIN_MIX.items()}
    assert compared(out.samples) == {
        op: harness.HELD_BLOCKS * kept.get(op, 0) for op in traffic.OPS}
    # every call carried the plaintext pool, as (P_plain, n) int64
    plains = stand_in.calls
    assert plains and all(p is not None and p.dtype == torch.int64
                          and tuple(p.shape) == (16, small.CONFIG[
                              "poly_modulus_degree"]) for p in plains)


def test_the_control_fails_on_each_plain_op(stand_in):
    out = run()
    ref = out.reference
    for op in traffic.PLAIN_OPS:
        of_op = [s for s in out.samples if s.op == op]
        control = check.compare(ref, of_op, got_of=ref.control)
        assert control["word_mismatches"] > 0, op
        assert not check.within_limits(control), op


def ct_of(op, x, y):
    """The ciphertext among a plain op's two arguments."""
    return y if op == "plain_sub" else x


def unchanged(op, real):
    def f(self, x, y):
        return ct_of(op, x, y)
    return f


def half_left_out(op, real):
    def f(self, x, y):
        out = real(self, x, y)
        h = (out.shape[0] + 1) // 2
        return torch.cat([out[:h], out[:out.shape[0] - h]])
    return f


def altered(op, real):
    def f(self, x, y):
        out = real(self, x, y).clone()
        out[:, 0, 0, 0] = (out[:, 0, 0, 0] + 1) % self.q_mods[0, 0]
        return out
    return f


FAULTS = {
    "state_unchanged": unchanged,
    "half_of_batch_left_out": half_left_out,
    "answer_altered": altered,
}


@pytest.mark.parametrize("op", traffic.PLAIN_OPS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_plain_op_is_not_correct(stand_in, monkeypatch, fault, op):
    name = "_" + op
    monkeypatch.setattr(TorchEngine, name,
                        FAULTS[fault](op, getattr(TorchEngine, name)))
    out = run()
    assert not out.correct
    assert out.numbers["word_mismatches"] > 0


@pytest.mark.card
def test_a_plain_mix_on_the_card(card, stand_in):
    man = manifest.load()
    mix = traffic.validate({
        "requests": 10000, "pool": 10240, "plain_pool": 256,
        "mix": {"add": 2000, "sub": 1000, "mul": 2000, "add_plain": 2000,
                "sub_plain": 1000, "plain_sub": 500, "mul_plain": 1500}})
    out = harness.run_cell(manifest.config(man, "testnet.one"), mix,
                           2 ** 31 + 53, 3.0, True, "cuda")
    print("stand-in plain mix on the card:", out.end_to_end, out.block_ms,
          out.setup_phases, out.memory_peak_bytes)
    assert out.correct and out.failed == 0
    assert out.numbers["word_mismatches"] == 0
    assert all(compared(out.samples).values())
    assert out.observed.trace.blocks >= 1
