"""The comparison that decides ``correct``, driven as a run drives it on
the CPU at a small size (``harness.run_cell`` with the card's look skipped):

* sound runs read 0 mismatched words, on both of the stream's paths;
* the control (the reference with relinearization rounding down,
  ``reference/control.py``) in the program's place fails the comparison;
* with the timed path broken underneath, ``correct`` comes out false for
  each fault these cells can have: a step that returns its state unchanged,
  half of each batch left out (the other half repeated in its place), and
  an answer altered where it is produced.  (No cell spans chips, so no
  exchange between chips can be left out.)
"""
import pytest
import torch

from bench_port import check, harness
from bench_port.tests import small

from fhe_precompiles_tpu_torch.ops.engine import TorchEngine

SEED = 2 ** 31 + 3
SECONDS = 0.3


def run(pool, seed=SEED):
    return harness.run_cell(small.CONFIG, small.mix(pool), seed, SECONDS,
                            False, "cpu")


@pytest.mark.parametrize("pool", [64, 16])
def test_sound_runs_read_zero_and_the_control_fails(pool):
    out = run(pool)
    assert out.correct and out.failed == 0
    assert out.numbers["word_mismatches"] == 0
    assert out.numbers["results_compared"] >= 2 * (12 + 6 + 4)
    control = check.compare(out.reference, out.samples,
                            got_of=out.reference.control)
    assert control["word_mismatches"] > 0
    assert not check.within_limits(control)
    # the control breaks the bytes, not the plaintexts
    ctx, sk = out.reference.inp.ctx, out.reference.inp.sk
    s = next(s for s in out.samples if s.op == "mul")
    from bench_port.reference.golden import Ciphertext
    assert (ctx.decrypt(Ciphertext(ctx.params, out.reference.control(s)), sk)
            == ctx.decrypt(Ciphertext(ctx.params, s.got), sk)).all()


def unchanged(self, a, b, rk):
    return a


def half_left_out(real):
    def f(self, a, b, rk):
        out = real(self, a, b, rk)
        h = (out.shape[0] + 1) // 2
        return torch.cat([out[:h], out[:out.shape[0] - h]])
    return f


def altered(real):
    def f(self, a, b, rk):
        out = real(self, a, b, rk).clone()
        out[:, 0, 0, 0] = (out[:, 0, 0, 0] + 1) % self.q_mods[0, 0]
        return out
    return f


FAULTS = {
    "state_unchanged": lambda real: unchanged,
    "half_of_batch_left_out": half_left_out,
    "answer_altered": altered,
}


@pytest.mark.parametrize("pool", [64, 16])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, pool):
    for name in ("_mul_relin", "_mul_relin_prepared"):
        monkeypatch.setattr(TorchEngine, name,
                            FAULTS[fault](getattr(TorchEngine, name)))
    out = run(pool)
    assert not out.correct
    assert out.numbers["word_mismatches"] > 0


def test_a_wrong_add_is_not_correct(monkeypatch):
    monkeypatch.setattr(TorchEngine, "_add", TorchEngine._sub)
    out = run(64)
    assert not out.correct
