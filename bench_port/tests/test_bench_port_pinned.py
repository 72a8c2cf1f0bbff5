"""The accepted cells are driven exactly as before the plain ops came: for
both of today's traffic files, at the seeds of ``test_bench_port_traffic``,
the blocks (ops and operand indices), the inputs (keys, fresh encryptions,
pool terms; on ``small.CONFIG``, so that it stays fast) and ``shapes_of``
hash to the digests the code gave before the plain ops were added; and
``run_cell`` calls ``run_pooled_fused`` on such a mix with the four
arguments alone."""
import hashlib
import json

import numpy as np
import pytest

from bench_port import harness, manifest, traffic
from bench_port.inputs import make_inputs
from bench_port.tests import small
from bench_port.tests.test_bench_port_traffic import SEEDS

# taken from the code before the plain ops came
PINNED = {
    "block10k.distinct": {
        0: {
            "blocks": "cd895955e7da577243a5609d299079fc",
            "inputs": "3fab31b1199948af477a5b4e8bc179f6",
            "shapes": "c8f09fe6e64cdd1e9c255cbed00187ea",
        },
        7: {
            "blocks": "00ab1047897c1dba5a20d78e9bc6c358",
            "inputs": "25d5cc1dd7a4777d98dbe7c7359bd165",
            "shapes": "c8f09fe6e64cdd1e9c255cbed00187ea",
        },
        2147483659: {
            "blocks": "0fab5b7a96d5c6934d6f695865ad7119",
            "inputs": "a2caed62a075bc7f6faaa16d09aa2e6e",
            "shapes": "c8f09fe6e64cdd1e9c255cbed00187ea",
        },
        3000000019: {
            "blocks": "4df20fa3b425a2aa395cb5060474b4dd",
            "inputs": "f3691bca196a5ea518963181dab0e372",
            "shapes": "c8f09fe6e64cdd1e9c255cbed00187ea",
        },
    },
    "block10k.shared": {
        0: {
            "blocks": "fcb22be2c7761419a9ea33f286ecbc4d",
            "inputs": "fa1c3647433cb6b47b7a385272809c0a",
            "shapes": "ee9806425ad26080a899afbf03fb24da",
        },
        7: {
            "blocks": "2d4b3e38b5a72de15d540d6578875391",
            "inputs": "7b130eab07292f73b993a6d397908172",
            "shapes": "ee9806425ad26080a899afbf03fb24da",
        },
        2147483659: {
            "blocks": "011cc746cffb8b75afe7547daab79ff6",
            "inputs": "2c806d9e1c692abf39570607566f73f0",
            "shapes": "ee9806425ad26080a899afbf03fb24da",
        },
        3000000019: {
            "blocks": "5033a13e824119aea032e36c493083f6",
            "inputs": "a8cc78ae63dba5b27bf833505660d80b",
            "shapes": "ee9806425ad26080a899afbf03fb24da",
        },
    },
}


def _sha(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(f"{p.dtype}{p.shape}".encode())
            h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(str(p).encode())
    return h.hexdigest()[:32]


def digests(name: str, seed: int) -> dict:
    t = traffic.load(manifest.traffic_path(name))
    blocks = traffic.make_blocks(t, seed)
    inp = make_inputs(small.CONFIG, t, seed)
    return {
        "blocks": _sha(*[x for b in blocks for x in ("|".join(b.ops),
                                                     b.idx)]),
        "inputs": _sha(inp.plains, inp.fresh, inp.terms, inp.pk.data,
                       inp.pk.relin.data, inp.sk.s_ntt),
        "shapes": _sha(json.dumps(harness.shapes_of(inp, t))),
    }


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(PINNED))
def test_todays_cells_are_driven_as_before(name, seed):
    assert digests(name, seed) == PINNED[name][seed]


def test_the_harness_calls_a_mix_without_plain_ops_with_four_arguments(
        monkeypatch):
    from fhe_precompiles_tpu_torch.parallel.stream import RequestStream
    real, calls = RequestStream.run_pooled_fused, []

    def spy(self, *args, **kwargs):
        calls.append((len(args), kwargs))
        return real(self, *args, **kwargs)

    monkeypatch.setattr(RequestStream, "run_pooled_fused", spy)
    out = harness.run_cell(small.CONFIG, small.mix(64), 2 ** 31 + 17, 0.2,
                           False, "cpu")
    assert out.correct and calls
    assert all(c == (4, {}) for c in calls)
