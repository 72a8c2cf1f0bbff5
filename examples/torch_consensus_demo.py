"""Two validators, two engines, one byte stream: the consensus property.

The counterpart of ``examples/consensus_demo.py`` on
``fhe_precompiles_tpu_torch``: a CPU validator (the host golden model,
``FheApp(TESTNET_ONE)``) and a card validator (``FheApp(TESTNET_ONE,
engine="torch")``, its kernels on the card) process the same random stream
of the 12 cipher-cipher precompiles and must emit byte-identical outputs --
any divergence is a consensus break.

Run:  python examples/torch_consensus_demo.py [--requests 100]
      python examples/torch_consensus_demo.py --device cpu   (no card)

Without a card, the card validator raises unless ``--device cpu`` is given.
"""
import argparse
import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from fhe_precompiles_tpu_torch import FheApp, pack  # noqa: E402
from fhe_precompiles_tpu_torch.app import (_CT_CODEC,  # noqa: E402
                                           PRECOMPILE_NAMES)
from fhe_precompiles_tpu_torch.encoding import PLAIN_TYPES  # noqa: E402
from fhe_precompiles_tpu_torch.params import TESTNET_ONE  # noqa: E402


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--requests", type=int, default=100,
                   help="requests in the stream (default: 100)")
    p.add_argument("--device", default="cuda",
                   help="the card validator's device (default: cuda)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the stream through both validators; returns the lines printed,
    the requests as (name, calldata), the card validator's results, the
    divergences and the stream digest."""
    args = parse_args(argv)
    n_req = args.requests

    cpu_validator = FheApp(TESTNET_ONE)                  # golden engine
    card_validator = FheApp(TESTNET_ONE, engine="torch", device=args.device)

    rng = np.random.default_rng(0)
    pk, _sk = cpu_validator.generate_keys()
    pool = {
        t: [cpu_validator.ctx.encrypt(
                PLAIN_TYPES[t].encode(v if t != "frac64" else float(v),
                                      TESTNET_ONE),
                pk, hashlib.sha512(f"{t}{v}".encode()).digest())
            for v in (2, 3, 5)]
        for t in ("u256", "u64", "i64", "frac64")
    }

    binary_ops = [n for n in PRECOMPILE_NAMES if n.count("cipher") == 2]
    stream_digest = hashlib.sha256()
    divergences = 0
    lines, requests, results = [], [], []
    for i in range(n_req):
        name = binary_ops[rng.integers(len(binary_ops))]
        t = name.split("_")[1].replace("cipher", "")
        a, b = rng.choice(3, size=2)
        data = pack.pack_binary_operation(pk, pool[t][a], _CT_CODEC,
                                          pool[t][b], _CT_CODEC)
        code_c, out_c = cpu_validator.call(name, data)
        code_d, out_d = card_validator.call(name, data)
        requests.append((name, data))
        results.append((code_d, out_d))
        if (code_c, out_c) != (code_d, out_d):
            divergences += 1
            lines.append(f"CONSENSUS BREAK at request {i}: {name}")
            print(lines[-1])
        stream_digest.update(out_c)
    digest = stream_digest.hexdigest()[:32]
    lines.append(f"{n_req} requests, {divergences} divergences")
    lines.append(f"stream digest (both validators): {digest}")
    print("\n".join(lines[-2:]))
    if divergences:
        raise AssertionError("consensus broken")
    return {"lines": lines, "device": args.device, "requests": requests,
            "results": results, "divergences": divergences,
            "digest": digest}


if __name__ == "__main__":
    main()
