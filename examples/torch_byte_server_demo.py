"""ByteServer demo: the reference's calldata surface, batched on the card.

The counterpart of ``examples/byte_server_demo.py`` on
``fhe_precompiles_tpu_torch``.  Builds a small mixed request stream (binary
ops under a user key + the threshold API), serves it through ``ByteServer``
with the C++ native codec on ``FheApp(TESTNET_ONE, engine="torch")``, and
verifies every (code, payload) equals ``FheApp.call`` one at a time -- the
consensus property that lets a card-fronted node coexist with call-by-call
CPU validators.

Run:  python examples/torch_byte_server_demo.py                (the card)
      python examples/torch_byte_server_demo.py --device cpu   (no card)

Without a card, the app raises unless ``--device cpu`` is given.  The
native codec uses the ``zstandard`` wheel's zstd where that imports, else
the machine's ``libzstd.so.1``; where that build is not the canonical one,
the library says so once on stderr at its start, and the demo shows it.
"""
import argparse
import hashlib
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fhe_precompiles_tpu_torch import FheApp, pack  # noqa: E402
from fhe_precompiles_tpu_torch.app import _CT_CODEC  # noqa: E402
from fhe_precompiles_tpu_torch.encoding import PLAIN_TYPES  # noqa: E402
from fhe_precompiles_tpu_torch.params import TESTNET_ONE  # noqa: E402
from fhe_precompiles_tpu_torch.serve import ByteServer  # noqa: E402


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="the app's device (default: cuda, the card)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Serves the seven requests; returns the lines printed, the requests as
    (name, calldata), the server's results, the call-by-call results
    (``want``), the seconds of the server's run and the server (closed)."""
    args = parse_args(argv)
    app = FheApp(TESTNET_ONE, engine="torch", device=args.device)
    with ByteServer(TESTNET_ONE, app=app, codec="native") as server:
        pk, _sk = app.generate_keys()

        def ct(value, tag):
            seed = hashlib.sha512(tag).digest()
            return app.ctx.encrypt(
                PLAIN_TYPES["u64"].encode(value, TESTNET_ONE), pk, seed)

        a, b = ct(6, b"demo-a"), ct(7, b"demo-b")
        reqs = []
        for op in ("add", "sub", "mul"):
            reqs.append((f"{op}_cipheru64_cipheru64",
                         pack.pack_binary_operation(pk, a, _CT_CODEC,
                                                    b, _CT_CODEC)))
        reqs.append(("mul_cipheru64_u64",
                     pack.pack_binary_operation(pk, a, _CT_CODEC, 3,
                                                pack.U64)))
        reqs.append(("encrypt_u64",
                     pack.pack_two_arguments(41, pack.U64, b"pd",
                                             pack.BYTES)))
        net_ct = app.ctx.encrypt(PLAIN_TYPES["u64"].encode(9, TESTNET_ONE),
                                 app.public_key,
                                 hashlib.sha512(b"net").digest())
        reqs.append(("decrypt_u64", pack.pack_one_argument(net_ct,
                                                           _CT_CODEC)))
        reqs.append(("reencrypt_u64",
                     pack.pack_binary_operation(pk, net_ct, _CT_CODEC,
                                                b"rd", pack.BYTES)))

        t0 = time.time()
        results = server.run(reqs)
        dt = time.time() - t0
    lines = [f"served {len(reqs)} byte requests in {dt:.2f}s"]
    print(lines[-1])
    want = []
    for (name, data), (code, payload) in zip(reqs, results):
        want.append(app.call(name, data))
        status = "OK" if (code, payload) == want[-1] else "MISMATCH"
        lines.append(f"  {name:32s} code={code} bytes={len(payload):6d}  "
                     f"{status}")
        print(lines[-1])
    if results != want:
        raise AssertionError("a served result differs from FheApp.call")
    lines.append("every (code, payload) byte-equal to FheApp.call — "
                 "consensus holds")
    print(lines[-1])
    return {"lines": lines, "device": args.device, "requests": reqs,
            "results": results, "want": want, "seconds": dt,
            "server": server}


if __name__ == "__main__":
    main()
