"""End-to-end demo of the PyTorch / CUDA port: the precompile lifecycle.

The counterpart of ``examples/demo.py`` on ``fhe_precompiles_tpu_torch``:
the same five steps on ``testnet.one`` (n = 4096), through
``FheApp(TESTNET_ONE, engine="torch")``, whose kernels run on the card.

Run:  python examples/torch_demo.py                  (the card)
      python examples/torch_demo.py --device cpu     (the kernels' plain
                                                      versions on the CPU)
      python examples/torch_demo.py --engine golden  (the host golden model)

Without a card, the torch engine raises unless ``--device cpu`` is given.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fhe_precompiles_tpu_torch import FheApp, pack  # noqa: E402
from fhe_precompiles_tpu_torch.app import _CT_CODEC  # noqa: E402
from fhe_precompiles_tpu_torch.bfv.golden import Ciphertext  # noqa: E402
from fhe_precompiles_tpu_torch.params import TESTNET_ONE  # noqa: E402


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--engine", choices=("torch", "golden"), default="torch",
                   help="the app's engine (default: torch)")
    p.add_argument("--device", default="cuda",
                   help="the torch engine's device (default: cuda, the card)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the five steps; returns the lines printed, the precompile calls
    made as (name, calldata) with their (code, payload), and the values."""
    args = parse_args(argv)
    fhe = FheApp(TESTNET_ONE, engine=args.engine, device=args.device)
    lines, requests, results = [], [], []

    def say(line: str) -> None:
        print(line)
        lines.append(line)

    def run(name: str, data: bytes) -> bytes:
        requests.append((name, data))
        results.append(fhe.call(name, data))
        if results[-1][0]:
            raise RuntimeError(f"{name}: error code {results[-1][0]}")
        return results[-1][1]

    # 1. threshold-network deterministic encryption under the network key
    calldata = pack.pack_two_arguments(16, pack.U256, b"consensus-seed",
                                       pack.BYTES)
    ct16 = run("encrypt_u256", calldata)
    say(f"encrypt_u256(16): {len(ct16)} ciphertext bytes (deterministic)")

    calldata = pack.pack_two_arguments(4, pack.U256, b"consensus-seed",
                                       pack.BYTES)
    ct4 = run("encrypt_u256", calldata)

    # 2. homomorphic multiply through the byte-level precompile
    a = Ciphertext.from_bytes(ct16)
    b = Ciphertext.from_bytes(ct4)
    mul_in = pack.pack_binary_operation(fhe.public_key, a, _CT_CODEC,
                                        b, _CT_CODEC)
    product = run("mul_cipheru256_cipheru256", mul_in)
    say(f"mul precompile: {len(mul_in)} bytes in -> {len(product)} bytes out")

    # 3. decrypt under the network key: scalar big-endian bytes out
    value = pack.U256.deserialize(run("decrypt_u256", product))
    say(f"decrypt_u256: 16 * 4 = {value}")

    # 4. observability: remaining noise budget of the product (the host
    # model's measure, with this app's network private key)
    budget = fhe.noise_budget(product)
    say(f"noise budget after multiply: {budget:.1f} bits")

    # 5. error model: malformed calldata -> stable error code
    code, _ = fhe.call("mul_cipheru256_cipheru256", b"\x00\x01")
    requests.append(("mul_cipheru256_cipheru256", b"\x00\x01"))
    results.append((code, b""))
    say(f"malformed input -> error code {code} (UnexpectedEOF)")
    return {"lines": lines, "engine": args.engine, "device": args.device,
            "requests": requests, "results": results,
            "ciphertext_bytes": len(ct16), "mul_in_bytes": len(mul_in),
            "product_bytes": len(product), "value": value,
            "noise_budget_bits": budget, "error_code": code}


if __name__ == "__main__":
    main()
