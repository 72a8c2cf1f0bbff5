"""A configuration and traffic mixes small enough for a CPU test run:
testnet.one's primes and t at n = 256, blocks of 48 requests."""
from bench_port import traffic

CONFIG = {"poly_modulus_degree": 256,
          "coeff_modulus": [0xFFFFEE001, 0xFFFFC4001, 0x1FFFFE0001],
          "plain_modulus": 4096, "max_batch": 8}
MIX = {"add": 20, "sub": 8, "mul": 20}
PLAIN_MIX = {"add": 8, "sub": 4, "mul": 8, "add_plain": 8, "sub_plain": 4,
             "plain_sub": 4, "mul_plain": 12}


def mix(pool: int) -> dict:
    """Pool 64 > 2 x 20 multiplies: every operand prepared; pool 16: the
    stream prepares each pooled ciphertext once."""
    return traffic.validate({"requests": 48, "mix": dict(MIX),
                             "pool": pool})


def plain_mix(plain_pool: int = 16) -> dict:
    """Every op of ``traffic.OPS`` in one block, on 64 ciphertexts."""
    return traffic.validate({"requests": 48, "mix": dict(PLAIN_MIX),
                             "pool": 64, "plain_pool": plain_pool})
