"""The port's ``seal_compat`` against the JAX package's: the same bytes from
both packages' BLAKE2xb, PRNG, samplers and deterministic encryptor on the
same inputs (tolerance 0: exact bytes and words)."""
import hashlib

import numpy as np
import pytest

from fhe_precompiles_tpu import seal_compat as j_seal
from fhe_precompiles_tpu.bfv.golden import BfvContext as JBfvContext
from fhe_precompiles_tpu.encoding import PLAIN_TYPES as J_PLAIN_TYPES
from fhe_precompiles_tpu.params import TESTNET_ONE as J_ONE
from fhe_precompiles_tpu.seal_compat import encryptor as j_encryptor
from fhe_precompiles_tpu.seal_compat.blake2xb import (
    _blake2b_single as j_blake2b_single, _param_words as j_param_words)

pytest.importorskip("torch")

from fhe_precompiles_tpu_torch import seal_compat
from fhe_precompiles_tpu_torch.bfv.golden import BfvContext
from fhe_precompiles_tpu_torch.encoding import PLAIN_TYPES
from fhe_precompiles_tpu_torch.params import TESTNET_ONE
from fhe_precompiles_tpu_torch.seal_compat import encryptor
from fhe_precompiles_tpu_torch.seal_compat.blake2xb import (_blake2b_single,
                                                            _param_words)


def _bytes(rng, n):
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("dlen", [64, 20, 1])
@pytest.mark.parametrize("mlen", [0, 127, 128, 129, 1000])
def test_blake2b_core_as_the_jax_packages_and_hashlib(dlen, mlen):
    rng = np.random.default_rng(1000 * dlen + mlen)
    data, key = _bytes(rng, mlen), _bytes(rng, 16)
    params = _param_words(dlen, len(key), 1, 1, 0, 0, 0, 0)
    got = _blake2b_single(data, key, params, dlen)
    assert got == j_blake2b_single(
        data, key, j_param_words(dlen, len(key), 1, 1, 0, 0, 0, 0), dlen)
    assert got == hashlib.blake2b(data, digest_size=dlen, key=key).digest()


@pytest.mark.parametrize("outlen", [1, 64, 100, 4096, 5000])
def test_blake2xb_as_the_jax_packages(outlen):
    rng = np.random.default_rng(outlen)
    data, key = _bytes(rng, 8), _bytes(rng, 64)
    assert (seal_compat.blake2xb(outlen, data, key)
            == j_seal.blake2xb(outlen, data, key))


def test_prng_stream_as_the_jax_packages():
    seed = hashlib.sha512(b"prng").digest()
    ours, theirs = seal_compat.Blake2xbPrng(seed), j_seal.Blake2xbPrng(seed)
    for n in (1, 3, 4093, 4096, 10000):
        assert ours.generate(n) == theirs.generate(n)
    assert ours.u32() == theirs.u32()
    with pytest.raises(ValueError, match="64 bytes"):
        seal_compat.Blake2xbPrng(b"short")


@pytest.mark.parametrize("n", [256, 4096])
def test_samplers_as_the_jax_packages(n):
    seed = hashlib.sha512(b"samplers %d" % n).digest()
    ours, theirs = seal_compat.Blake2xbPrng(seed), j_seal.Blake2xbPrng(seed)
    u = seal_compat.sample_poly_ternary(ours, n)
    assert np.array_equal(u, j_seal.sample_poly_ternary(theirs, n))
    assert set(np.unique(u)) <= {-1, 0, 1}
    e = seal_compat.sample_poly_cbd(ours, n)
    assert np.array_equal(e, j_seal.sample_poly_cbd(theirs, n))
    assert e.min() >= -21 and e.max() <= 21


def test_seal_randomness_and_encryptor_as_the_jax_packages():
    ctx, j_ctx = BfvContext(TESTNET_ONE), JBfvContext(J_ONE)
    pk, sk = ctx.generate_keys(seed=b"\x5c" * 64)
    j_pk, _ = j_ctx.generate_keys(seed=b"\x5c" * 64)
    assert np.array_equal(pk.data, j_pk.data)
    seed = hashlib.sha512(b"seal-compat").digest()
    for ours, theirs in zip(encryptor.seal_randomness(seed, ctx.n),
                            j_encryptor.seal_randomness(seed, j_ctx.n)):
        assert np.array_equal(ours, theirs)
    poly = PLAIN_TYPES["u256"].encode(12, TESTNET_ONE)
    assert np.array_equal(poly, J_PLAIN_TYPES["u256"].encode(12, J_ONE))
    ct = encryptor.encrypt_deterministic(ctx, poly, pk, seed)
    j_ct = j_encryptor.encrypt_deterministic(j_ctx, poly, j_pk, seed)
    assert np.array_equal(ct.data, j_ct.data)
    assert PLAIN_TYPES["u256"].decode(ctx.decrypt(ct, sk), TESTNET_ONE) == 12
