"""The port's byte layers against the JAX package's, on the same inputs.

``errors``, ``pack``, ``serialization`` (bincode, seal, keyio, zstd_probes)
and ``encoding`` of ``fhe_precompiles_tpu_torch`` are copies of the JAX
package's modules; these tests send the same inputs, made from a seed with
numpy, through both and require the same bytes, values and error codes
(tolerance 0: every comparison is exact).  The port's zstd calls go through
``serialization/zstd_codec.py``: ``zstandard`` here, and libzstd through
ctypes where ``zstandard`` does not import; the ctypes codec is held against
``zstandard`` too.
"""
import hashlib
import importlib.resources
import math
import struct

import numpy as np
import pytest
import zstandard

from fhe_precompiles_tpu import encoding as j_encoding
from fhe_precompiles_tpu import errors as j_errors
from fhe_precompiles_tpu import pack as j_pack
from fhe_precompiles_tpu.bfv.golden import Ciphertext as JCiphertext
from fhe_precompiles_tpu.params import BENCH_N8192 as J_N8192
from fhe_precompiles_tpu.params import TESTNET_ONE as J_ONE
from fhe_precompiles_tpu.serialization import bincode as j_bincode
from fhe_precompiles_tpu.serialization import keyio as j_keyio
from fhe_precompiles_tpu.serialization import seal as j_seal
from fhe_precompiles_tpu.serialization import zstd_probes as j_probes

pytest.importorskip("torch")

from fhe_precompiles_tpu_torch import encoding, errors, pack
from fhe_precompiles_tpu_torch.bfv.golden import Ciphertext
from fhe_precompiles_tpu_torch.params import BENCH_N8192, PRESETS, TESTNET_ONE
from fhe_precompiles_tpu_torch.serialization import (bincode, keyio, seal,
                                                     zstd_codec, zstd_probes)

K, N = len(TESTNET_ONE.ct_moduli), TESTNET_ONE.n


def outcome(fn, *args):
    """("ok", value as comparable bytes or number) or ("error", code); any
    other exception as ("raises", its type's name)."""
    try:
        value = fn(*args)
    except (errors.FheError, j_errors.FheError) as exc:
        return "error", int(exc.code)
    except Exception as exc:            # noqa: BLE001 - compared, not hidden
        return "raises", type(exc).__name__
    if isinstance(value, np.ndarray):
        return "ok", (value.dtype.str, value.shape, value.tobytes())
    if isinstance(value, float) and math.isnan(value):
        return "ok", "nan"
    return "ok", value


def same(port_fn, jax_fn, *args):
    got, want = outcome(port_fn, *args), outcome(jax_fn, *args)
    assert got == want, (got, want)
    return got


def rand_ct_data(rng, size, params=TESTNET_ONE):
    k = len(params.ct_moduli)
    d = np.zeros((size, k, params.n), dtype=np.uint64)
    for j, p in enumerate(params.ct_moduli):
        d[:, j] = rng.integers(0, p, size=(size, params.n), dtype=np.uint64)
    return d


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

def test_error_codes_and_strings_equal():
    assert ({c.name: int(c) for c in errors.FheErrorCode}
            == {c.name: int(c) for c in j_errors.FheErrorCode})
    for code in range(-1, 10):
        assert (errors.error_code_to_str(code)
                == j_errors.error_code_to_str(code))
    for helper in ("unexpected_eof", "invalid_encoding", "overflow",
                   "failed_decryption", "failed_encryption"):
        exc, j_exc = getattr(errors, helper)("m"), getattr(j_errors, helper)()
        assert int(exc.code) == int(j_exc.code) and str(exc) == "m"


# ---------------------------------------------------------------------------
# pack: scalar codecs and framing
# ---------------------------------------------------------------------------

def _scalar_values(rng):
    big = [int.from_bytes(rng.bytes(32), "big") for _ in range(3)]
    return {
        "U64": [0, 16, (1 << 64) - 1, int(rng.integers(0, 1 << 63)),
                -1, 1 << 64],
        "U256": [0, 12, (1 << 256) - 1, *big, -1, 1 << 256],
        "I64": [0, 16, -16, -(1 << 63), (1 << 63) - 1,
                int(rng.integers(-(1 << 62), 1 << 62)), 1 << 63,
                -(1 << 63) - 1],
        "FRAC64": [0.0, 16.5, -3.25, float(rng.standard_normal()),
                   float("inf"), float("nan"), 1e308, -0.0],
        "BYTES": [b"", b"\x01\x02\x03", rng.bytes(100)],
    }


@pytest.mark.parametrize("codec", ["U64", "U256", "I64", "FRAC64", "BYTES"])
def test_scalar_codecs_equal(codec):
    rng = np.random.default_rng(1)
    port, ref = getattr(pack, codec), getattr(j_pack, codec)
    for value in _scalar_values(rng)[codec]:
        kind, data = same(port.serialize, ref.serialize, value)
        if kind == "ok":
            same(port.deserialize, ref.deserialize, data)
    # wrong widths: InvalidEncoding in both
    for bad in (b"", b"\x00" * 7, b"\x00" * 9, b"\x00" * 31, b"\x00" * 33):
        same(port.deserialize, ref.deserialize, bad)


def test_framing_equal_and_malformed_codes():
    rng = np.random.default_rng(2)
    a, b = rng.bytes(40), rng.bytes(17)
    two = same(lambda: pack.pack_two_arguments(16, pack.U256, a, pack.BYTES),
               lambda: j_pack.pack_two_arguments(16, j_pack.U256, a,
                                                 j_pack.BYTES))[1]
    assert two[:4] == (4 + 32).to_bytes(4, "big")
    codecs = ((pack.U256, pack.BYTES), (j_pack.U256, j_pack.BYTES))
    inputs = [two, b"", b"\x00\x00", b"\x00\x00\x00\x03" + b"x" * 8,
              b"\xff\xff\xff\xff" + b"x" * 8, two[:20], two + b"tail"]
    for data in inputs:
        same(lambda d: pack.unpack_two_arguments(d, *codecs[0]),
             lambda d: j_pack.unpack_two_arguments(d, *codecs[1]), data)
    bincodec = ((pack.BYTES,) * 3, (j_pack.BYTES,) * 3)
    binary = b"".join([(8 + 5).to_bytes(4, "big"),
                       (8 + 5 + len(a)).to_bytes(4, "big"), b"pkpkp", a, b])
    for data in [binary, b"", b"\x00" * 7, b"\x00\x00\x00\x07" * 2,
                 b"\x00\x00\x00\x20\x00\x00\x00\x10" + b"x" * 40,
                 binary[:20], struct.pack(">II", 8, 10_000_000) + a]:
        same(lambda d: pack.unpack_binary_operation(d, *bincodec[0]),
             lambda d: j_pack.unpack_binary_operation(d, *bincodec[1]), data)
    for data in (a, b""):
        same(lambda d: pack.unpack_one_argument(d, pack.BYTES),
             lambda d: j_pack.unpack_one_argument(d, j_pack.BYTES), data)


def test_object_codec_maps_parse_failures_to_invalid_encoding():
    codec = pack.ObjectCodec(Ciphertext)
    j_codec = j_pack.ObjectCodec(JCiphertext)
    for data in (b"", b"\xde\xad\xbe\xef" * 10, bytes(200)):
        assert same(codec.deserialize, j_codec.deserialize, data) == (
            "error", int(errors.FheErrorCode.INVALID_ENCODING))


# ---------------------------------------------------------------------------
# bincode
# ---------------------------------------------------------------------------

def test_bincode_writer_and_reader_equal():
    rng = np.random.default_rng(3)
    ops = [("u8", 7), ("u32", int(rng.integers(0, 1 << 32))),
           ("u64", (1 << 64) - 1), ("f64", float(rng.standard_normal())),
           ("byte_vec", rng.bytes(33)), ("option", True), ("option", False),
           ("raw", rng.bytes(5))]
    w, jw = bincode.Writer(), j_bincode.Writer()
    for name, value in ops:
        getattr(w, name)(value)
        getattr(jw, name)(value)
    data = w.getvalue()
    assert data == jw.getvalue()
    r, jr = bincode.Reader(data), j_bincode.Reader(data)
    for name, _ in ops[:-1]:
        assert same(getattr(r, name), getattr(jr, name))[0] == "ok"
    assert r.remaining() == jr.remaining() == 5
    same(r.expect_end, jr.expect_end)
    # truncation, a bad Option tag
    for data, name in ((b"\x01\x02", "u32"), (b"\x02", "option"),
                       (b"\x05" + bytes(7) + b"ab", "byte_vec"),
                       (b"", "u8"), (b"\x00" * 7, "f64")):
        same(getattr(bincode.Reader(data), name),
             getattr(j_bincode.Reader(data), name))


# ---------------------------------------------------------------------------
# seal: headers, parms_id, streams, blobs
# ---------------------------------------------------------------------------

def test_parms_id_of_every_preset_equal():
    for name, params in PRESETS.items():
        for moduli in (params.key_moduli, params.ct_moduli):
            assert (seal.compute_parms_id(params.n, moduli, params.t)
                    == j_seal.compute_parms_id(params.n, moduli, params.t))
    assert seal.compute_parms_id(4096, TESTNET_ONE.key_moduli, 4096) == (
        bytes.fromhex("63e68f98b2954aeee7cc20177f0c3cd8"
                      "45236b871bd277da64058edf665d979f"))


def test_headers_equal_and_refused_alike():
    for size, mode in ((16, 0), (1 << 40, 2), (12345, 7)):
        hdr = seal.pack_header(size, mode)
        assert hdr == j_seal.pack_header(size, mode)
        same(seal.unpack_header, j_seal.unpack_header, hdr)
    good = seal.pack_header(100, 2)
    # truncated, bad magic, bad header size, empty
    for bad in (good[:15], b"\x5e\xa1" + good[2:], good[:2] + b"\x11"
                + good[3:], b""):
        same(seal.unpack_header, j_seal.unpack_header, bad)


def test_streams_both_ways():
    rng = np.random.default_rng(4)
    payloads = [rng.bytes(1000), bytes(4096),
                rand_ct_data(rng, 2).tobytes(), b""]
    for payload in payloads:
        for compress in (True, False):
            mine = seal.wrap_stream(payload, compress)
            assert mine == j_seal.wrap_stream(payload, compress)
            assert seal.unwrap_stream(mine) == payload
            assert j_seal.unwrap_stream(mine) == payload
    stream = seal.wrap_stream(payloads[0])
    refused = [stream[:-1], stream + b"x", stream[:16],
               j_seal.pack_header(16 + 5, 1) + b"abcde",
               j_seal.pack_header(16 + 5, 2) + b"abcde",
               j_seal.pack_header(16 + 4, 2) + b"\x28\xb5\x2f\xfd"]
    for data in refused:
        assert same(seal.unwrap_stream, j_seal.unwrap_stream, data) == (
            "error", 3)


def test_blobs_equal_and_dynarray_refusals():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 1 << 37, size=(2, 3, 64), dtype=np.uint64)
    pid = rng.bytes(32)
    blob = seal.SealCiphertextBlob(pid, True, 64, 3, data, 1.5, 3)
    j_blob = j_seal.SealCiphertextBlob(pid, True, 64, 3, data, 1.5, 3)
    stream = blob.to_stream()
    assert stream == j_blob.to_stream()
    back = seal.SealCiphertextBlob.from_stream(j_blob.to_stream(False))
    assert np.array_equal(back.data, data) and back.scale == 1.5
    plain = seal.SealPlaintextBlob(pid, data.reshape(-1), 2.0)
    assert plain.to_stream() == j_seal.SealPlaintextBlob(
        pid, data.reshape(-1), 2.0).to_stream()
    ks = seal.SealKSwitchKeysBlob(pid, [[blob, blob]])
    j_ks = j_seal.SealKSwitchKeysBlob(pid, [[j_blob, j_blob]])
    assert ks.to_stream() == j_ks.to_stream()
    same(lambda s: seal.SealKSwitchKeysBlob.from_stream(s).keys[0][1].data,
         lambda s: j_seal.SealKSwitchKeysBlob.from_stream(s).keys[0][1].data,
         ks.to_stream())
    # DynArray: compressed, truncated, count disagreeing with the shape;
    # members truncated; trailing bytes after a blob
    members = blob.members()
    head = members[:32 + 1 + 8 * 3 + 8 + 8]
    inner = members[len(head) + 16:]
    cases = [
        head + j_seal.pack_header(16 + len(inner), 2) + inner,
        members[:-8],
        head + j_seal.pack_header(16 + 8, 0) + struct.pack("<Q", 3)
        + bytes(24),
        members[:40],
    ]
    for payload in cases:
        same(lambda p: seal.SealCiphertextBlob.parse_members(p)[0].data,
             lambda p: j_seal.SealCiphertextBlob.parse_members(p)[0].data,
             payload)
    for cls, j_cls in ((seal.SealCiphertextBlob, j_seal.SealCiphertextBlob),
                       (seal.SealPlaintextBlob, j_seal.SealPlaintextBlob),
                       (seal.SealKSwitchKeysBlob,
                        j_seal.SealKSwitchKeysBlob)):
        for payload in (members + b"\x00", b"", bytes(39)):
            s = seal.wrap_stream(payload, False)
            same(lambda x: type(cls.from_stream(x)).__name__,
                 lambda x: type(j_cls.from_stream(x)).__name__, s)


# ---------------------------------------------------------------------------
# keyio
# ---------------------------------------------------------------------------

def _data(name):
    return (importlib.resources.files("fhe_precompiles_tpu_torch") / "data"
            / name).read_bytes()


def test_network_keys_load_and_resave_equal():
    pub, pri = _data("network.pub"), _data("network.pri")
    pk, j_pk = keyio.load_public_key(pub), j_keyio.load_public_key(pub)
    sk, j_sk = keyio.load_private_key(pri), j_keyio.load_private_key(pri)
    assert pk.params == TESTNET_ONE and j_pk.params == J_ONE
    assert np.array_equal(pk.data, j_pk.data)
    assert np.array_equal(pk.relin.data, j_pk.relin.data)
    assert np.array_equal(sk.s_ntt, j_sk.s_ntt)
    assert keyio.save_public_key(pk) == j_keyio.save_public_key(j_pk)
    assert keyio.save_private_key(sk) == j_keyio.save_private_key(j_sk)
    # the methods installed on the port's golden classes
    assert pk.to_bytes() == j_pk.to_bytes()
    assert type(pk).from_bytes(pub).to_bytes() == pk.to_bytes()


def test_ciphertext_round_trip_through_both():
    rng = np.random.default_rng(6)
    for size in (1, 2, 3):
        data = rand_ct_data(rng, size)
        mine = Ciphertext(TESTNET_ONE, data).to_bytes()
        assert mine == JCiphertext(J_ONE, data).to_bytes()
        assert np.array_equal(JCiphertext.from_bytes(mine).data, data)
        assert np.array_equal(Ciphertext.from_bytes(mine).data, data)


def _ciphertext_variants(rng):
    """Wire ciphertexts each refused by one check of load_ciphertext."""
    good = rand_ct_data(rng, 2)
    over = good.copy()
    over[1, 1, 77] = TESTNET_ONE.ct_moduli[1]            # == its modulus
    top = good.copy()
    top[0, 0, 0] = (1 << 64) - 1                         # past 2^63
    pid = seal.compute_parms_id(N, TESTNET_ONE.ct_moduli, TESTNET_ONE.t)

    def frame(blob, count=1, params=TESTNET_ONE):
        w = bincode.Writer()
        keyio.write_params(w, params)
        w.u64(count)
        w.byte_vec(blob.to_stream())
        return w.getvalue()

    def blob(data=good, ntt=False, parms_id=pid, n=N, k=K):
        return seal.SealCiphertextBlob(parms_id, ntt, n, k, data)

    bad_pid = bytearray(pid)
    bad_pid[3] ^= 1
    return {
        "good": frame(blob()),
        "residue_equal_to_modulus": frame(blob(over)),
        "residue_past_2_63": frame(blob(top)),
        "parms_id": frame(blob(parms_id=bytes(bad_pid))),
        "ntt_form": frame(blob(ntt=True)),
        "limbs": frame(blob(good[:, :1], k=1)),
        "two_blobs": frame(blob(), count=2),
        "trailing": frame(blob()) + b"\x00",
        "scheme_tag": frame(blob())[:8 + 8 + 8 * 3 + 8] + b"\x01\x00\x00\x00"
        + frame(blob())[8 + 8 + 8 * 3 + 8 + 4:],
    }


def test_ciphertext_refusals_same_code():
    rng = np.random.default_rng(7)
    for name, wire in _ciphertext_variants(rng).items():
        got = same(lambda b: Ciphertext.from_bytes(b).data,
                   lambda b: JCiphertext.from_bytes(b).data, wire)
        assert (got[0] == "ok") == (name == "good"), (name, got)
        if name != "good":
            assert got == ("error", 3), name


def test_key_refusals_same_code():
    pub, pri = bytearray(_data("network.pub")), bytearray(_data("network.pri"))
    pk = keyio.load_public_key(bytes(pub))
    over = pk.data.copy()
    over[0, 2, 5] = TESTNET_ONE.key_moduli[2]
    pk_over = keyio.save_public_key(type(pk)(pk.params, over, pk.relin))
    rk_over = pk.relin.data.copy()
    rk_over[1, 0, 1, 9] = (1 << 64) - 1
    pk_rk_over = keyio.save_public_key(
        type(pk)(pk.params, pk.data, type(pk.relin)(pk.params, rk_over)))
    sk = keyio.load_private_key(bytes(pri))
    sk_over = sk.s_ntt.copy()
    sk_over[1, 0] = TESTNET_ONE.key_moduli[1] + 1
    sk_bytes = keyio.save_private_key(type(sk)(sk.params, sk_over))
    flipped = bytearray(pub)
    flipped[200] ^= 0xFF
    for wire in (pk_over, pk_rk_over, bytes(pub[:-1]), bytes(pub) + b"\x00"):
        assert same(lambda b: keyio.load_public_key(b).data,
                    lambda b: j_keyio.load_public_key(b).data,
                    wire) == ("error", 3)
    # a flipped byte inside a frame: loaded or refused, alike
    same(lambda b: keyio.load_public_key(b).data,
         lambda b: j_keyio.load_public_key(b).data, bytes(flipped))
    for wire in (sk_bytes, bytes(pri[:-3])):
        assert same(lambda b: keyio.load_private_key(b).s_ntt,
                    lambda b: j_keyio.load_private_key(b).s_ntt,
                    wire) == ("error", 3)


def test_native_key_store_both_ways(tmp_path):
    pk = keyio.load_public_key(_data("network.pub"))
    sk = keyio.load_private_key(_data("network.pri"))
    keyio.save_keys_native(str(tmp_path / "port.npz"), pk, sk)
    j_pk, j_sk = j_keyio.load_keys_native(str(tmp_path / "port.npz"))
    j_keyio.save_keys_native(str(tmp_path / "jax.npz"), j_pk, j_sk)
    pk2, sk2 = keyio.load_keys_native(str(tmp_path / "jax.npz"))
    assert pk2.params == TESTNET_ONE
    for a, b in ((pk2.data, pk.data), (pk2.relin.data, pk.relin.data),
                 (sk2.s_ntt, sk.s_ntt), (j_pk.data, pk.data)):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

BOUNDARIES = {
    "u256": [0, 1, 12, (1 << 64), (1 << 255) + 7, (1 << 256) - 1, 1 << 256,
             -1],
    "u64": [0, 1, 16, (1 << 63), (1 << 64) - 1, 1 << 64, -1],
    "i64": [0, 16, -16, -(1 << 63), (1 << 63) - 1, 1 << 63, -(1 << 63) - 1],
    "frac64": [0.0, 0.5, -0.25, 16.0, -3.25, 1e-30, 2.0 ** 63, 2.0 ** 64,
               -(2.0 ** 64), 1e308, 5e-324, float("inf"), float("nan")],
}


@pytest.mark.parametrize("tname", ["u256", "u64", "i64", "frac64"])
def test_plain_types_at_their_boundaries(tname):
    port, ref = encoding.PLAIN_TYPES[tname], j_encoding.PLAIN_TYPES[tname]
    assert port.name == ref.name
    for value in BOUNDARIES[tname]:
        kind, enc = same(lambda v: port.encode(v, TESTNET_ONE),
                         lambda v: ref.encode(v, J_ONE), value)
        if kind == "ok":
            coeffs = np.frombuffer(enc[2], dtype=np.uint64)
            same(lambda c: port.decode(c, TESTNET_ONE),
                 lambda c: ref.decode(c, J_ONE), coeffs)
    # decodes past the type's range (overflow code 4) and grown digits
    rng = np.random.default_rng(8)
    for _ in range(4):
        coeffs = rng.integers(0, TESTNET_ONE.t, size=N, dtype=np.uint64)
        coeffs[rng.random(N) < 0.9] = 0
        same(lambda c: port.decode(c, TESTNET_ONE),
             lambda c: ref.decode(c, J_ONE), coeffs)
    negative = encoding.encode_signed(-1, TESTNET_ONE)
    same(lambda c: port.decode(c, TESTNET_ONE),
         lambda c: ref.decode(c, J_ONE), negative)


def test_batch_encoder_on_n8192():
    enc, j_enc = encoding.BatchEncoder(BENCH_N8192), \
        j_encoding.BatchEncoder(J_N8192)
    rng = np.random.default_rng(9)
    vals = rng.integers(0, BENCH_N8192.t, size=enc.slot_count,
                        dtype=np.uint64)
    poly = same(enc.encode, j_enc.encode, vals)[1]
    coeffs = np.frombuffer(poly[2], dtype=np.uint64)
    assert np.array_equal(enc.decode(coeffs), vals)
    same(enc.decode, j_enc.decode, coeffs)
    bad = vals.copy()
    bad[3] = BENCH_N8192.t
    assert same(enc.encode, j_enc.encode, bad) == ("error", 4)
    same(enc.encode, j_enc.encode, vals[:10])
    same(encoding.BatchEncoder, j_encoding.BatchEncoder, TESTNET_ONE)


# ---------------------------------------------------------------------------
# zstd: the canonical corpus, the codec, the copied data files
# ---------------------------------------------------------------------------

def test_zstd_canonical_corpus_and_verdict_equal():
    assert zstd_probes.load_canonical() == j_probes.load_canonical()
    assert zstd_probes.PROBES == j_probes.PROBES
    for p in zstd_probes.PROBES[:5] + zstd_probes.PROBES[8:10]:
        assert zstd_probes.build_probe(p) == j_probes.build_probe(p)
    assert (zstd_probes.check_python_zstd_canonical()
            == j_probes.check_python_zstd_canonical())
    assert zstd_codec.codec_name().startswith("zstandard")


@pytest.fixture(scope="module")
def libzstd():
    try:
        zstd_codec.load_library()
    except OSError as exc:
        pytest.skip(f"no {zstd_codec.LIBRARY}: {exc}")
    return zstd_codec.LibCompressor(3), zstd_codec.LibDecompressor()


def test_ctypes_codec_decompresses_as_zstandard(libzstd):
    _, lib_d = libzstd
    ref = zstandard.ZstdDecompressor()
    frame = zstandard.ZstdCompressor(write_content_size=True).compress(
        b"hello world" * 100)
    sizeless = zstandard.ZstdCompressor(write_content_size=False).compress(
        b"abc" * 1000)
    skip = struct.pack("<I", 0x184D2A50)
    rng = np.random.default_rng(10)
    cases = [frame, frame + b"garbage", frame + frame, frame[:-3], frame[:6],
             frame[:3], b"", b"\x28", sizeless, sizeless + b"xx",
             zstandard.ZstdCompressor().compress(b""),
             skip + struct.pack("<I", 0), skip + struct.pack("<I", 5) + b"ab",
             skip + struct.pack("<I", 5) + b"abcde" + frame, skip + b"\x01",
             bytes(20), rng.bytes(300)]
    for data in cases:
        got = outcome(lib_d.decompress, data, 1 << 30)
        want = outcome(ref.decompress, data, 1 << 30)
        if want[0] == "raises":
            assert got == ("raises", "LibZstdError"), (data[:8], want)
        else:
            assert got == want, data[:8]


def test_ctypes_codec_frames_on_ciphertext_payloads(libzstd):
    """The ciphertext a precompile emits is uniform residues: on those the
    library's frames equal zstandard's (checked in the canonical corpus's
    uniform probes), and every frame decodes back through either codec."""
    lib_c, lib_d = libzstd
    ref_c = zstandard.ZstdCompressor(write_content_size=True)
    rng = np.random.default_rng(11)
    payload = Ciphertext(TESTNET_ONE, rand_ct_data(rng, 2)).to_bytes()
    for p in zstd_probes.PROBES[:5]:
        body = zstd_probes.build_probe(p)
        assert lib_c.compress(body) == ref_c.compress(body), p["id"]
    for body in (payload, bytes(5000), rng.bytes(777)):
        frame = lib_c.compress(body)
        assert zstandard.ZstdDecompressor().decompress(frame) == body
        assert lib_d.decompress(ref_c.compress(body)) == body
    assert zstd_codec.zstd_version() >= (1, 5, 0)


def test_data_files_are_the_jax_packages():
    for name in ("network.pub", "network.pri", "zstd_canonical.json"):
        ref = (importlib.resources.files("fhe_precompiles_tpu") / "data"
               / name).read_bytes()
        assert hashlib.sha256(_data(name)).digest() == \
            hashlib.sha256(ref).digest(), name
