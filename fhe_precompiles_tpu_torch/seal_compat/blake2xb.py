"""BLAKE2xb extensible-output function (the BLAKE2X construction over
BLAKE2b), matching SEAL's vendored ``util/blake2xb.c``.

BLAKE2X (Aumasson-Neves-Wilcox-O'Hearn-Winnerlein, 2016) computes

    H0   = BLAKE2b(input, key; parameter block with xof_length = outlen)
    B(i) = BLAKE2b(H0; digest_length = min(64, remaining), fanout = 0,
                   depth = 0, leaf_length = 64, node_offset = i,
                   node_depth = 0, inner_length = 64, xof_length = outlen)
    out  = B(0) || B(1) || ...

``hashlib.blake2b`` cannot express depth = 0, so the compression function is
implemented here directly -- numpy-vectorized so all expansion nodes of one
XOF call run as a single batched compression (the PRNG hot path).

In the BLAKE2b parameter block the 8-byte ``node_offset`` field is split by
BLAKE2X into node_offset (low 4 bytes) and xof_length (high 4 bytes).
"""
from __future__ import annotations

import struct

import numpy as np

_IV = np.array([
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179], dtype=np.uint64)

_SIGMA = np.array([
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0]],
    dtype=np.int64)

_U64 = np.uint64


def _rotr(x: np.ndarray, r: int) -> np.ndarray:
    return (x >> _U64(r)) | (x << _U64(64 - r))


def _compress(h: np.ndarray, m: np.ndarray, t: int, last: bool) -> None:
    """Batched BLAKE2b F: h (B, 8) u64 states, m (B, 16) or (1, 16) words.

    Same t / finalization flag for every lane (all uses here share them).
    Mutates h in place.
    """
    B = h.shape[0]
    v = np.empty((B, 16), dtype=np.uint64)
    v[:, :8] = h
    v[:, 8:] = _IV
    v[:, 12] ^= _U64(t & 0xFFFFFFFFFFFFFFFF)
    v[:, 13] ^= _U64(t >> 64)
    if last:
        v[:, 14] ^= _U64(0xFFFFFFFFFFFFFFFF)

    def G(a, b, c, d, x, y):
        v[:, a] += v[:, b] + x
        v[:, d] = _rotr(v[:, d] ^ v[:, a], 32)
        v[:, c] += v[:, d]
        v[:, b] = _rotr(v[:, b] ^ v[:, c], 24)
        v[:, a] += v[:, b] + y
        v[:, d] = _rotr(v[:, d] ^ v[:, a], 16)
        v[:, c] += v[:, d]
        v[:, b] = _rotr(v[:, b] ^ v[:, c], 63)

    for r in range(12):
        s = _SIGMA[r % 10]
        G(0, 4, 8, 12, m[:, s[0]], m[:, s[1]])
        G(1, 5, 9, 13, m[:, s[2]], m[:, s[3]])
        G(2, 6, 10, 14, m[:, s[4]], m[:, s[5]])
        G(3, 7, 11, 15, m[:, s[6]], m[:, s[7]])
        G(0, 5, 10, 15, m[:, s[8]], m[:, s[9]])
        G(1, 6, 11, 12, m[:, s[10]], m[:, s[11]])
        G(2, 7, 8, 13, m[:, s[12]], m[:, s[13]])
        G(3, 4, 9, 14, m[:, s[14]], m[:, s[15]])

    h ^= v[:, :8] ^ v[:, 8:]


def _param_words(digest_length: int, key_length: int, fanout: int,
                 depth: int, leaf_length: int, node_offset: int,
                 node_depth: int, inner_length: int) -> np.ndarray:
    block = struct.pack(
        "<BBBBIQBB14x16x16x", digest_length, key_length, fanout, depth,
        leaf_length, node_offset, node_depth, inner_length)
    return np.frombuffer(block, dtype="<u8").astype(np.uint64)


def _blocks(data: bytes) -> np.ndarray:
    """Pad to a multiple of 128 and view as (nblocks, 16) LE u64 words."""
    if len(data) == 0:
        data = b"\x00" * 128
    pad = (-len(data)) % 128
    return np.frombuffer(data + b"\x00" * pad, dtype="<u8").astype(
        np.uint64).reshape(-1, 16)


def _blake2b_single(data: bytes, key: bytes, params: np.ndarray,
                    digest_length: int) -> bytes:
    h = (_IV ^ params)[None, :].copy()
    blocks = []
    if key:
        blocks.append(_blocks(key.ljust(128, b"\x00")))
    if data or not key:
        blocks.append(_blocks(data))
    flat = np.concatenate(blocks, axis=0)
    n = flat.shape[0]
    # byte counter: full 128 per non-final block; the final block's counter
    # is the total number of real (unpadded) bytes fed
    key_len = 128 if key else 0
    total = key_len + len(data)
    for i in range(n):
        final = i == n - 1
        _compress(h, flat[i:i + 1], total if final else 128 * (i + 1), final)
    return h.tobytes()[:digest_length]


def blake2xb(outlen: int, data: bytes, key: bytes = b"") -> bytes:
    """BLAKE2xb XOF: `outlen` bytes of output for (data, key)."""
    if not 0 < outlen < 0xFFFFFFFF:
        raise ValueError("outlen out of range for blake2xb")
    xof_hi = outlen << 32
    root_params = _param_words(64, len(key), 1, 1, 0, xof_hi, 0, 0)
    root = _blake2b_single(data, key, root_params, 64)

    nfull, rem = divmod(outlen, 64)
    nodes = nfull + (1 if rem else 0)
    # Batched expansion: every node hashes the same 64-byte root message;
    # only digest_length (last node) and node_offset differ.
    offs = np.arange(nodes, dtype=np.uint64) + _U64(xof_hi & (2**64 - 1))
    params = np.tile(_param_words(64, 0, 0, 0, 64, 0, 0, 64), (nodes, 1))
    params[:, 1] = params[:, 1] ^ offs  # node_offset occupies word 1
    if rem:
        # last node's digest_length differs (low byte of word 0)
        params[nodes - 1, 0] ^= _U64(64 ^ rem)
    h = _IV[None, :] ^ params
    m = _blocks(root)
    _compress(h, m, 64, True)
    out = h.tobytes()
    if rem:
        return out[:64 * nfull] + out[64 * nfull:64 * nfull + rem]
    return out[:outlen]
