"""The one generator of request blocks: reads a traffic mix's parameters
(``bench_port/traffic/<name>.json``) and draws its blocks from the seed.

A block is what one validator executes at once: ``requests`` precompile
requests, each an op on two operands named by their index into pools held
on the card.  The cipher∘cipher ops (add / sub / mul) take both operands
from the pool of ciphertexts.  The cipher∘plain ops take a ciphertext and a
plaintext: ``add_plain``, ``sub_plain`` and ``mul_plain`` compute
ciphertext ∘ plaintext, ``plain_sub`` plaintext − ciphertext (the names of
``serve.py``, where add and mul on plain∘cipher run as ``add_plain`` and
``mul_plain``).  For a plain op, ``idx[r, 0]`` indexes the ciphertext pool
and ``idx[r, 1]`` the plaintext pool.

Every block of every seed holds exactly ``mix[op]`` requests of each op, in
an order the seed draws, so that seeds change which operands meet, never how
much work a block is.  Operands are drawn uniformly from their pools; the
plaintext indices from a stream of their own, drawn only for a mix that has
plain ops, so that a mix without them draws what it drew before they came.
The loop is closed with one block in flight: the next block is issued when
the last one has returned.

Parameters of a mix (the first three required; no other key is accepted):

``requests``          requests a block
``mix``               {op: count} over ``OPS``, summing to ``requests``
``pool``              ciphertexts in the pool on the card
``plain_pool``        plaintexts in the pool on the card: required where the
                      mix counts a plain op, refused where it does not

A run draws ``DISTINCT_BLOCKS`` blocks and the window cycles through them.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List

import numpy as np

# new ops go after the old: a block's op codes index this tuple
OPS = ("add", "sub", "mul", "add_plain", "sub_plain", "plain_sub",
       "mul_plain")
PLAIN_OPS = OPS[3:]
KEYS = ("requests", "mix", "pool")
OPTIONAL_KEYS = ("plain_pool",)
DISTINCT_BLOCKS = 8
# independent random streams drawn from one seed
(STREAM_BLOCKS, STREAM_POOL, STREAM_PLAINS, STREAM_SAMPLE,
 STREAM_PLAIN_IDX, STREAM_PLAIN_POOL) = 1, 2, 3, 4, 5, 6


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's generator for one purpose; any whole seed >= 0."""
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    return np.random.default_rng([seed, stream])


def load(path: Path) -> dict:
    return validate(json.loads(Path(path).read_text()))


def has_plain(t: dict) -> bool:
    """Whether the mix counts a plain op."""
    return any(t["mix"].get(op, 0) for op in PLAIN_OPS)


def validate(t: dict) -> dict:
    if not set(KEYS) <= set(t) <= set(KEYS + OPTIONAL_KEYS):
        raise ValueError(f"traffic keys {sorted(t)}, expected {sorted(KEYS)}"
                         f" and optionally {list(OPTIONAL_KEYS)}")
    if set(t["mix"]) - set(OPS) or sum(t["mix"].values()) != t["requests"]:
        raise ValueError(f"mix {t['mix']} must count {t['requests']} "
                         f"requests of {OPS}")
    if has_plain(t) != ("plain_pool" in t):
        raise ValueError("plain_pool is required where the mix counts a "
                         f"plain op {PLAIN_OPS}, and refused elsewhere")
    for key in ("requests", "pool", "plain_pool"):
        if key in t and int(t[key]) < 1:
            raise ValueError(f"{key} must be at least 1")
    return t


@dataclasses.dataclass
class Block:
    ops: List[str]              # the op of each request
    idx: np.ndarray             # (requests, 2) int64 operand indices


def make_blocks(t: dict, seed: int) -> List[Block]:
    """The run's blocks: the same counts of each op in each, shuffled."""
    g = rng(seed, STREAM_BLOCKS)
    g_plain = rng(seed, STREAM_PLAIN_IDX) if has_plain(t) else None
    base = np.concatenate([np.full(t["mix"].get(op, 0), i)
                           for i, op in enumerate(OPS)])
    blocks = []
    for _ in range(DISTINCT_BLOCKS):
        order = g.permutation(base)
        idx = g.integers(0, t["pool"], size=(t["requests"], 2),
                         dtype=np.int64)
        if g_plain is not None:
            plain = np.isin(order, [OPS.index(op) for op in PLAIN_OPS])
            idx[plain, 1] = g_plain.integers(
                0, t["plain_pool"], size=int(plain.sum()), dtype=np.int64)
        blocks.append(Block([OPS[i] for i in order], idx))
    return blocks
