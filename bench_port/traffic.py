"""The one generator of request blocks: reads a traffic mix's parameters
(``bench_port/traffic/<name>.json``) and draws its blocks from the seed.

A block is what one validator executes at once: ``requests`` precompile
requests, each an op (add / sub / mul) on two operands named by their index
into the pool of ciphertexts held on the card.  Every block of every seed
holds exactly ``mix[op]`` requests of each op, in an order the seed draws,
so that seeds change which operands meet, never how much work a block is.
Operand pairs are drawn uniformly from the pool.  The loop is closed with one
block in flight: the next block is issued when the last one has returned.

Parameters of a mix (every key is required, no other is accepted):

``requests``          requests a block
``mix``               {"add": count, "sub": count, "mul": count}, summing
                      to ``requests``
``pool``              ciphertexts in the pool on the card

A run draws ``DISTINCT_BLOCKS`` blocks and the window cycles through them.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List

import numpy as np

OPS = ("add", "sub", "mul")
KEYS = ("requests", "mix", "pool")
DISTINCT_BLOCKS = 8
# independent random streams drawn from one seed
STREAM_BLOCKS, STREAM_POOL, STREAM_PLAINS, STREAM_SAMPLE = 1, 2, 3, 4


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's generator for one purpose; any whole seed >= 0."""
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    return np.random.default_rng([seed, stream])


def load(path: Path) -> dict:
    return validate(json.loads(Path(path).read_text()))


def validate(t: dict) -> dict:
    if set(t) != set(KEYS):
        raise ValueError(f"traffic keys {sorted(t)}, expected {sorted(KEYS)}")
    if set(t["mix"]) - set(OPS) or sum(t["mix"].values()) != t["requests"]:
        raise ValueError(f"mix {t['mix']} must count {t['requests']} "
                         f"requests of {OPS}")
    for key in ("requests", "pool"):
        if int(t[key]) < 1:
            raise ValueError(f"{key} must be at least 1")
    return t


@dataclasses.dataclass
class Block:
    ops: List[str]              # the op of each request
    idx: np.ndarray             # (requests, 2) int64 operand indices


def make_blocks(t: dict, seed: int) -> List[Block]:
    """The run's blocks: the same counts of each op in each, shuffled."""
    g = rng(seed, STREAM_BLOCKS)
    base = np.concatenate([np.full(t["mix"].get(op, 0), i)
                           for i, op in enumerate(OPS)])
    blocks = []
    for _ in range(DISTINCT_BLOCKS):
        order = g.permutation(base)
        idx = g.integers(0, t["pool"], size=(t["requests"], 2),
                         dtype=np.int64)
        blocks.append(Block([OPS[i] for i in order], idx))
    return blocks
