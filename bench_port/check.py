"""The comparison that decides ``correct``.

A run keeps, from a sample of the window's blocks that its seed draws, the
results of a sample of each op's requests that the seed draws too (see
``harness.Reservoir``).  Once the window has closed, the reference works
each sampled request out again from the raw inputs (the pool entries as
sums of fresh encryptions and, for a plain op, the plaintext pool's entry;
then the golden add, sub, multiply with relinearization, add_plain,
sub_plain, plain_sub or mul_plain) and counts the 64-bit words of the
program's result that differ from it.  A result that is missing, or has
another shape, counts all its words.  The comparison is exact: its limit is
0.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict, List, Optional

import numpy as np

from .inputs import Inputs
from .reference.control import (add_sub_plain_floor, mul_plain_centred,
                                mul_relin_floor)
from .reference.golden import Ciphertext
from .traffic import PLAIN_OPS

LIMITS = {"word_mismatches": 0}


@dataclasses.dataclass
class Sample:
    block: int                  # the block's position in the window
    op: str                     # the op the request asked for
    request: int                # the request's index in its block
    a: int                      # its operands' pool indices (for a plain
    b: int                      # op, b indexes the plaintext pool)
    got: Optional[np.ndarray]   # the program's (2, k, n) uint64 result


class Reference:
    """The reference's results, with the pool entries it forms cached."""

    def __init__(self, inp: Inputs):
        self.inp = inp
        self._entries: Dict[int, Ciphertext] = {}

    def entry(self, j: int) -> Ciphertext:
        if j not in self._entries:
            self._entries[j] = Ciphertext(self.inp.ctx.params,
                                          self.inp.pool_entry(j))
        return self._entries[j]

    def result(self, s: Sample) -> np.ndarray:
        ctx = self.inp.ctx
        if s.op in PLAIN_OPS:
            a, m = self.entry(s.a), self.inp.plain_pool[s.b]
            if s.op == "plain_sub":
                return ctx.plain_sub(m, a).data
            return getattr(ctx, s.op)(a, m).data
        a, b = self.entry(s.a), self.entry(s.b)
        if s.op == "add":
            return ctx.add(a, b).data
        if s.op == "sub":
            return ctx.sub(a, b).data
        if s.op == "mul":
            return ctx.mul_relin(a, b, self.inp.pk.relin).data
        raise ValueError(f"unknown op {s.op!r}")

    def control(self, s: Sample) -> np.ndarray:
        """The control's result (``reference/control.py``): the reference
        with relinearization's division by P rounded down, the plaintext
        scaled rounding down in add_plain, sub_plain and plain_sub, and
        lifted centred in mul_plain; add and sub as the reference."""
        ctx = self.inp.ctx
        if s.op == "mul":
            return mul_relin_floor(ctx, self.entry(s.a), self.entry(s.b),
                                   self.inp.pk.relin).data
        if s.op == "mul_plain":
            return mul_plain_centred(ctx, self.entry(s.a),
                                     self.inp.plain_pool[s.b]).data
        if s.op in PLAIN_OPS:
            return add_sub_plain_floor(ctx, s.op, self.entry(s.a),
                                       self.inp.plain_pool[s.b]).data
        return self.result(s)


def compare(ref: Reference, samples: List[Sample],
            got_of: Optional[Callable[[Sample], np.ndarray]] = None) -> dict:
    """{"word_mismatches": words that differ, "results_compared": count};
    `got_of` stands another producer in for the program's results."""
    bad = 0
    for s in samples:
        want = ref.result(s)
        got = s.got if got_of is None else got_of(s)
        if got is None or got.shape != want.shape:
            bad += want.size
        else:
            bad += int(np.count_nonzero(got != want))
    return {"word_mismatches": bad, "results_compared": len(samples)}


def checks_line(numbers: dict) -> dict:
    """Each compared number beside its limit, for the result's last key."""
    return {name: {"value": numbers[name], "limit": limit}
            for name, limit in LIMITS.items()}


def within_limits(numbers: dict) -> bool:
    return all(numbers[name] <= limit for name, limit in LIMITS.items())


def print_checks(numbers: dict) -> None:
    """The compared numbers as the last lines on standard error."""
    print(f"check: {numbers['results_compared']} results compared",
          file=sys.stderr)
    for name, limit in LIMITS.items():
        print(f"check: {name} {numbers[name]} limit {limit}",
              file=sys.stderr)
