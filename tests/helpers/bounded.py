"""A child process with a time limit that fails the test by name.

A hang in a child process would otherwise hold its worker until the whole
run's clock stops it, and no test would be named. With ``run`` the test
fails when its own limit passes, with the tail of what the child printed.
"""
import subprocess

import pytest

TAIL = 4000


def tail(out):
    """The last TAIL characters of a child's partial output (bytes on a
    timeout even where the call asked for text; None where not captured)."""
    if out is None:
        return ""
    if isinstance(out, bytes):
        out = out.decode(errors="replace")
    return out[-TAIL:]


def run(args, timeout, **kwargs):
    """``subprocess.run(args, timeout=timeout, **kwargs)``; on a timeout the
    child is killed and the test fails with its stdout and stderr tails."""
    try:
        return subprocess.run(args, timeout=timeout, **kwargs)
    except subprocess.TimeoutExpired as e:
        out, err = e.stdout, e.stderr
    pytest.fail(f"{str(args)[:200]} timed out after {timeout} s\n"
                f"--- stdout tail ---\n{tail(out)}\n"
                f"--- stderr tail ---\n{tail(err)}", pytrace=False)
