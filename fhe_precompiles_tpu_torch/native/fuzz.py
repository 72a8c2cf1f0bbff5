"""The coverage fuzzer over the port's C++ byte path (``precompiles.cpp``
and ``host_engine.cpp``, the code behind ``libc_fhe_cpu.so``,
``ByteServer(codec="native")`` and the mesh server's windows).

``native/fuzz_native.cpp`` is linked against the two sources compiled with
ASan, UBSan and gcc's ``-fsanitize-coverage=trace-pc`` edges
(``ops/build.py`` ``build_sanitized_objects("asan")``, shared with the ASan
drive of ``sanitize.py``) into ``_build/sanitize/fuzz_native``.  It replays
the corpus directory and the read-only seed directories (the JAX package's
``fhe_precompiles_tpu/native/fuzz_seeds/``, read in place), then mutates
for the budget, keeping each input that reaches new edges.  A sanitizer
report or a crash ends it with a non-zero exit; the input that caused it is
``<corpus>/last_input.bin``.

``make_corpus(dir)`` writes the synthesized seeds, the port's counterpart
of the JAX package's ``tools/make_fuzz_corpus.py``: the same file names and
bytes, ``[1 byte precompile index][calldata]`` in ``c_fhe.h``'s order
(valid calldata for one op of each shape family, small malformed shapes,
and the batched-codec families at selector 49 + family).

    python -m fhe_precompiles_tpu_torch.native.fuzz [SECONDS]   # default 300

is the counterpart of the JAX package's ``tools/fuzz_native.sh``: it builds,
writes the corpus into ``_build/fuzz/corpus/`` and runs, printing the
summary as one JSON line.
"""
from __future__ import annotations

import hashlib
import json
import re
import struct
import subprocess
import sys
import time
from pathlib import Path
from typing import Sequence

from .. import pack
from ..app import _CT_CODEC, PRECOMPILE_NAMES, FheApp
from ..encoding import PLAIN_TYPES
from ..ops import build as _build
from ..testnet import one

NATIVE_DIR = Path(__file__).resolve().parent
PACKAGE_DIR = NATIVE_DIR.parent
# the JAX package's coverage finds, replayed in place (never copied)
REFERENCE_SEEDS = (PACKAGE_DIR.parent / "fhe_precompiles_tpu" / "native"
                   / "fuzz_seeds")
CORPUS_DIR = _build.BUILD_DIR / "fuzz" / "corpus"
NETWORK_KEYS = (PACKAGE_DIR / "data" / "network.pub",
                PACKAGE_DIR / "data" / "network.pri")
# selector of the first batched-codec family (fuzz_native.cpp run_tpu)
TPU_SELECTOR = len(PRECOMPILE_NAMES)
LAST_INPUT = "last_input.bin"


class FuzzCrash(RuntimeError):
    """The fuzzer stopped on a sanitizer report or a crash; ``reproducer``
    is the input it was running."""

    def __init__(self, message: str, reproducer: Path):
        super().__init__(message)
        self.reproducer = reproducer


def build() -> Path:
    """Builds ``_build/sanitize/fuzz_native`` (the asan objects first)
    unless it is up to date; returns its path."""
    return _build.build_sanitized("asan", "fuzz_native.cpp")


def make_corpus(out_dir) -> list:
    """Writes the synthesized seeds into `out_dir` (made if missing);
    returns their file names.  The same names and bytes as the JAX
    package's ``tools/make_fuzz_corpus.py`` writes, apart from the copies
    of ``fuzz_seeds/`` it adds (the fuzzer reads those in place)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    app = FheApp(one.PARAMS, engine="golden")
    pk = app.public_key
    written = []

    def ct(value, tname, tag=b"fz"):
        seed = hashlib.sha512(tag + tname.encode()).digest()
        return app.ctx.encrypt(PLAIN_TYPES[tname].encode(value, app.params),
                               pk, seed)

    def write(label, body):
        name = f"seed_{label}.bin"
        (out / name).write_bytes(body)
        written.append(name)

    def write_op(name, calldata, label):
        write(label, bytes([PRECOMPILE_NAMES.index(name)]) + calldata)

    def write_tpu(family, body, label):
        write(f"tpu_{label}", bytes([TPU_SELECTOR + family]) + body)

    # valid deep-path seeds (each carries the ~400 KB network key)
    a, b = ct(4, "u64", b"a"), ct(3, "u64", b"b")
    mul_cc = pack.pack_binary_operation(pk, a, _CT_CODEC, b, _CT_CODEC)
    cp_add = pack.pack_binary_operation(pk, ct(2.5, "frac64", b"c"),
                                        _CT_CODEC, 0.25, pack.FRAC64)
    reenc = pack.pack_binary_operation(pk, a, _CT_CODEC, b"rd", pack.BYTES)
    write_op("mul_cipheru64_cipheru64", mul_cc, "valid_cc_mul")
    write_op("add_cipherfrac64_frac64", cp_add, "valid_cp_add")
    write_op("sub_i64_cipheri64",
             pack.pack_binary_operation(pk, -3, pack.I64,
                                        ct(-7, "i64", b"d"), _CT_CODEC),
             "valid_pc_sub")
    write_op("encrypt_u256",
             pack.pack_two_arguments(9, pack.U256, b"pd", pack.BYTES),
             "valid_encrypt")
    write_op("decrypt_u64", pack.pack_one_argument(a, _CT_CODEC),
             "valid_decrypt")
    write_op("reencrypt_u64", reenc, "valid_reencrypt")

    # small malformed shapes (the error-matrix corpus)
    write_op("encrypt_u64", b"\x00\x00", "trunc_offsets")
    write_op("add_cipheru64_cipheru64", b"\x00\x00\x00\x08trunc",
             "trunc_binary")
    write_op("decrypt_u64", b"\xde\xad\xbe\xef" * 10, "garbage_ct")
    write_op("reencrypt_u64", struct.pack(">I", 10_000_000) + b"\x00" * 64,
             "oversized_offset")
    write_op("encrypt_u256",
             pack.pack_two_arguments(b"\x01\x02\x03", pack.BYTES, b"x",
                                     pack.BYTES), "wrong_width_scalar")
    # SEAL header magics and a zstd frame prefix to steer the mutator
    write_op("decrypt_u64", b"\x5e\xa1\x10\x04\x00\x02\x00\x00" + b"\x00" * 32,
             "seal_header")
    write_op("decrypt_u64", b"\x28\xb5\x2f\xfd" + b"\x00" * 24, "zstd_magic")

    # the batched-codec families; a family taking a name reads input[1] as
    # the index into the harness's 36 names, (op * 4 + type) * 3 + shape
    write_tpu(0, bytes([(2 * 4 + 1) * 3 + 0]) + mul_cc, "binary_mul_cc")
    write_tpu(0, bytes([(0 * 4 + 3) * 3 + 1]) + cp_add, "binary_add_cp")
    write_tpu(1, bytes([0]) + pack.pack_two_arguments(9, pack.U256, b"pd",
                                                      pack.BYTES),
              "encrypt_u256")
    write_tpu(2, pack.pack_one_argument(a, _CT_CODEC), "decrypt")
    write_tpu(3, reenc, "reencrypt")
    write_tpu(4, bytes([1]) + reenc, "reencrypt_finish")
    write_tpu(5, bytes([1]) + b"\x00\x01\x02\x03" * 8, "decode_scalar")
    write_tpu(6, bytes([0]) + b"\x05" * 16, "pack_ct")
    return written


_REPLAYED = re.compile(r"fuzz_native: replayed (\d+) inputs from (.+)$")
_BASELINE = re.compile(r"fuzz_native: baseline coverage (\d+) edges")
_DONE = re.compile(r"fuzz_native: (\d+) iterations, (\d+) new-coverage "
                   r"inputs, (\d+) edges total, no crashes")


def run(seconds: int, *, seed: int = 0, corpus_dir=CORPUS_DIR) -> dict:
    """Builds the fuzzer, writes the synthesized seeds into `corpus_dir`
    and runs it for `seconds` with RNG seed `seed` over them, the inputs it
    found earlier in `corpus_dir` and the JAX package's ``fuzz_seeds/``
    (read-only), the library bound to the package's network keys.
    Returns the summary: inputs replayed per directory, baseline and final
    edges, iterations, new-coverage inputs, exit code and seconds.  Raises
    ``FuzzCrash`` (naming the reproducer, ``<corpus_dir>/last_input.bin``)
    if it stops on a report or a crash."""
    if not REFERENCE_SEEDS.is_dir():
        raise FileNotFoundError(f"fuzz seed directory {REFERENCE_SEEDS} is "
                                "missing")
    exe = build()
    corpus = Path(corpus_dir)
    synthesized = make_corpus(corpus)
    cmd = [str(exe), "--corpus", str(corpus), "--seeds", str(REFERENCE_SEEDS),
           "--seconds", str(int(seconds)), "--rng", str(int(seed)),
           "--keys", *map(str, NETWORK_KEYS)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=int(seconds) + 600)
    elapsed = time.perf_counter() - t0
    lines = proc.stderr.splitlines()
    done = [m for m in map(_DONE.search, lines) if m]
    reproducer = corpus / LAST_INPUT
    if proc.returncode != 0 or not done:
        raise FuzzCrash(f"fuzz_native exit {proc.returncode}; reproducer "
                        f"{reproducer}\n{proc.stderr[-6000:]}", reproducer)
    replayed = {m.group(2): int(m.group(1))
                for m in map(_REPLAYED.search, lines) if m}
    baseline = int(next(m for m in map(_BASELINE.search, lines) if m)[1])
    iterations, found, edges = map(int, done[-1].groups())
    return {"seconds_budget": int(seconds), "rng": int(seed),
            "synthesized": len(synthesized), "replayed": replayed,
            "seeds": sum(replayed.values()), "baseline_edges": baseline,
            "iterations": iterations, "new_coverage_inputs": found,
            "edges": edges, "exit_code": proc.returncode,
            "seconds": elapsed}


def main(argv: Sequence[str]) -> int:
    seconds = int(argv[0]) if argv else 300
    print(json.dumps(run(seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
