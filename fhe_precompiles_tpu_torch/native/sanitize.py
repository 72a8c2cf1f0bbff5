"""The sanitizer drives over the port's C++ byte path, the counterpart of
the JAX package's ``tools/sanitize_native.sh``.

Both drives are C programs linked against ``precompiles.cpp`` and
``host_engine.cpp`` compiled with a sanitizer (``ops/build.py``
``build_sanitized``); no Python runs inside a sanitized process, and the
sanitizer options are compiled into each driver.  Python writes a case file
(``native/sanitize_cases.h`` says its layout): each case is a call, its
input, and the code and bytes that the port's ``FheApp`` given as `app`
returns for it (its golden model on the CPU; ``chip_smoke.py`` passes the
torch app on the card, so that the drive holds the C++ on the CPU against
the card).

* **(a) ASan + UBSan** (``sanitize_driver.c``, ``drive_asan``): the 49
  precompiles, seven malformed inputs, and ciphertexts of sizes 1, 2, 3 and
  5 added to and subtracted from each other (SEAL's zero extension), all
  through the ``c_fhe_*`` symbols; then the ``fhe_tpu_*`` codec calls that
  ``ByteServer(codec="native")`` makes on the same inputs (unpack, key
  handles, the re-encrypt finish, scalar decode, ciphertext pack), each
  against the python codecs.  One process a parameter set, its keys handed
  in through ``fhe_tpu_init_keys``: the host engine is reached through the
  byte path on ``testnet.one``, ``bench.n8192`` and ``bench.n1024``.
* **(b) TSan** (``tsan_driver.c``, ``drive_tsan``): four threads over the
  case file's calls, then four batched-codec workers on one shared key with
  a ``fhe_tpu_use_libzstd`` swapper beside them; the linked
  ``libzstd.so.1`` comes in by path (``zstd_codec.library_path``).

``libc_fhe.so``, the card's shim, embeds CPython and stays out of both: ASan
inside CPython is fragile and TSan does not mix with it.

    python -m fhe_precompiles_tpu_torch.native.sanitize    # all presets

runs both drives on the golden model and prints one JSON line.
"""
from __future__ import annotations

import hashlib
import json
import struct
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .. import pack
from ..app import _CT_CODEC, _PK_CODEC, ENCRYPT_PRIVATE_CONSTANT, FheApp
from ..bfv.golden import BfvContext, Ciphertext
from ..encoding import PLAIN_TYPES
from ..ops import build as _build
from ..params import PRESETS
from ..serialization import keyio, zstd_codec

WORK_DIR = _build.SANITIZE_DIR / "drives"
TYPES = ("u256", "u64", "i64", "frac64")
SCALARS = {"u256": pack.U256, "u64": pack.U64, "i64": pack.I64,
           "frac64": pack.FRAC64}
V1 = {"u256": 16, "u64": 16, "i64": -16, "frac64": 2.5}
V2 = {"u256": 4, "u64": 4, "i64": 4, "frac64": -0.25}
MISMATCH_SIZES = (1, 2, 3, 5)
SHAPES = {"cc": 0, "cp": 1, "pc": 2}
OPS = {"add": 0, "sub": 1, "mul": 2}
(CALL, UNPACK_BINARY, UNPACK_ENCRYPT, UNPACK_DECRYPT, UNPACK_REENCRYPT,
 REENCRYPT_FINISH, DECODE_SCALAR, PACK_CIPHERTEXT) = range(8)
PRESET_NAMES = ("testnet.one", "bench.n8192", "bench.n1024")


class SanitizerFailure(RuntimeError):
    """A drive stopped on a sanitizer report, a crash or a difference."""


def preset_app(name: str, **kw) -> FheApp:
    """The ``FheApp`` of preset `name`, `kw` (``engine``, ``device``) passed
    on with ``FheApp``'s defaults: ``testnet.one`` with the package's
    network keys, a bench preset with keys made from a seed of its name."""
    params = PRESETS[name]
    if name == "testnet.one":
        return FheApp(params, **kw)
    pk, sk = BfvContext(params).generate_keys(
        seed=hashlib.sha512(name.encode()).digest())
    return FheApp(params, keyio.save_public_key(pk),
                  keyio.save_private_key(sk), **kw)


def _u64(arr) -> bytes:
    return np.ascontiguousarray(arr, dtype=np.uint64).tobytes()


class _Cases:
    def __init__(self, app: FheApp):
        self.app = app
        self.records = []

    def add(self, kind: int, name: str = "", data: bytes = b"",
            aux: bytes = b"", want: int = 0, outs=()) -> None:
        self.records.append((kind, name, data, aux, want, tuple(outs)))

    def call(self, name: str, data: bytes):
        """A CALL case with the app's answer; returns that answer."""
        code, out = self.app.call(name, data)
        self.add(CALL, name, data, want=code, outs=(out,) if code == 0 else ())
        return code, out

    def write(self, path: Path) -> None:
        p = self.app.params
        body = [b"FHECASES", struct.pack("<IQQQQI", 1, p.n, len(p.ct_moduli),
                                         len(p.key_moduli), p.t,
                                         len(self.records))]
        for kind, name, data, aux, want, outs in self.records:
            nb = name.encode()
            body += [struct.pack("<II", kind, len(nb)), nb,
                     struct.pack("<Q", len(data)), data,
                     struct.pack("<Q", len(aux)), aux,
                     struct.pack("<iI", want, len(outs))]
            for o in outs:
                body += [struct.pack("<Q", len(o)), o]
        path.write_bytes(b"".join(body))

    def by_kind(self) -> dict:
        names = ("call", "unpack_binary", "unpack_encrypt", "unpack_decrypt",
                 "unpack_reencrypt", "reencrypt_finish", "decode_scalar",
                 "pack_ciphertext")
        return {n: sum(r[0] == k for r in self.records)
                for k, n in enumerate(names)}


def _pk_blob(data: bytes) -> bytes:
    """The key's bytes in binary-op framing ([off1][off2][pk][a][b])."""
    return data[8:struct.unpack(">I", data[:4])[0]]


def _digest(blob: bytes) -> bytes:
    return hashlib.blake2b(blob, digest_size=32).digest()


def make_cases(app: FheApp) -> _Cases:
    """Every case of drive (a) for `app`'s parameter set, the expected
    codes and bytes from `app` (``FheApp.call``) and, for the codec calls,
    from the python codecs and the golden model."""
    P, ctx = app.params, app.ctx
    cases = _Cases(app)
    upk, _usk = ctx.generate_keys(seed=b"\x5a" * 64)

    def ct(v, t, tag):
        seed = hashlib.sha512(tag + t.encode()).digest()
        return ctx.encrypt(PLAIN_TYPES[t].encode(v, P), app.public_key, seed)

    def packable(code, out):
        if code == 0:
            c = _CT_CODEC.deserialize(out)
            cases.add(PACK_CIPHERTEXT, aux=_u64(c.data), outs=(out,))

    # the 49 precompiles, and the codec calls on the same inputs
    for t in TYPES:
        c = f"cipher{t}"
        a, b = ct(V1[t], t, b"a"), ct(V2[t], t, b"b")
        for op in OPS:
            for shape, name, args in (
                    ("cc", f"{op}_{c}_{c}", (a, _CT_CODEC, b, _CT_CODEC)),
                    ("cp", f"{op}_{c}_{t}", (a, _CT_CODEC, V2[t], SCALARS[t])),
                    ("pc", f"{op}_{t}_{c}", (V1[t], SCALARS[t], b,
                                             _CT_CODEC))):
                data = pack.pack_binary_operation(app.public_key, *args)
                packable(*cases.call(name, data))
                pk = app.public_key
                if shape == "cc":
                    want_ct, other = a.data, _u64(b.data)
                    if op == "mul" and pk.relin is None:
                        cases.add(UNPACK_BINARY, name, data, want=7)
                        continue
                else:
                    want_ct = a.data if shape == "cp" else b.data
                    value = V2[t] if shape == "cp" else V1[t]
                    other = _u64(PLAIN_TYPES[t].encode(value, P))
                meta = struct.pack("<iiQQ", SHAPES[shape], OPS[op], 2,
                                   2 if shape == "cc" else 0)
                relin = b"" if pk.relin is None else _u64(pk.relin.data)
                cases.add(UNPACK_BINARY, name, data, outs=(
                    meta, _u64(want_ct), other,
                    _digest(_pk_blob(data)), relin, _u64(pk.data)))
    for t in TYPES:
        ptype, scalar = PLAIN_TYPES[t], SCALARS[t]
        data = pack.pack_two_arguments(V1[t], scalar, b"pd", pack.BYTES)
        packable(*cases.call(f"encrypt_{t}", data))
        seed = hashlib.sha512(b"pd" + ENCRYPT_PRIVATE_CONSTANT
                              + scalar.serialize(V1[t])).digest()
        cases.add(UNPACK_ENCRYPT, t, data,
                  outs=(_u64(ptype.encode(V1[t], P)), seed))

        x = ct(V1[t], t, b"s")
        poly = ctx.decrypt(x, app.private_key)
        data = pack.pack_one_argument(x, _CT_CODEC)
        code, out = cases.call(f"decrypt_{t}", data)
        cases.add(UNPACK_DECRYPT, data=data,
                  outs=(struct.pack("<Q", 2), _u64(x.data)))
        cases.add(DECODE_SCALAR, t, aux=_u64(poly), want=code,
                  outs=(out,) if code == 0 else ())

        data = pack.pack_binary_operation(upk, x, _CT_CODEC, b"rd", pack.BYTES)
        packable(*cases.call(f"reencrypt_{t}", data))
        cases.add(UNPACK_REENCRYPT, data=data, outs=(
            struct.pack("<Q", 2), _u64(x.data), _digest(_pk_blob(data)),
            _u64(upk.data)))
        value = ptype.decode(poly, P)
        seed = hashlib.sha512(b"rd" + data + scalar.serialize(value)).digest()
        cases.add(REENCRYPT_FINISH, t, data, aux=_u64(poly),
                  outs=(_u64(ptype.encode(value, P)), seed))
    cases.call("public_key_bytes", b"")

    # malformed inputs: every parser branch, through the one-shot calls and
    # the codec's unpacks (the same codes)
    good = pack.pack_binary_operation(app.public_key, ct(3, "u64", b"e"),
                                      _CT_CODEC, ct(3, "u64", b"f"),
                                      _CT_CODEC)
    for name, data in [
            ("add_cipheru64_cipheru64", b""),
            ("add_cipheru64_cipheru64", b"\x00\x00\x00"),
            ("add_cipheru64_cipheru64", struct.pack(">II", 9, 8)
             + b"\x00" * 64),
            ("encrypt_u64", struct.pack(">I", 10_000_000) + b"\x00" * 64),
            ("decrypt_u64", b"\xde\xad" * 40),
            ("decrypt_frac64", b"\x00" * 200),
            ("reencrypt_u64", struct.pack(">II", 8, 8)),
            ("mul_cipheru64_cipheru64", good[:-9])]:
        code, _ = cases.call(name, data)
        if code == 0:
            raise AssertionError(f"malformed {name} input accepted")
        for uname in ("mul_cipheru64_cipheru64", "add_cipheru64_u64"):
            cases.add(UNPACK_BINARY, uname, data,
                      want=app.call(uname, data)[0])
        cases.add(UNPACK_DECRYPT, data=data,
                  want=app.call("decrypt_u64", data)[0])

    # mismatched component counts: SEAL zero extension in add/sub
    rng = np.random.default_rng(1)
    k, n = len(P.ct_moduli), P.n

    def randct(size):
        d = np.zeros((size, k, n), dtype=np.uint64)
        for j, p in enumerate(P.ct_moduli):
            d[:, j] = rng.integers(0, p, size=(size, n), dtype=np.uint64)
        return Ciphertext(P, d)

    for sa in MISMATCH_SIZES:
        for sb in MISMATCH_SIZES:
            data = pack.pack_binary_operation(app.public_key, randct(sa),
                                              _CT_CODEC, randct(sb),
                                              _CT_CODEC)
            for name in ("add_cipheru64_cipheru64",
                         "sub_cipheru64_cipheru64"):
                packable(*cases.call(name, data))
    return cases


def _key_files(app: FheApp, work: Path) -> list:
    paths = [work / "network.pub", work / "network.pri"]
    paths[0].write_bytes(app.public_key_bytes())
    paths[1].write_bytes(keyio.save_private_key(app.private_key))
    return paths


def _run(cmd: list, label: str, marker: str, limit_s: float) -> tuple:
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=limit_s)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0 or marker not in proc.stdout:
        raise SanitizerFailure(f"{label}: exit {proc.returncode}\n"
                               f"{proc.stdout[-3000:]}\n"
                               f"{proc.stderr[-6000:]}")
    return proc.stdout.strip().splitlines(), seconds


def drive_asan(app: FheApp, work_dir, cases: Optional[_Cases] = None
               ) -> dict:
    """Drive (a) for `app`'s parameter set in `work_dir` (made if
    missing): builds the ASan driver, writes the keys and the cases
    (``make_cases(app)`` unless `cases` is given) and runs them.  Returns
    the cases by kind and the seconds; raises ``SanitizerFailure``."""
    exe = _build.build_sanitized("asan", "sanitize_driver.c",
                                 ("sanitize_cases.h",))
    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    cases = cases if cases is not None else make_cases(app)
    cases.write(work / "cases.bin")
    cases_s = time.perf_counter() - t0
    keys = _key_files(app, work)
    lines, seconds = _run([str(exe), "--keys", *map(str, keys), "--cases",
                           str(work / "cases.bin")], "ASan drive",
                          "ASAN DRIVE PASSED", 900)
    return {"n": app.params.n, "cases": len(cases.records),
            "by_kind": cases.by_kind(), "cases_s": cases_s,
            "seconds": seconds, "ok": True}


def drive_tsan(app: FheApp, work_dir, cases: Optional[_Cases] = None
               ) -> dict:
    """Drive (b) for `app`'s parameter set in `work_dir`: builds the TSan
    driver and runs the case file's calls on four threads, then the
    batched-codec workers beside the zstd swapper.  Returns the output
    lines and the seconds; raises ``SanitizerFailure``."""
    exe = _build.build_sanitized("tsan", "tsan_driver.c",
                                 ("sanitize_cases.h",))
    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    cases = cases if cases is not None else make_cases(app)
    cases.write(work / "cases.bin")
    keys = _key_files(app, work)
    zstd = zstd_codec.library_path()
    lines, seconds = _run([str(exe), "--keys", *map(str, keys), "--cases",
                           str(work / "cases.bin"), "--zstd", zstd],
                          "TSan drive", "TSAN DRIVE PASSED", 900)
    return {"n": app.params.n, "calls": cases.by_kind()["call"],
            "zstd": zstd, "lines": lines, "seconds": seconds, "ok": True}


def run_all(apps: Optional[dict] = None, work_dir=WORK_DIR) -> dict:
    """Drive (a) on every app of `apps` (preset name -> ``FheApp``;
    default: the golden app of each of ``PRESET_NAMES``) and drive (b) on
    the testnet.one app.  Returns each drive's record."""
    if apps is None:
        apps = {name: preset_app(name) for name in PRESET_NAMES}
    work = Path(work_dir)
    out = {"asan": {}, "tsan": None}
    one_cases = None
    for name, app in apps.items():
        cases = make_cases(app)
        if name == "testnet.one":
            one_cases = cases
        out["asan"][name] = drive_asan(app, work / name, cases)
    out["tsan"] = drive_tsan(apps["testnet.one"], work / "tsan", one_cases)
    return out


def main(argv: Sequence[str]) -> int:
    names = list(argv) or list(PRESET_NAMES)
    print(json.dumps(run_all({n: preset_app(n) for n in names})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
