"""The port's multi-device layer against the JAX package's, in a gloo world
of four CPU ranks.

``parallel.multihost`` (rendezvous from arguments only), ``parallel.mesh``,
``parallel.dist_ntt``, ``parallel.pipeline``, ``RequestStream`` over a
mesh and ``ByteServer(mesh=...)``.  The in-process tests need no world.
The others share one world for the module: four rank processes, started
once, each running this file as a script (``_rank_main``), which imports
the port only; the JAX imports stay inside the parent's fixtures.  The
ranks meet through ``multihost.initialize`` at a free localhost port and
write their results under a temporary directory; the parent compares
them, every word and byte (tolerance 0), with the port on one process and
with the JAX package on its 8 virtual CPU devices (``conftest.py``).  The
world has a time limit of its own (``WORLD_LIMIT_S``); on expiry its ranks
are killed and the tests fail.

Run a rank by hand: ``python tests/test_torch_parallel.py <rank>
<host:port> <directory>`` (the directory holding the parent's inputs).
"""
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
import types

import numpy as np
import pytest
torch = pytest.importorskip("torch")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:           # run as a script: the rank processes
    sys.path.insert(0, _REPO)

from fhe_precompiles_tpu_torch import FheApp, pack  # noqa: E402
from fhe_precompiles_tpu_torch.app import (_CT_CODEC,  # noqa: E402
                                           _CachedPkCodec)
from fhe_precompiles_tpu_torch.bfv.golden import BfvContext  # noqa: E402
from fhe_precompiles_tpu_torch.encoding import (PLAIN_TYPES,  # noqa: E402
                                                encode_unsigned)
from fhe_precompiles_tpu_torch.ops.engine import TorchEngine  # noqa: E402
from fhe_precompiles_tpu_torch.ops.ntt import build_tables  # noqa: E402
from fhe_precompiles_tpu_torch.parallel import (  # noqa: E402
    Request, RequestStream, bucket_batch, make_mesh, shard_ct_batch)
from fhe_precompiles_tpu_torch.parallel import multihost  # noqa: E402
from fhe_precompiles_tpu_torch.parallel.dist_ntt import (  # noqa: E402
    make_distributed_ntt, shard_coeff_axis)
from fhe_precompiles_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh, RankFault, checked)
from fhe_precompiles_tpu_torch.parallel.pipeline import (  # noqa: E402
    pipeline_chain)
from fhe_precompiles_tpu_torch.params import (Params,  # noqa: E402
                                              TESTNET_ONE)
from fhe_precompiles_tpu_torch.serve import ByteServer  # noqa: E402

WORLD = 4
WORLD_LIMIT_S = 240
# tests/test_parallel.py's ring, and tests/test_pipeline.py's
SMALL = Params(poly_modulus_degree=256,
               coeff_modulus=(0xFFFFEE001, 0xFFFFC4001, 0x1FFFFE0001),
               plain_modulus=4096)
PIPE = Params(poly_modulus_degree=512,
              coeff_modulus=TESTNET_ONE.coeff_modulus, plain_modulus=4096)
STREAM_MAX_BATCH = 8        # so that batches are cut and padded
FAULT_RANK = 1              # whose _mul_relin raises in the fault run
PIPE_M = 6
# (name, moduli, n, leading dims): tests/test_dist_ntt.py's moduli at
# n = 512, and testnet.one's q u Bsk at n = 4096
NTT_CASES = {
    "n512": ([0xFFFFEE001, 0xFFFFC4001, 0x1FFFFE0001], 512, ()),
    "n4096": ([68719403009, 68719230977, 137438814209, 137438773249,
               137438691329], 4096, (3,)),
}
NTT_MESHES = {4: {"sp": 4}, 2: {"dp": 2, "sp": 2}}
STREAM_MESHES = {"dp2tp2": (2, 2, True), "dp4tp1": (4, 1, False)}


def _ntt_inputs(case: str):
    """(a, b): two (..., L, n) uint64 arrays of canonical residues."""
    mods, n, lead = NTT_CASES[case]
    rng = np.random.default_rng(len(case) + n)
    return tuple(np.stack([rng.integers(0, p, size=lead + (n,),
                                        dtype=np.uint64) for p in mods],
                          axis=-2) for _ in range(2))


def _relin_view(rk: np.ndarray):
    """What ``RequestStream.run`` reads of a public key: ``relin.data``."""
    return types.SimpleNamespace(relin=types.SimpleNamespace(data=rk))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ======================================================================
# one rank of the world (this file run as a script)
# ======================================================================
def _rank_main(rank: int, address: str, root: str) -> None:
    # four ranks share the host with the parent's references: one thread each
    torch.set_num_threads(1)
    multihost.initialize(address, WORLD, rank, device="cpu")
    # every rank builds every mesh, in this order
    ntt_meshes = {d: Mesh(shape, device="cpu")
                  for d, shape in NTT_MESHES.items()}
    stream_meshes = {name: make_mesh(dp, tp, device="cpu")
                     for name, (dp, tp, _) in STREAM_MESHES.items()}
    pp = Mesh({"pp": WORLD}, device="cpu")

    out = {}
    for case in NTT_CASES:
        mods, n, _ = NTT_CASES[case]
        a, b = _ntt_inputs(case)
        tb = build_tables(mods, n, "cpu")
        for d, mesh in ntt_meshes.items():
            fwd, inv = make_distributed_ntt(tb, mesh)
            y = fwd(shard_coeff_axis(a, mesh))
            out[f"ntt_{case}_{d}_fwd"] = y
            out[f"ntt_{case}_{d}_rt"] = inv(y)
            out[f"ntt_{case}_{d}_inv"] = inv(shard_coeff_axis(b, mesh))

    st = np.load(os.path.join(root, "stream.npz"))
    eng = TorchEngine(SMALL, device="cpu")
    reqs = [Request(str(op), a, b)
            for op, a, b in zip(st["ops"], st["a"], st["b"])]
    for name, (_dp, _tp, limbs) in STREAM_MESHES.items():
        res = RequestStream(eng, mesh=stream_meshes[name], shard_limbs=limbs,
                            max_batch=STREAM_MAX_BATCH).run(
                                reqs, _relin_view(st["rk"]))
        out[f"stream_{name}"] = torch.from_numpy(
            np.stack(res).view(np.int64))

    pl = np.load(os.path.join(root, "pipeline.npz"))
    eng_p = TorchEngine(PIPE, device="cpu")
    rk = torch.from_numpy(pl["rk"].view(np.int64))
    out["pipeline"] = pipeline_chain(
        lambda x, key: eng_p._mul_relin(x, x, key), pp,
        torch.from_numpy(pl["mbs"].view(np.int64)), rk)
    np.savez(os.path.join(root, f"rank{rank}.npz"),
             **{k: v.numpy() for k, v in out.items()})

    with open(os.path.join(root, "serve.json")) as f:
        serve_reqs = [(name, bytes.fromhex(h)) for name, h in json.load(f)]
    app = FheApp(TESTNET_ONE, engine="torch", device="cpu")
    served = {}
    for codec in ("python", "native"):
        with ByteServer(TESTNET_ONE, mesh=stream_meshes["dp4tp1"], app=app,
                        codec=codec, workers=2) as server:
            served[codec] = [(code, payload.hex())
                             for code, payload in server.run(serve_reqs)]

    # a device fault on rank FAULT_RANK alone: every rank's run raises, and
    # the ranks stay in step (the next run gives the bytes)
    eng = app._engine
    with ByteServer(TESTNET_ONE, mesh=stream_meshes["dp4tp1"], app=app,
                    workers=2) as server:
        if rank == FAULT_RANK:
            def broken(*args):
                raise RuntimeError("device fault")
            eng._mul_relin = broken
        try:
            served["fault"] = [(code, payload.hex()) for code, payload
                               in server.run(serve_reqs)]
        except RankFault as exc:
            served["fault"] = repr(exc.__cause__)
        finally:
            eng.__dict__.pop("_mul_relin", None)
        served["after_fault"] = [(code, payload.hex()) for code, payload
                                 in server.run(serve_reqs)]
    with open(os.path.join(root, f"rank{rank}_serve.json"), "w") as f:
        json.dump(served, f)
    torch.distributed.destroy_process_group()


# ======================================================================
# the parent: inputs, the world, the references
# ======================================================================
class _World:
    """Four rank processes of this file; ``wait`` collects them."""

    def __init__(self, root: str):
        self.root = root
        address = f"127.0.0.1:{_free_port()}"
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
        self.logs = [open(os.path.join(root, f"rank{r}.log"), "w")
                     for r in range(WORLD)]
        self.t0 = time.monotonic()
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), address,
             root], env=env, cwd=_REPO, stdout=log,
            stderr=subprocess.STDOUT) for r, log in enumerate(self.logs)]
        self.seconds = None

    def _tails(self) -> str:
        text = []
        for r in range(WORLD):
            with open(os.path.join(self.root, f"rank{r}.log")) as f:
                text.append(f"--- rank {r}:\n" + f.read()[-3000:])
        return "\n".join(text)

    def wait(self) -> str:
        if self.seconds is None:
            try:
                for p in self.procs:
                    left = self.t0 + WORLD_LIMIT_S - time.monotonic()
                    p.wait(timeout=max(left, 0.1))
            except subprocess.TimeoutExpired:
                self.kill()
                pytest.fail(f"the world ran past {WORLD_LIMIT_S} s\n"
                            + self._tails())
            self.seconds = time.monotonic() - self.t0
        bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:
            pytest.fail(f"ranks {bad} failed\n" + self._tails())
        return self.root

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait(timeout=30)
        for log in self.logs:
            log.close()


def _write_inputs(root: str) -> dict:
    """The ranks' inputs, made by the port's golden model; returned for the
    references too."""
    ctx = BfvContext(SMALL)
    pk, _sk = ctx.generate_keys(seed=b"\xa1" * 64)
    cts = [ctx.encrypt(encode_unsigned(v, SMALL, 64), pk, bytes([v]) * 64)
           for v in (2, 3, 4, 5)]
    eng = TorchEngine(SMALL, device="cpu", golden=ctx)
    reqs = RequestStream(eng).make_mixed_requests(cts, 24, seed=7)
    np.savez(os.path.join(root, "stream.npz"),
             ops=np.array([r.op for r in reqs]),
             a=np.stack([r.a for r in reqs]),
             b=np.stack([r.b for r in reqs]), rk=pk.relin.data)

    pctx = BfvContext(PIPE)
    ppk, _ = pctx.generate_keys(seed=b"\x21" * 64)
    mbs = np.stack([pctx.encrypt(PLAIN_TYPES["u64"].encode(2, PIPE), ppk,
                                 bytes([m + 1]) * 64).data[None]
                    for m in range(PIPE_M)])          # (M, 1, 2, k, n)
    np.savez(os.path.join(root, "pipeline.npz"), mbs=mbs,
             rk=ppk.relin.data)

    # tests/test_serve.py's six requests on testnet.one
    octx = BfvContext(TESTNET_ONE)
    upk, _ = octx.generate_keys(seed=b"\x51" * 64)

    def ct(value, tag):
        return octx.encrypt(PLAIN_TYPES["u64"].encode(value, TESTNET_ONE),
                            upk, hashlib.sha512(tag).digest())
    a, b = ct(5, b"m1"), ct(3, b"m2")
    serve = [(f"{op}_cipheru64_cipheru64",
              pack.pack_binary_operation(upk, a, _CT_CODEC, b, _CT_CODEC))
             for op in ("mul", "add", "mul", "sub", "mul")]
    serve.append(("encrypt_u64", pack.pack_two_arguments(
        8, pack.U64, b"mm", pack.BYTES)))
    with open(os.path.join(root, "serve.json"), "w") as f:
        json.dump([(name, data.hex()) for name, data in serve], f)
    return {"eng": eng, "reqs": reqs,
            "rk": pk.relin.data, "pipe_mbs": mbs, "pipe_rk": ppk.relin.data,
            "serve": serve}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Starts the world (the native codec built first, so that no rank
    builds it); yields (world, inputs)."""
    from fhe_precompiles_tpu_torch.ops import build
    root = str(tmp_path_factory.mktemp("world"))
    inputs = _write_inputs(root)
    build.build_native_codec()
    w = _World(root)
    try:
        yield w, inputs
    finally:
        w.kill()


@pytest.fixture(scope="module")
def refs(world):
    """The references, computed while the world runs: the JAX package's
    distributed NTT (on D virtual devices), local NTT, RequestStream on
    make_mesh(dp=4, tp=2) with shard_limbs, pipeline_chain on 4 devices,
    and FheApp(engine="jax").call; the port's RequestStream(mesh=None) and
    FheApp.call."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh

    from fhe_precompiles_tpu import FheApp as JFheApp
    from fhe_precompiles_tpu.bfv.golden import BfvContext as JBfvContext
    from fhe_precompiles_tpu.ops import ntt as jntt
    from fhe_precompiles_tpu.ops.engine import JaxEngine
    from fhe_precompiles_tpu.parallel import RequestStream as JStream
    from fhe_precompiles_tpu.parallel import make_mesh as j_make_mesh
    from fhe_precompiles_tpu.parallel.dist_ntt import (
        make_distributed_ntt as j_dist, shard_coeff_axis as j_shard)
    from fhe_precompiles_tpu.parallel.pipeline import (
        pipeline_chain as j_pipeline)
    from fhe_precompiles_tpu.parallel.stream import Request as JRequest
    from fhe_precompiles_tpu.params import Params as JParams
    from fhe_precompiles_tpu.params import TESTNET_ONE as J_ONE

    _w, inp = world
    out = {}
    for case, (mods, n, _lead) in NTT_CASES.items():
        a, b = _ntt_inputs(case)
        tb = jntt.build_tables(mods, n)
        fwd = np.asarray(jax.jit(lambda x: jntt.ntt(x, tb))(a))
        out[f"ntt_{case}_fwd"] = fwd
        out[f"ntt_{case}_inv"] = np.asarray(
            jax.jit(lambda x: jntt.intt(x, tb))(b))
        for d in NTT_MESHES:
            mesh = JMesh(np.array(jax.devices()[:d]), axis_names=("sp",))
            dfwd, dinv = j_dist(tb, mesh)
            out[f"ntt_{case}_{d}_fwd"] = np.asarray(dfwd(j_shard(a, mesh)))
            out[f"ntt_{case}_{d}_inv"] = np.asarray(dinv(j_shard(b, mesh)))

    jsmall = JParams(poly_modulus_degree=256,
                     coeff_modulus=SMALL.coeff_modulus, plain_modulus=4096)
    jeng = JaxEngine(jsmall, golden=JBfvContext(jsmall))
    jreqs = [JRequest(r.op, r.a, r.b) for r in inp["reqs"]]
    out["stream_jax"] = JStream(
        jeng, mesh=j_make_mesh(dp=4, tp=2), shard_limbs=True).run(
            jreqs, _relin_view(inp["rk"]))
    out["stream_port"] = RequestStream(inp["eng"], mesh=None).run(
        inp["reqs"], _relin_view(inp["rk"]))

    jpipe = JParams(poly_modulus_degree=512,
                    coeff_modulus=PIPE.coeff_modulus, plain_modulus=4096)
    jpeng = JaxEngine(jpipe, golden=JBfvContext(jpipe))
    jrk = jnp.asarray(inp["pipe_rk"])
    pp = JMesh(np.array(jax.devices()[:WORLD]), axis_names=("pp",))
    out["pipeline_jax"] = np.asarray(j_pipeline(
        lambda x, rk: jpeng._mul_relin.__wrapped__(x, x, rk)[:, :2], pp,
        jnp.asarray(inp["pipe_mbs"]), jrk))
    peng = TorchEngine(PIPE, device="cpu")
    seq = []
    for m in range(PIPE_M):
        x = torch.from_numpy(inp["pipe_mbs"][m].view(np.int64))
        for _ in range(WORLD):
            x = peng._mul_relin(x, x, torch.from_numpy(
                inp["pipe_rk"].view(np.int64)))
        seq.append(x.numpy().view(np.uint64))
    out["pipeline_seq"] = np.stack(seq)

    japp = JFheApp(J_ONE, engine="jax")
    out["serve_jax"] = [japp.call(*r) for r in inp["serve"]]
    app = FheApp(TESTNET_ONE, engine="torch", device="cpu")
    out["serve_port"] = [app.call(*r) for r in inp["serve"]]
    return out


@pytest.fixture(scope="module")
def ranks(world, refs):
    """Each rank's saved results, once the world has ended."""
    w, _inp = world
    root = w.wait()
    got = []
    for r in range(WORLD):
        with np.load(os.path.join(root, f"rank{r}.npz")) as z:
            res = {k: z[k].view(np.uint64) for k in z.files}
        with open(os.path.join(root, f"rank{r}_serve.json")) as f:
            res["serve"] = {c: v if isinstance(v, str) else
                            [(code, bytes.fromhex(h)) for code, h in v]
                            for c, v in json.load(f).items()}
        got.append(res)
    return got


# ======================================================================
# in process: no world
# ======================================================================
def test_initialize_without_arguments_is_a_noop():
    multihost.initialize()
    multihost.initialize(num_processes=1, device="cpu")
    assert not torch.distributed.is_initialized()
    assert multihost.is_primary() and multihost.world_size() == 1


def test_initialize_refuses_what_it_cannot_start():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        multihost.initialize(device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        multihost.initialize(device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="needs coordinator_address"):
        multihost.initialize(num_processes=2, process_id=0, device="cpu")
    assert multihost.resolve_backend("cpu") == "gloo"
    assert multihost.resolve_backend("cuda:1") == "nccl"
    assert multihost.resolve_backend("cuda:0", "gloo") == "gloo"
    assert not torch.distributed.is_initialized()


def test_meshes_of_one_process():
    mesh = multihost.global_mesh(device="cpu")
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.axis_index("dp") == 0
    assert mesh.group("dp") is None         # no process group: no collective
    with pytest.raises(ValueError):
        multihost.global_mesh(tp=2, device="cpu")
    with pytest.raises(ValueError):
        make_mesh(dp=100, tp=100, device="cpu")
    with pytest.raises(ValueError, match="not divisible by tp"):
        make_mesh(tp=2, ranks=[0, 1, 2], device="cpu")
    with pytest.raises(ValueError, match="distinct ranks"):
        Mesh({"sp": 2}, device="cpu")
    with pytest.raises(ValueError, match="no axis"):
        mesh.axis_index("sp")


@pytest.mark.parametrize("dp", [1, 2, 3, 4, 8])
def test_bucket_batch_is_a_multiple_of_dp(dp):
    for m in (1, 3, 8, 100, 128):
        for n in range(1, m + 1):
            got = bucket_batch(n, dp, m)
            assert got % dp == 0 and got >= n, (n, dp, m, got)
            assert got <= -(-m // dp) * dp, (n, dp, m, got)


def test_shard_ct_batch_refuses_uneven_splits():
    mesh = make_mesh(device="cpu")          # one rank: dp = tp = 1
    batch = np.zeros((3, 2, 2, 8), dtype=np.uint64)
    assert shard_ct_batch(batch, mesh).shape == (3, 2, 2, 8)
    wide = types.SimpleNamespace(shape={"dp": 2, "tp": 1},
                                 axis_size=lambda name: 2,
                                 axis_index=lambda name: 0, device="cpu")
    with pytest.raises(ValueError, match="not divisible by dp=2"):
        shard_ct_batch(batch, wide)
    limbs = types.SimpleNamespace(shape={"dp": 1, "tp": 2},
                                  axis_size=lambda name: 1,
                                  axis_index=lambda name: 0, device="cpu")
    with pytest.raises(ValueError, match="not divisible by tp=2"):
        shard_ct_batch(np.zeros((2, 2, 3, 8), dtype=np.uint64), limbs,
                       shard_limbs=True)


def test_stream_without_mesh_is_unchanged():
    ctx = BfvContext(SMALL)
    pk, _ = ctx.generate_keys(seed=b"\xa1" * 64)
    cts = [ctx.encrypt(encode_unsigned(v, SMALL, 64), pk, bytes([v]) * 64)
           for v in (2, 3)]
    eng = TorchEngine(SMALL, device="cpu", golden=ctx)
    reqs = RequestStream(eng).make_mixed_requests(cts, 6, seed=1)
    one = make_mesh(device="cpu")
    plain = RequestStream(eng, max_batch=4).run(reqs, pk)
    meshed = RequestStream(eng, mesh=one, max_batch=4).run(reqs, pk)
    assert all(np.array_equal(x, y) for x, y in zip(plain, meshed))
    assert RequestStream(eng).mesh is None
    with pytest.raises(ValueError, match="engine on"):
        RequestStream(eng, mesh=make_mesh(device="cuda"))


# ======================================================================
# the world of four ranks
# ======================================================================
@pytest.mark.parametrize("d", sorted(NTT_MESHES))
@pytest.mark.parametrize("case", sorted(NTT_CASES))
def test_distributed_ntt_equals_jax(ranks, refs, case, d):
    """Each rank's shard, forward, inverse and there and back, equals the
    JAX distributed NTT on d virtual devices and the local transform."""
    a, _b = _ntt_inputs(case)
    n = NTT_CASES[case][1]
    assert np.array_equal(refs[f"ntt_{case}_{d}_fwd"], refs[f"ntt_{case}_fwd"])
    assert np.array_equal(refs[f"ntt_{case}_{d}_inv"], refs[f"ntt_{case}_inv"])
    S = n // d
    for r, got in enumerate(ranks):
        s = r % d                    # the sp index of rank r in either mesh
        cut = slice(s * S, (s + 1) * S)
        assert np.array_equal(got[f"ntt_{case}_{d}_fwd"],
                              refs[f"ntt_{case}_{d}_fwd"][..., cut]), r
        assert np.array_equal(got[f"ntt_{case}_{d}_inv"],
                              refs[f"ntt_{case}_{d}_inv"][..., cut]), r
        assert np.array_equal(got[f"ntt_{case}_{d}_rt"], a[..., cut]), r


@pytest.mark.parametrize("name", sorted(STREAM_MESHES))
def test_request_stream_on_mesh_equals_jax(ranks, refs, world, name):
    """Every rank's list equals the port's and the JAX package's stream;
    a multiply decrypts to the product."""
    _w, inp = world
    want = np.stack(refs["stream_port"])
    assert np.array_equal(np.stack(refs["stream_jax"]), want)
    for r, got in enumerate(ranks):
        assert np.array_equal(got[f"stream_{name}"], want), r
    from fhe_precompiles_tpu.bfv.golden import BfvContext as JBfvContext
    from fhe_precompiles_tpu.bfv.golden import Ciphertext as JCiphertext
    from fhe_precompiles_tpu.encoding import decode_unsigned
    from fhe_precompiles_tpu.params import Params as JParams
    jsmall = JParams(poly_modulus_degree=256,
                     coeff_modulus=SMALL.coeff_modulus, plain_modulus=4096)
    jctx = JBfvContext(jsmall)
    _pk, sk = jctx.generate_keys(seed=b"\xa1" * 64)
    reqs = inp["reqs"]
    i = next(i for i, q in enumerate(reqs) if q.op == "mul")

    def value(data):
        return decode_unsigned(jctx.decrypt(JCiphertext(jsmall, data), sk),
                               jsmall, 64)
    assert value(ranks[0][f"stream_{name}"][i]) == \
        value(reqs[i].a) * value(reqs[i].b)


def test_pipeline_chain_equals_jax(ranks, refs):
    assert np.array_equal(refs["pipeline_jax"], refs["pipeline_seq"])
    for r, got in enumerate(ranks):
        assert np.array_equal(got["pipeline"], refs["pipeline_seq"]), r


@pytest.mark.parametrize("codec", ["python", "native"])
def test_byte_server_on_mesh_equals_call(ranks, refs, codec):
    assert refs["serve_port"] == refs["serve_jax"]
    assert all(code == 0 for code, _ in refs["serve_port"])
    for r, got in enumerate(ranks):
        assert got["serve"][codec] == refs["serve_port"], r


def test_byte_server_on_mesh_fails_on_every_rank_together(ranks, refs):
    """One rank's multiply raises: no rank returns bytes (each raises
    RankFault, the faulty one chained to its own error), and the next run
    on the same world gives the right bytes on every rank."""
    for r, got in enumerate(ranks):
        want = "RuntimeError('device fault')" if r == FAULT_RANK else "None"
        assert got["serve"]["fault"] == want, r
        assert got["serve"]["after_fault"] == refs["serve_port"], r


def test_checked_without_a_process_group():
    mesh = make_mesh(device="cpu")
    assert checked(mesh, lambda: 7) == 7

    def fail():
        raise KeyError("x")
    with pytest.raises(RankFault) as info:
        checked(mesh, fail)
    assert isinstance(info.value.__cause__, KeyError)


def test_key_digest_is_equal_across_an_eviction():
    """The python codec's digest of a key's bytes, which ByteServer groups
    by, stays equal where an eviction gives the bytes a second object."""
    ctx = BfvContext(SMALL)
    pk, _ = ctx.generate_keys(seed=b"\xa1" * 64)
    other, _ = ctx.generate_keys(seed=b"\xa2" * 64)
    codec = _CachedPkCodec()
    codec._MAX = 1
    d1, k1 = codec.deserialize_keyed(pk.to_bytes())
    assert codec.deserialize_keyed(pk.to_bytes())[1] is k1
    codec.deserialize_keyed(other.to_bytes())      # evicts pk
    d2, k2 = codec.deserialize_keyed(pk.to_bytes())
    assert k2 is not k1 and d2 == d1
    assert d1 == hashlib.sha256(pk.to_bytes()).digest()
    assert codec.deserialize(pk.to_bytes()) is k2


def test_byte_server_on_mesh_refuses_continuous_mode():
    app = FheApp(TESTNET_ONE, engine="torch", device="cpu")
    with ByteServer(TESTNET_ONE, mesh=make_mesh(device="cpu"),
                    app=app) as server:
        with pytest.raises(ValueError, match="continuous mode"):
            server.start_continuous()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
