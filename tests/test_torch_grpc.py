"""The port's gRPC front end (``serving/grpc_server.py``) against the JAX
package's: the same f16 export served by both answers the same request
with the same bytes; the codec's bytes are the JAX codec's; an unknown
table, the bearer token, a spill tier's read-through and TLS behave as
the JAX package's tests hold them (``tests/test_serving_server.py``);
``main --grpc`` serves; and importing the port's ``serving`` loads no
``grpc``. Everything on this path is integer work or a dtype cast, so
every comparison is bit-exact."""

import json
import os
import subprocess
import sys
import time

import grpc
import jax.numpy as jnp
import numpy as np
import pytest

from recommenders_addons_tpu import dynamic_embedding as jde
from recommenders_addons_tpu.ops import serving as jserving
from recommenders_addons_tpu.serving import grpc_server as jgrpc
from recommenders_addons_tpu_torch import dynamic_embedding as tde
from recommenders_addons_tpu_torch.serving import grpc_server as tgrpc
from recommenders_addons_tpu_torch.serving import server as tserver

DIM = 16


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    """An f16 export of a filled JAX table (as test_torch_serving.py
    builds it) and its keys."""
    var = jde.Variable(name="emb", dim=DIM, init_capacity=1024)
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(1, 5000, 400)).astype(np.int64)
    vals = rng.normal(size=(len(keys), DIM)).astype(np.float32)
    state = var.upsert(var.init(), jnp.asarray(keys), jnp.asarray(vals))
    d = tmp_path_factory.mktemp("grpc_export")
    jserving.export_compressed(var, state, str(d), dtype=np.float16)
    return str(d), keys


@pytest.fixture
def frozen(export_dir):
    return tde.serving.load_compressed(
        os.path.join(export_dir[0], "emb_serving"), device="cpu")


def _raw_lookup(port, request: bytes) -> bytes:
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        return ch.unary_unary(f"/{tgrpc.SERVICE}/Lookup")(request,
                                                           timeout=60)


def test_both_servers_answer_with_the_same_bytes(export_dir):
    d, keys = export_dir
    rng = np.random.default_rng(1)
    ids = np.concatenate([rng.choice(keys, 50), rng.integers(5000, 9000, 7),
                          keys[:3]])
    req = jgrpc._pack_lookup_request("emb", ids)
    assert tgrpc.SERVICE == jgrpc.SERVICE
    tsrv = tgrpc.serve_directory_grpc(d, port=0, device="cpu")
    jsrv = jgrpc.serve_directory_grpc(d, port=0)
    with tsrv, jsrv:
        got, want = _raw_lookup(tsrv.port, req), _raw_lookup(jsrv.port, req)
        with tgrpc.GrpcEmbeddingClient(port=tsrv.port) as tc, \
                jgrpc.GrpcEmbeddingClient(port=jsrv.port) as jc:
            assert tc.status() == jc.status()
            vals, found = tc.lookup("emb", ids)
    assert got == want
    assert found.any() and not found.all()
    assert vals.dtype == np.float32 and vals.shape == (len(ids), DIM)
    # the transport-free handler answers the same bytes
    entry = tserver._TableEntry(tsrv._entries["emb"].table)
    batcher = tserver._Batcher(entry)
    try:
        assert tgrpc.lookup_bytes({"emb": batcher}, req) == want
        with pytest.raises(tgrpc.UnknownTableError, match="no table nope"):
            tgrpc.lookup_bytes({"emb": batcher},
                               tgrpc._pack_lookup_request("nope", ids))
    finally:
        batcher.shutdown()


@pytest.mark.parametrize("table", ["emb", "", "täblé"])
def test_codec_bytes_match_jax(table):
    rng = np.random.default_rng(2)
    ids = rng.integers(-2**62, 2**62, size=37)
    req = tgrpc._pack_lookup_request(table, ids)
    assert req == jgrpc._pack_lookup_request(table, ids)
    for unpack in (tgrpc._unpack_lookup_request,
                   jgrpc._unpack_lookup_request):
        name, back = unpack(req)
        assert name == table
        np.testing.assert_array_equal(back, ids)
    vals = rng.normal(size=(37, 5)).astype(np.float16)
    found = rng.random(37) < 0.5
    resp = tgrpc._pack_lookup_response(vals, found)
    assert resp == jgrpc._pack_lookup_response(vals, found)
    for unpack in (tgrpc._unpack_lookup_response,
                   jgrpc._unpack_lookup_response):
        v, f = unpack(resp)
        np.testing.assert_array_equal(v, vals.astype(np.float32))
        np.testing.assert_array_equal(f, found)


def test_unknown_table_failed_lookup_and_token(frozen):
    with tgrpc.GrpcEmbeddingServer({"emb": frozen}, port=0) as srv:
        with tgrpc.GrpcEmbeddingClient(srv.host, srv.port) as cli:
            with pytest.raises(grpc.RpcError) as ei:
                cli.lookup("nope", [1])
            assert ei.value.code() == grpc.StatusCode.NOT_FOUND
            assert ei.value.details() == "no table nope"

    class Broken:
        spec, state = frozen.spec, frozen.state

        def lookup(self, ids, return_exists=True):
            raise ValueError("bad shard")

    with tgrpc.GrpcEmbeddingServer({"emb": Broken()}, port=0) as srv:
        with tgrpc.GrpcEmbeddingClient(srv.host, srv.port) as cli:
            with pytest.raises(grpc.RpcError) as ei:
                cli.lookup("emb", [1])
            assert ei.value.code() == grpc.StatusCode.INTERNAL
            assert ei.value.details() == "ValueError: bad shard"
    with tgrpc.GrpcEmbeddingServer({"emb": frozen}, port=0,
                                   token="sekrit") as srv:
        with tgrpc.GrpcEmbeddingClient(srv.host, srv.port,
                                       token="sekrit") as cli:
            assert cli.status()["tables"]["emb"]["dim"] == DIM
        for token in (None, "wrong"):
            with tgrpc.GrpcEmbeddingClient(srv.host, srv.port,
                                           token=token) as bad:
                with pytest.raises(grpc.RpcError) as ei:
                    bad.lookup("emb", [3])
                assert ei.value.code() == grpc.StatusCode.UNAUTHENTICATED


def test_tier_read_through(frozen, export_dir):
    keys = export_dir[1]
    tier = tde.SpillTier(tde.Variable(name="emb", dim=DIM, device="cpu"),
                         store=tde.HostKVStore(DIM))
    tier.store.put([99991], np.full((1, DIM), 9.0, np.float32))
    with tgrpc.GrpcEmbeddingServer({"emb": frozen}, tiers={"emb": tier},
                                   port=0) as srv:
        with tgrpc.GrpcEmbeddingClient(srv.host, srv.port) as cli:
            vals, found = cli.lookup("emb", [int(keys[0]), 99991, 99992])
    assert found.tolist() == [True, True, False]
    assert (vals[1] == 9.0).all() and (vals[2] == 0).all()


def test_tls(tmp_path, frozen):
    from test_serving_server import _self_signed_cert

    cert, key = _self_signed_cert(tmp_path)
    with tgrpc.GrpcEmbeddingServer({"emb": frozen}, host="localhost",
                                   port=0, tls_cert=cert, tls_key=key,
                                   token="t0k") as srv:
        with tgrpc.GrpcEmbeddingClient("localhost", srv.port, token="t0k",
                                       tls_root=cert) as cli:
            _, found = cli.lookup("emb", [int(frozen.state.keys[
                frozen.state.keys != frozen.spec.empty_key][0])])
            assert found.all()


def test_main_grpc_serves(export_dir, monkeypatch, capsys):
    """``main --grpc --device cpu`` loads the directory and serves gRPC
    until interrupted (the wait is cut short here)."""
    real_sleep = time.sleep

    def sleep(s):
        if s >= 3600:
            raise KeyboardInterrupt
        real_sleep(s)

    monkeypatch.setattr(time, "sleep", sleep)
    tserver.main(["--dir", export_dir[0], "--grpc", "--device", "cpu",
                  "--host", "127.0.0.1", "--port", "0", "--token", "x"])
    assert "serving ['emb'] on 127.0.0.1:" in capsys.readouterr().out


def test_serving_imports_without_grpc():
    """A fresh interpreter importing the port's serving package (and
    making an HTTP server's pieces) loads neither grpc nor JAX."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, json, recommenders_addons_tpu_torch.serving as s; "
            "s.grpc_server.lookup_bytes; "
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('grpc', 'jax', 'optax'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
