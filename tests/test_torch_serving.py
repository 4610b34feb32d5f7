"""The serving slice as a whole, port against the JAX package: the same
f16 export served by both servers answers the same EmbeddingClient
requests identically; the port's export_compressed writes the JAX files
byte for byte; load_compressed builds the same table; freeze of a trained
(Adam-slotted) table gives the same container.

Everything on this path is integer work or a dtype cast, so every
comparison is bit-exact (assert_array_equal / byte equality)."""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_addons_tpu import dynamic_embedding as jde
from recommenders_addons_tpu.ops import serving as jserving
from recommenders_addons_tpu.serving import server as jserver
from recommenders_addons_tpu_torch import convert
from recommenders_addons_tpu_torch import dynamic_embedding as tde
from recommenders_addons_tpu_torch.serving import server as tserver

DIM = 16


def _carry(jst):
    arrays = {f: np.asarray(getattr(jst, f)) for f in convert.ARRAY_FIELDS}
    meta = {f: getattr(jst, f) for f in convert.META_FIELDS}
    return convert.table_state_from_numpy(arrays, meta, device="cpu")


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


@pytest.fixture(scope="module")
def trained():
    """A filled JAX table (f32, dim 16) and its keys."""
    var = jde.Variable(name="emb", dim=DIM, init_capacity=1024)
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(1, 5000, 400)).astype(np.int64)
    vals = rng.normal(size=(len(keys), DIM)).astype(np.float32)
    state = var.upsert(var.init(), jnp.asarray(keys), jnp.asarray(vals))
    return var, state, keys


@pytest.fixture(scope="module")
def export_dir(trained, tmp_path_factory):
    var, state, _ = trained
    d = tmp_path_factory.mktemp("export")
    jserving.export_compressed(var, state, str(d), dtype=np.float16)
    return str(d)


def _requests(keys, n_req=6, seed=1):
    rng = np.random.default_rng(seed)
    return [np.concatenate([rng.choice(keys, 40), rng.integers(5000, 9000, 6),
                            keys[:3]]) for _ in range(n_req)]


def _answers(srv, reqs):
    """Answers of ``srv`` to ``reqs``: the first two sequentially, the
    rest from 4 concurrent threads."""
    cli = tserver.EmbeddingClient(srv.host, srv.port)
    out = {i: cli.lookup("emb", r) for i, r in enumerate(reqs[:2])}

    def worker(i):
        out[i] = cli.lookup("emb", reqs[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(2, len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    return out


def test_served_answers_match_jax_server(trained, export_dir):
    _, _, keys = trained
    reqs = _requests(keys)
    tsrv = tserver.serve_directory(export_dir, port=0, device="cpu",
                                   max_wait_ms=5.0)
    jsrv = jserver.serve_directory(export_dir, port=0, max_wait_ms=5.0)
    with tsrv, jsrv:
        got, want = _answers(tsrv, reqs), _answers(jsrv, reqs)
        assert (tserver.EmbeddingClient(tsrv.host, tsrv.port).status()
                == jserver.EmbeddingClient(jsrv.host, jsrv.port).status())
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(got[i][1], want[i][1])
        np.testing.assert_array_equal(_bits(got[i][0]), _bits(want[i][0]))
        assert got[i][1].any() and not got[i][1].all()  # hits and misses


def test_load_compressed_builds_the_jax_table(export_dir):
    prefix = os.path.join(export_dir, "emb_serving")
    jft = jserving.load_compressed(prefix)
    tft = tde.serving.load_compressed(prefix, device="cpu")
    assert tft.spec.capacity == jft.spec.capacity
    for f in ("key_lo", "key_hi", "scores", "rows"):
        np.testing.assert_array_equal(
            _bits(getattr(tft.state, f).numpy()),
            _bits(getattr(jft.state, f)))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_export_compressed_is_byte_identical(trained, tmp_path, dtype):
    var, state, _ = trained
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jserving.export_compressed(var, state, str(jdir),
                               dtype=getattr(jnp, dtype))
    tvar = tde.Variable(name="emb", dim=DIM, init_capacity=1024,
                        device="cpu")
    tde.serving.export_compressed(tvar, _carry(state), str(tdir),
                                  dtype=getattr(torch, dtype))
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == 3
    for n in names:
        assert (jdir / n).read_bytes() == (tdir / n).read_bytes(), n


def test_freeze_of_trained_adam_table_matches_jax():
    var = jde.Variable(name="adam_t", dim=8, init_capacity=256)
    opt = jde.Adam(0.05)
    state = jde.create_slots(var, var.init(), opt)
    rng = np.random.default_rng(2)
    keys = jnp.asarray(rng.choice(1000, 48, replace=False).astype(np.int64))
    state = var.upsert(state, keys[:32],
                       jnp.asarray(rng.normal(size=(32, 8)), jnp.float32))
    for step in range(1, 3):
        emb, ctx = var.embedding_lookup(state, keys)
        g = jnp.asarray(rng.normal(size=emb.shape).astype(np.float32))
        state = var.apply_gradients(state, ctx, g, opt, step=step)
    tst = _carry(state)
    assert tst.slot_names == state.slot_names and tst.chunks == 1
    jft = jserving.freeze(var, state, dtype=jnp.bfloat16)
    tvar = tde.Variable(name="adam_t", dim=8, init_capacity=256,
                        device="cpu")
    tft = tde.freeze(tvar, tst, dtype=torch.bfloat16)
    np.testing.assert_array_equal(_bits(tft.state.rows.numpy()),
                                  _bits(jft.state.rows))
    assert tft.state.value_dtype_name == jft.state.value_dtype_name
    probe = np.concatenate([np.asarray(keys), [5000, 6000]])
    jv, jf = jft.lookup(jnp.asarray(probe), return_exists=True)
    tv, tf = tft.lookup(torch.from_numpy(probe), return_exists=True)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    assert tft.size() == jft.size()


def test_token_auth_and_unported_options(trained, export_dir):
    tft = tde.serving.load_compressed(
        os.path.join(export_dir, "emb_serving"), device="cpu")
    with tserver.EmbeddingServer({"emb": tft}, port=0, token="s3") as srv:
        with pytest.raises(RuntimeError):
            tserver.EmbeddingClient(srv.host, srv.port).lookup("emb", [1])
        cli = tserver.EmbeddingClient(srv.host, srv.port, token="s3")
        _, found = cli.lookup("emb", trained[2][:4])
        assert found.all()
        with pytest.raises(RuntimeError):
            cli.lookup("nope", [1])
    # a spill tier answers the table's misses where it holds them
    tier = tde.SpillTier(tde.Variable(name="emb", dim=DIM, device="cpu"),
                         store=tde.HostKVStore(DIM))
    tier.store.put([99991], np.full((1, DIM), 2.5, np.float32))
    with tserver.EmbeddingServer({"emb": tft}, tiers={"emb": tier},
                                 port=0) as srv:
        vals, found = tserver.EmbeddingClient(srv.host, srv.port).lookup(
            "emb", [99991, 99992, int(trained[2][0])])
    assert found.tolist() == [True, False, True]
    assert (vals[0] == 2.5).all() and (vals[1] == 0).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tserver.serve_directory(export_dir, port=0)


def test_pad_bucket_matches_jax():
    for n in (1, 64, 65, 300, 16384, 16385, 50000):
        assert tserver._pad_bucket(n) == jserver._pad_bucket(n)
