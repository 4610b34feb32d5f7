"""The networked shared KV tier (``serving/kv.py``) and tiered serving,
port against the JAX package: each package's ``RemoteKVStore`` on the
other package's ``HostKVServer`` (the same ``.npz`` wire format), a
``SpillTier`` over a remote store against one over a local store,
``ShardedRemoteKVStore``'s replication and failover, and
``EmbeddingServer(tiers=)`` answering what the JAX server answers.

Servers run on 127.0.0.1 threads of this process (port 0). Every value
crosses as stored bytes, so every comparison is bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_addons_tpu import dynamic_embedding as jde
from recommenders_addons_tpu.ops import spill as jspill
from recommenders_addons_tpu.serving import kv as jkv
from recommenders_addons_tpu.serving import server as jserver
from recommenders_addons_tpu_torch import dynamic_embedding as tde
from recommenders_addons_tpu_torch.ops import spill as tspill
from recommenders_addons_tpu_torch.serving import kv as tkv
from recommenders_addons_tpu_torch.serving import server as tserver
from test_torch_spill import (  # noqa: F401 (a fixture)
    _filled_pair,
    assert_stores_equal,
    jax_jitted,
)

DIM = 8


@pytest.mark.parametrize("server,client", [("jax", "port"),
                                           ("port", "jax")])
def test_remote_store_across_packages(server, client):
    """One package's client on the other's server: puts (with scores and
    a slot column), overwrites, gets, deletes, stats and the export equal
    a local store given the same calls."""
    srv_mod, cli_mod = {"jax": jkv, "port": tkv}[server], {
        "jax": jkv, "port": tkv}[client]
    local_mod = jspill if server == "jax" else tspill
    backing, local = local_mod.HostKVStore(DIM), tspill.HostKVStore(DIM)
    rng = np.random.default_rng(4)
    keys = rng.choice(1 << 40, 500, replace=False).astype(np.int64) + 1
    vals = rng.normal(size=(500, DIM)).astype(np.float32)
    with srv_mod.HostKVServer(backing, port=0) as srv:
        remote = cli_mod.RemoteKVStore(srv.host, srv.port, dim=DIM)
        assert remote.is_shared
        for s in (remote, local):
            s.put(keys, vals, keys % 97, {"m": vals * 0.5})
            s.put(keys[:50], vals[:50] + 1)
            s.delete(keys[400:])
        probe = np.concatenate([keys[::3], [7, 8]])
        for a, b in zip(remote.get(probe), local.get(probe)):
            if isinstance(a, dict):
                assert set(a) == set(b) == {"m"}
                a, b = a["m"], b["m"]
            np.testing.assert_array_equal(a, b)
        assert len(remote) == len(local) == 400
        assert remote.slot_names == ("m",)
        assert_stores_equal(remote, local)


def test_spill_tier_on_remote_store_matches_local():
    """A SpillTier whose store is the port's RemoteKVStore on an
    in-process HostKVServer over the native store: demote, promote and
    lookup_through give the planes, store and stats of a SpillTier over a
    local native store."""
    tv, _, ts, _, keys, _ = _filled_pair("remote", n=300, seed=6,
                                         jax_fill=False)
    ts2 = ts.replace(key_lo=ts.key_lo.clone(), key_hi=ts.key_hi.clone(),
                     rows=ts.rows.clone(), scores=ts.scores.clone())
    with tkv.HostKVServer(tspill.make_host_store(DIM), port=0) as srv:
        remote = tspill.SpillTier(
            tv, store=tkv.RemoteKVStore(srv.host, srv.port, dim=DIM))
        local = tspill.SpillTier(tv)
        ts, ts2 = remote.demote(ts, 128), local.demote(ts2, 128)
        ids = np.concatenate([keys[::2], [3, 4]])
        ts, ts2 = remote.promote(ts, ids), local.promote(ts2, ids)
        n = ts.capacity * ts.chunks  # the trash row after is unspecified
        for a, b in ((ts.key_lo, ts2.key_lo), (ts.key_hi, ts2.key_hi),
                     (ts.scores, ts2.scores), (ts.rows[:n], ts2.rows[:n])):
            assert torch.equal(a, b)
        assert_stores_equal(remote.store, local.store)
        got = remote.lookup_through(ts, torch.from_numpy(keys))
        assert torch.equal(got, local.lookup_through(ts2,
                                                     torch.from_numpy(keys)))
        assert vars(remote.stats) == vars(local.stats)


def test_sharded_remote_store_replicates_and_fails_over():
    """Three port servers, two replicas: every key on exactly two nodes,
    rendezvous placement equal to the JAX client's; with node 0 down,
    reads fail over (with the warning) and writes land on the live
    replicas; after a restart on its port and ``revive`` it serves
    again; delete removes every replica."""
    stores = [tspill.HostKVStore(2) for _ in range(3)]
    servers = [tkv.HostKVServer(s, port=0).start() for s in stores]
    try:
        ends = [(s.host, s.port) for s in servers]
        client = tkv.ShardedRemoteKVStore(ends, dim=2, replicas=2)
        keys = np.arange(1, 301, dtype=np.int64)
        vals = np.tile(keys[:, None].astype(np.float32), (1, 2))
        np.testing.assert_array_equal(
            client._rank(keys),
            jkv.ShardedRemoteKVStore(ends, dim=2)._rank(keys))
        client.put(keys, vals, scores=keys * 2, slots={"m": vals * 0.5})
        assert sum(len(s) for s in stores) == 600
        v, sc, sl, f = client.get(keys)
        assert f.all() and (v == vals).all() and (sc == keys * 2).all()
        assert (sl["m"] == vals * 0.5).all()
        port0 = servers[0].port
        servers[0].stop()
        with pytest.warns(UserWarning, match="failing over"):
            v, _, _, f = client.get(keys)
        assert f.all() and (v == vals).all()
        more = np.arange(400, 460, dtype=np.int64)
        client.put(more, np.ones((60, 2), np.float32))
        assert client.get(more)[3].all()
        servers[0] = tkv.HostKVServer(stores[0], port=port0).start()
        client.revive()
        assert client._alive() == [0, 1, 2]
        v, _, _, f = client.get(keys)
        assert f.all() and (v == vals).all()
        client.delete(keys[:50])
        assert not client.get(keys[:50])[3].any()
        k, _, _, _ = client.export_all()
        np.testing.assert_array_equal(
            np.sort(k), np.concatenate([keys[50:], more]))
    finally:
        for s in servers:
            s.stop()


def test_embedding_server_tiers_answer_as_jax(jax_jitted):
    """The same f32 table frozen by both packages and the same tier rows:
    ``EmbeddingServer(tiers=)`` of each answers 6 requests (card hits,
    tier hits and unknown ids) with the same values and found flags."""
    rng = np.random.default_rng(8)
    keys = rng.choice(1 << 30, 400, replace=False).astype(np.int64) + 1
    vals = rng.normal(size=(400, DIM)).astype(np.float32)
    jv = jde.Variable(name="emb", dim=DIM, init_capacity=512)
    tv = tde.Variable(name="emb", dim=DIM, init_capacity=512, device="cpu")
    js = jv.upsert(jv.init(), jnp.asarray(keys[:250]),
                   jnp.asarray(vals[:250]))
    ts = tv.upsert(tv.init(), torch.from_numpy(keys[:250]),
                   torch.from_numpy(vals[:250]))
    jt, tt = jspill.SpillTier(jv), tspill.SpillTier(tv)
    for t in (jt, tt):
        t.store.put(keys[250:], vals[250:])
    jft = jde.freeze(jv, js, dtype=jnp.float32)
    tft = tde.freeze(tv, ts, dtype=torch.float32)
    reqs = [np.concatenate([rng.choice(keys, 40), rng.integers(
        1 << 31, 1 << 32, 6)]) for _ in range(6)]
    answers = []
    for mod, ft, tier in ((jserver, jft, jt), (tserver, tft, tt)):
        with mod.EmbeddingServer({"emb": ft}, tiers={"emb": tier},
                                 port=0) as srv:
            cli = tserver.EmbeddingClient(srv.host, srv.port)
            answers.append([cli.lookup("emb", r) for r in reqs])
    for (jvals, jfound), (tvals, tfound) in zip(*answers):
        np.testing.assert_array_equal(tfound, jfound)
        np.testing.assert_array_equal(tvals.view(np.int32),
                                      jvals.view(np.int32))
    assert sum(f.sum() for _, f in answers[1]) > 0
    assert not all(f.all() for _, f in answers[1])
