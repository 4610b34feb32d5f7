"""Networked shared KV tier: one key space for N trainers and servers,
the port of the JAX package's ``serving/kv.py``.

The defining property of the reference's Redis backend: every training or
serving replica reads and writes ONE shared table over the network. Here
a host-DRAM store (``ops/spill.HostKVStore`` or the native
``NativeHostKVStore``) is served over HTTP by :class:`HostKVServer`, and
:class:`RemoteKVStore` is a client with the same batched store surface,
so any ``SpillTier`` / ``ShardedSpillTier`` / ``HybridTable`` can use a
SHARED tier:

    # the tier server (one per job)
    python -m recommenders_addons_tpu_torch.serving.kv --dim 64 --port 8502

    # every trainer / serving replica
    store = RemoteKVStore("tier-host", 8502, dim=64)
    tier = de.SpillTier(var, store=store)

Wire format: numpy ``.npz`` request and response bodies (dense binary,
stdlib only), the JAX package's, so either package's client talks to
either package's server. Nothing here holds a device tensor.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np


def _pack(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _unpack(body: bytes) -> Dict[str, np.ndarray]:
    return dict(np.load(io.BytesIO(body), allow_pickle=False))


def _split_slots(d: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k[len("slot."):]: v for k, v in d.items()
            if k.startswith("slot.")}


class HostKVServer:
    """Serve one host store's batched put/get/delete over HTTP.

    ``token``: require ``Authorization: Bearer <token>`` (this tier holds
    live embedding weights — always set it off-box). ``tls_cert``/
    ``tls_key``: PEM paths enabling TLS, as for ``EmbeddingServer``."""

    def __init__(self, store, host: str = "127.0.0.1", port: int = 8502,
                 token: Optional[str] = None,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None):
        self._store = store
        self._lock = threading.Lock()
        store_ref, lock = self._store, self._lock
        expect_auth = f"Bearer {token}" if token else None

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _authed(self) -> bool:
                if expect_auth is None:
                    return True
                if self.headers.get("Authorization") == expect_auth:
                    return True
                self._send_json(401, {"error": "unauthorized"})
                return False

            def _send_npz(self, arrays):
                body = _pack(arrays)
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if not self._authed():
                    return
                if self.path == "/v1/kv/stats":
                    with lock:
                        self._send_json(200, {
                            "count": len(store_ref),
                            "dim": store_ref.dim,
                            "slot_names": list(store_ref.slot_names),
                        })
                elif self.path == "/v1/kv/export":
                    # full tier dump for checkpointing (the Redis RDB
                    # persistence role, redis_connection_util.hpp:330-480)
                    with lock:
                        keys, vals, scores, slots = store_ref.export_all()
                    out = {"keys": keys, "values": vals, "scores": scores}
                    for nme, c in slots.items():
                        out[f"slot.{nme}"] = c
                    self._send_npz(out)
                else:
                    self._send_json(404, {"error": "not found"})

            def do_POST(self):
                if not self._authed():
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = _unpack(self.rfile.read(n))
                    if self.path == "/v1/kv/put":
                        with lock:
                            store_ref.put(
                                req["keys"], req["values"],
                                req.get("scores"),
                                _split_slots(req) or None,
                            )
                        self._send_json(200, {"ok": True})
                    elif self.path == "/v1/kv/get":
                        with lock:
                            vals, scores, slots, found = store_ref.get(
                                req["keys"])
                        out = {"values": vals, "scores": scores,
                               "found": found.astype(np.uint8)}
                        for nme, c in slots.items():
                            out[f"slot.{nme}"] = c
                        self._send_npz(out)
                    elif self.path == "/v1/kv/delete":
                        with lock:
                            store_ref.delete(req["keys"])
                        self._send_json(200, {"ok": True})
                    else:
                        self._send_json(404, {"error": "not found"})
                except Exception as e:
                    self._send_json(
                        500, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        if tls_cert and tls_key:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key)
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()  # release the port (restart support)

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()


class RemoteKVStore:
    """HostKVStore-surface client over :class:`HostKVServer` — plug into
    ``SpillTier(var, store=...)`` so N processes share one tier (the Redis
    distributed-training/serving contract)."""

    # one network store serves ALL processes: checkpoint paths must dump /
    # restore it exactly once, not once per rank (train/checkpoint.py)
    is_shared = True

    def __init__(self, host: str, port: int, dim: int,
                 value_dtype=np.float32, timeout: float = 30.0,
                 token: Optional[str] = None,
                 tls_root: Optional[str] = None):
        self.host, self.port, self.timeout = host, port, timeout
        self.dim = dim
        self.value_dtype = np.dtype(value_dtype)
        self.token, self.tls_root = token, tls_root

    def _conn(self):
        import http.client

        if self.tls_root:
            import ssl

            ctx = ssl.create_default_context(cafile=self.tls_root)
            ctx.check_hostname = False  # fleets use IPs / self-signed
            return http.client.HTTPSConnection(
                self.host, self.port, timeout=self.timeout, context=ctx)
        return http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout)

    def _headers(self, extra=None):
        h = dict(extra or {})
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    def _post(self, path: str, arrays: Dict[str, np.ndarray],
              raw: bool = False):
        conn = self._conn()
        try:
            conn.request(
                "POST", path, body=_pack(arrays),
                headers=self._headers(
                    {"Content-Type": "application/octet-stream"}))
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise RuntimeError(
                    json.loads(body).get("error", f"HTTP {resp.status}"))
            return _unpack(body) if raw else json.loads(body)
        finally:
            conn.close()

    def _stats(self):
        conn = self._conn()
        try:
            conn.request("GET", "/v1/kv/stats", headers=self._headers())
            return json.loads(conn.getresponse().read())
        finally:
            conn.close()

    # -- HostKVStore surface ------------------------------------------------

    @property
    def slot_names(self):
        return tuple(self._stats()["slot_names"])

    def put(self, keys, values, scores=None, slots=None):
        req = {
            "keys": np.asarray(keys, np.int64).reshape(-1),
            "values": np.asarray(values, self.value_dtype).reshape(
                -1, self.dim),
        }
        if scores is not None:
            req["scores"] = np.asarray(scores, np.int64).reshape(-1)
        for n, c in (slots or {}).items():
            req[f"slot.{n}"] = np.asarray(c, self.value_dtype).reshape(
                -1, self.dim)
        self._post("/v1/kv/put", req)

    def get(self, keys):
        out = self._post(
            "/v1/kv/get",
            {"keys": np.asarray(keys, np.int64).reshape(-1)}, raw=True)
        return (out["values"], out["scores"], _split_slots(out),
                out["found"].astype(bool))

    def delete(self, keys):
        self._post("/v1/kv/delete",
                   {"keys": np.asarray(keys, np.int64).reshape(-1)})

    def export_all(self):
        """Full tier dump (keys, values, scores, slots) for checkpointing."""
        conn = self._conn()
        try:
            conn.request("GET", "/v1/kv/export", headers=self._headers())
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise RuntimeError(
                    json.loads(body).get("error", f"HTTP {resp.status}"))
            out = _unpack(body)
        finally:
            conn.close()
        return (out["keys"], out["values"], out["scores"],
                _split_slots(out))

    @property
    def count(self) -> int:
        return int(self._stats()["count"])

    def __len__(self):
        return self.count


class ShardedRemoteKVStore:
    """One key space over N tier servers: rendezvous-hashed sharding with
    R-way replication and read failover.

    This is the scale-out role of the reference's Redis CLUSTER backend —
    slot-sharded keys over many nodes with failover
    (redis_impl/redis_slots_tab.h:1-1821,
    redis_cluster_connection_pool.hpp:1-1446) — redesigned for the host
    tier: rendezvous (HRW) hashing instead of slot tables (no resharding
    metadata; adding a node moves only ~1/N of keys), whole-batch
    partitioned requests instead of per-key pipelines.

    * ``put``/``delete`` go to each key's top-R live replicas.
    * ``get`` asks each key's highest-ranked live replica; keys on a node
      that fails mid-read retry transparently on their next replica.
    * A node that errors is marked down and skipped until ``revive()``
      (or a fresh process); writes during the outage land on the
      remaining replicas, so R >= 2 keeps every key readable through a
      single-node failure or restart.

    Implements the HostKVStore surface — plug into
    ``SpillTier(var, store=...)`` / ``ShardedSpillTier`` like any store.
    """

    is_shared = True  # see RemoteKVStore.is_shared

    def __init__(self, endpoints, dim: int, value_dtype=np.float32,
                 replicas: int = 2, timeout: float = 30.0,
                 token: Optional[str] = None,
                 tls_root: Optional[str] = None):
        if not endpoints:
            raise ValueError("ShardedRemoteKVStore needs >= 1 endpoint")
        self.dim = dim
        self.value_dtype = np.dtype(value_dtype)
        self.replicas = max(1, min(int(replicas), len(endpoints)))
        self._nodes = [
            RemoteKVStore(h, p, dim, value_dtype, timeout=timeout,
                          token=token, tls_root=tls_root)
            for h, p in endpoints
        ]
        self._down = [False] * len(self._nodes)
        # fixed per-node seeds for rendezvous ranking (stable across
        # clients as long as the endpoint ORDER is stable)
        self._seeds = np.asarray(
            [0x9E3779B97F4A7C15 * (i + 1) & (2**64 - 1)
             for i in range(len(self._nodes))], np.uint64)

    # -- rendezvous ranking -------------------------------------------------

    def _rank(self, keys: np.ndarray) -> np.ndarray:
        """[N, n_nodes] node indices, best-first, per key (HRW)."""
        k = keys.astype(np.uint64)[:, None] ^ self._seeds[None, :]
        k = (k ^ (k >> 30)) * np.uint64(0xBF58476D1CE4E5B9)
        k = (k ^ (k >> 27)) * np.uint64(0x94D049BB133111EB)
        k = k ^ (k >> 31)
        return np.argsort(~k, axis=1, kind="stable")  # descending score

    def _alive(self):
        return [i for i, d in enumerate(self._down) if not d]

    def revive(self, node: Optional[int] = None):
        """Clear down-markers (e.g. after a server restart)."""
        if node is None:
            self._down = [False] * len(self._nodes)
        else:
            self._down[node] = False

    def _call(self, node: int, fn, *args):
        try:
            out = fn(self._nodes[node], *args)
            self._down[node] = False
            return True, out
        except (OSError, RuntimeError, TimeoutError) as e:
            import warnings

            warnings.warn(
                f"KV tier node {node} "
                f"({self._nodes[node].host}:{self._nodes[node].port}) "
                f"failed ({type(e).__name__}: {e}); failing over")
            self._down[node] = True
            return False, None

    # -- HostKVStore surface --------------------------------------------

    def put(self, keys, values, scores=None, slots=None):
        keys = np.asarray(keys, np.int64).reshape(-1)
        valid = keys != np.iinfo(np.int64).min  # EMPTY sentinel
        if not valid.any():
            return
        values = np.asarray(values).reshape(-1, self.dim)
        scores_a = (np.asarray(scores).reshape(-1)
                    if scores is not None else None)
        slots = {n: np.asarray(c).reshape(-1, self.dim)
                 for n, c in (slots or {}).items()}
        ranks = self._rank(keys)
        for r in range(self.replicas):
            owners = ranks[:, r]
            for node in np.unique(owners):
                if self._down[node]:
                    continue
                sel = valid & (owners == node)
                if not sel.any():
                    continue
                self._call(
                    int(node),
                    lambda s, m=sel: s.put(
                        keys[m], values[m],
                        scores_a[m] if scores_a is not None else None,
                        {n: c[m] for n, c in slots.items()} or None,
                    ))

    def get(self, keys):
        keys = np.asarray(keys, np.int64).reshape(-1)
        n = len(keys)
        vals = np.zeros((n, self.dim), self.value_dtype)
        scr = np.zeros((n,), np.int64)
        found = np.zeros((n,), bool)
        slot_cols: Dict[str, np.ndarray] = {}
        ranks = self._rank(keys)
        pending = np.ones((n,), bool)
        for r in range(len(self._nodes)):  # walk replica ranks on failure
            if not pending.any():
                break
            owners = ranks[:, r]
            for node in np.unique(owners[pending]):
                if self._down[node]:
                    continue  # keys stay pending -> next rank
                sel = pending & (owners == node)
                ok, out = self._call(
                    int(node), lambda s, m=sel: s.get(keys[m]))
                if not ok:
                    continue  # retry those keys at the next rank
                v, s, sl, f = out
                idx = np.nonzero(sel)[0]
                hit_idx = idx[f]
                vals[hit_idx] = v[f]
                scr[hit_idx] = s[f]
                found[hit_idx] = True
                for nm, c in sl.items():
                    if nm not in slot_cols:
                        slot_cols[nm] = np.zeros((n, self.dim),
                                                 self.value_dtype)
                    slot_cols[nm][hit_idx] = c[f]
                # resolved (hit or clean miss) keys stop walking; keys on
                # a FAILED node keep walking to their next replica
                pending[idx] = False
        return vals, scr, slot_cols, found

    def delete(self, keys):
        keys = np.asarray(keys, np.int64).reshape(-1)
        ranks = self._rank(keys)
        for r in range(self.replicas):
            owners = ranks[:, r]
            for node in np.unique(owners):
                if self._down[node]:
                    continue
                sel = owners == node
                self._call(int(node), lambda s, m=sel: s.delete(keys[m]))

    def export_all(self):
        """Union dump over all live nodes, deduplicated by key (R-way
        replication stores each row on several nodes; the max-score copy
        wins — the freshest one under monotone LRU/step scoring)."""
        all_k, all_v, all_s, all_sl = [], [], [], []
        slot_names = set()
        for i in self._alive():
            ok, out = self._call(i, lambda s: s.export_all())
            if not ok:
                continue
            k, v, s, sl = out
            all_k.append(np.asarray(k, np.int64).reshape(-1))
            all_v.append(np.asarray(v).reshape(-1, self.dim))
            all_s.append(np.asarray(s, np.int64).reshape(-1))
            all_sl.append(sl)
            slot_names.update(sl.keys())
        if not all_k:
            return (np.empty((0,), np.int64),
                    np.empty((0, self.dim), self.value_dtype),
                    np.empty((0,), np.int64), {})
        keys = np.concatenate(all_k)
        vals = np.concatenate(all_v, axis=0)
        scores = np.concatenate(all_s)
        slots = {
            n: np.concatenate([
                np.asarray(sl[n]).reshape(-1, self.dim)
                if n in sl else np.zeros((len(k), self.dim),
                                         self.value_dtype)
                for k, sl in zip(all_k, all_sl)
            ], axis=0)
            for n in sorted(slot_names)
        }
        # dedup: keep the highest-score replica of each key
        order = np.lexsort((scores, keys))
        keys, vals, scores = keys[order], vals[order], scores[order]
        slots = {n: c[order] for n, c in slots.items()}
        last = np.concatenate([keys[1:] != keys[:-1], [True]])
        return (keys[last], vals[last], scores[last],
                {n: c[last] for n, c in slots.items()})

    @property
    def slot_names(self):
        for i in self._alive():
            ok, out = self._call(i, lambda s: s.slot_names)
            if ok:
                return out
        return ()

    @property
    def count(self) -> int:
        """Approximate live-key count (replicas double-count; exact when
        replicas == 1)."""
        total = 0
        for i in self._alive():
            ok, out = self._call(i, lambda s: s.count)
            if ok:
                total += out
        return total // self.replicas

    def __len__(self):
        return self.count


def main(argv=None):
    import argparse

    from recommenders_addons_tpu_torch.ops.spill import make_host_store

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dim", type=int, required=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8502)
    p.add_argument("--capacity", type=int, default=1 << 20)
    p.add_argument("--token", default=None,
                   help="require 'Authorization: Bearer <token>'")
    p.add_argument("--tls-cert", default=None, help="PEM cert path")
    p.add_argument("--tls-key", default=None, help="PEM key path")
    args = p.parse_args(argv)
    srv = HostKVServer(
        make_host_store(args.dim, initial_capacity=args.capacity),
        host=args.host, port=args.port, token=args.token,
        tls_cert=args.tls_cert, tls_key=args.tls_key,
    ).start()
    print(f"shared KV tier (dim {args.dim}) on {srv.host}:{srv.port}",
          flush=True)
    import time

    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
