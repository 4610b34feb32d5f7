"""Embedding-lookup server: batched read-only serving of frozen tables —
the port of the JAX package's ``serving/server.py``.

The server micro-batches concurrent requests (a max_batch/max_wait_ms
coalescing window, as TF-Serving's BatchingSession), pads each batch to a
fixed bucket size, and runs one table lookup per coalesced batch on the
table's device. Pure stdlib (http.server + threading); JSON wire format.

Endpoints:
  POST /v1/lookup   {"table": name, "ids": [...]}
                    -> {"values": [[...]...], "found": [...]}
  GET  /v1/status   -> {"tables": {name: {size, dim, capacity, value_dtype}}}

A table may have a host-DRAM spill tier (``tiers=``, ops/spill.py): its
misses are read through the tier's store, and found where the tier holds
them. The gRPC front end (``serving/grpc_server.py``) shares the
micro-batching core and the directory loader.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np
import torch

from recommenders_addons_tpu_torch.ops import hashtable

_BUCKETS = (64, 256, 1024, 4096, 16384)


def _pad_bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return -(-n // _BUCKETS[-1]) * _BUCKETS[-1]


class _TableEntry:
    """One served table (a FrozenTable, or anything with .lookup/.spec/
    .size and a ``state`` on its device), with an optional spill tier
    read through for its misses."""

    def __init__(self, table, tier=None):
        self.table = table
        self.tier = tier
        self._lock = threading.Lock()

    def info(self) -> Dict[str, Any]:
        spec = self.table.spec
        return {
            "size": int(self.table.size()),
            "dim": int(spec.dim),
            "capacity": int(spec.capacity),
            "value_dtype": hashtable.dtype_name(spec.value_dtype),
        }

    def lookup(self, ids: np.ndarray):
        n = len(ids)
        padded = np.zeros((_pad_bucket(n),), np.int64)
        padded[:n] = ids
        with self._lock:  # device dispatch serialized per table
            vals, found = self.table.lookup(
                torch.from_numpy(padded).to(self.table.state.device),
                return_exists=True)
            vals = vals[:n].cpu()
            found = found[:n].cpu().numpy()
        if self.tier is not None and not found.all():
            miss = ~found
            tvals, _, _, thit = self.tier.store.get(ids[miss])
            sub = vals[torch.from_numpy(miss)]
            hit = torch.from_numpy(thit)
            sub[hit] = hashtable.from_words(
                tvals, self.tier.var.value_dtype)[hit].to(sub.dtype)
            vals[torch.from_numpy(miss)] = sub
            found = found.copy()
            found[miss] = thit
        return vals.numpy(), found


class _Batcher:
    """Micro-batching: coalesce concurrent lookups into one dispatch."""

    def __init__(self, entry: _TableEntry, max_batch: int = 16384,
                 max_wait_ms: float = 2.0):
        self.entry = entry
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._lock = threading.Condition()
        self._pending = []  # [(ids, event, out_slot)]
        self._runner = threading.Thread(target=self._loop, daemon=True)
        self._stop = False
        self._runner.start()

    def shutdown(self):
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        self._runner.join(timeout=2)

    def lookup(self, ids: np.ndarray):
        ev = threading.Event()
        slot: list = [None]
        with self._lock:
            self._pending.append((ids, ev, slot))
            self._lock.notify_all()
        ev.wait(timeout=30)
        if slot[0] is None:
            raise TimeoutError("lookup batch timed out")
        return slot[0]

    def _loop(self):
        while True:
            with self._lock:
                while not self._pending and not self._stop:
                    self._lock.wait(timeout=0.1)
                if self._stop:
                    for _, ev, slot in self._pending:
                        slot[0] = (np.zeros((0,)), np.zeros((0,), bool))
                        ev.set()
                    return
                deadline = time.monotonic() + self.max_wait
                total = sum(len(p[0]) for p in self._pending)
                while (total < self.max_batch
                       and time.monotonic() < deadline):
                    self._lock.wait(timeout=max(
                        deadline - time.monotonic(), 0.0005))
                    total = sum(len(p[0]) for p in self._pending)
                batch = self._pending
                self._pending = []
            ids = np.concatenate([p[0] for p in batch])
            try:
                vals, found = self.entry.lookup(ids)
            except Exception as e:  # report per-request
                for _, ev, slot in batch:
                    slot[0] = e
                    ev.set()
                continue
            off = 0
            for req_ids, ev, slot in batch:
                n = len(req_ids)
                slot[0] = (vals[off:off + n], found[off:off + n])
                off += n
                ev.set()


class EmbeddingServer:
    """HTTP serving front-end over one or more tables.

    ``tables``: {name: FrozenTable}; ``tiers={name: SpillTier}`` reads a
    table's misses through its host-DRAM tier. ``token`` requires
    ``Authorization: Bearer <token>``; ``tls_cert``/``tls_key`` serve
    HTTPS."""

    def __init__(self, tables: Dict[str, Any],
                 tiers: Optional[Dict[str, Any]] = None,
                 host: str = "127.0.0.1", port: int = 8501,
                 max_batch: int = 16384, max_wait_ms: float = 2.0,
                 token: Optional[str] = None,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None):
        tiers = tiers or {}
        expect_auth = f"Bearer {token}" if token else None
        self._entries = {name: _TableEntry(tbl, tiers.get(name))
                         for name, tbl in tables.items()}
        self._batchers = {
            name: _Batcher(e, max_batch, max_wait_ms)
            for name, e in self._entries.items()
        }
        entries, batchers = self._entries, self._batchers

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _authed(self) -> bool:
                if expect_auth is None:
                    return True
                if self.headers.get("Authorization") == expect_auth:
                    return True
                self._send(401, {"error": "unauthorized"})
                return False

            def _send(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if not self._authed():
                    return
                if self.path == "/v1/status":
                    self._send(200, {
                        "tables": {n: e.info() for n, e in entries.items()}
                    })
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if not self._authed():
                    return
                if self.path != "/v1/lookup":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n))
                    name = req.get("table")
                    if name not in batchers:
                        self._send(404, {"error": f"no table {name}"})
                        return
                    ids = np.asarray(req["ids"], np.int64)
                    out = batchers[name].lookup(ids)
                    if isinstance(out, Exception):
                        raise out
                    vals, found = out
                    self._send(200, {
                        "values": np.asarray(vals, np.float64).tolist(),
                        "found": np.asarray(found).astype(bool).tolist(),
                    })
                except Exception as e:
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

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
        self._httpd.server_close()
        for b in self._batchers.values():
            b.shutdown()

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()


class EmbeddingClient:
    """Minimal stdlib client for :class:`EmbeddingServer`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8501,
                 timeout: float = 30.0, token: Optional[str] = None,
                 tls_root: Optional[str] = None):
        self.host, self.port, self.timeout = host, port, timeout
        self.token, self.tls_root = token, tls_root

    def _request(self, method, path, body=None):
        import http.client

        if self.tls_root:
            import ssl

            ctx = ssl.create_default_context(cafile=self.tls_root)
            ctx.check_hostname = False  # serving fleets use IPs/self-signed
            conn = http.client.HTTPSConnection(
                self.host, self.port, timeout=self.timeout, context=ctx)
        else:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout)
        try:
            payload = json.dumps(body).encode() if body is not None else None
            headers = {"Content-Type": "application/json"}
            if self.token:
                headers["Authorization"] = f"Bearer {self.token}"
            conn.request(method, path, body=payload, headers=headers)
            resp = conn.getresponse()
            out = json.loads(resp.read())
            if resp.status != 200:
                raise RuntimeError(out.get("error", f"HTTP {resp.status}"))
            return out
        finally:
            conn.close()

    def status(self):
        return self._request("GET", "/v1/status")

    def lookup(self, table: str, ids):
        out = self._request("POST", "/v1/lookup", {
            "table": table, "ids": np.asarray(ids, np.int64).tolist(),
        })
        return (np.asarray(out["values"], np.float32),
                np.asarray(out["found"], bool))


def load_directory(directory: str, device=None) -> Dict[str, Any]:
    """``{name: FrozenTable}``: every ``*_serving`` compressed export
    under ``directory`` (ops/serving.export_compressed layout), loaded
    onto ``device`` (default CUDA)."""
    import glob
    import os

    from recommenders_addons_tpu_torch.ops.serving import load_compressed
    from recommenders_addons_tpu_torch.utils.config import resolve_device

    dev = resolve_device(device)
    tables = {}
    for meta in sorted(glob.glob(os.path.join(directory,
                                              "*_serving-meta.json"))):
        prefix = meta[: -len("-meta.json")]
        name = os.path.basename(prefix)[: -len("_serving")]
        tables[name] = load_compressed(prefix, device=dev)
    if not tables:
        raise FileNotFoundError(
            f"no *_serving-meta.json exports under {directory}")
    return tables


def serve_directory(directory: str, host: str = "127.0.0.1",
                    port: int = 8501, device=None, **kw) -> EmbeddingServer:
    """Load every ``*_serving`` compressed export under ``directory``
    onto ``device`` (default CUDA) and serve it."""
    return EmbeddingServer(load_directory(directory, device), host=host,
                           port=port, **kw)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", required=True,
                   help="directory of export_compressed artifacts")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8501)
    p.add_argument("--device", default="cuda",
                   help="torch device the tables live on (default cuda)")
    p.add_argument("--max-batch", type=int, default=16384)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--grpc", action="store_true",
                   help="serve gRPC (serving/grpc_server.py; needs grpcio) "
                        "instead of HTTP")
    p.add_argument("--token", default=None,
                   help="require 'Authorization: Bearer <token>'")
    p.add_argument("--tls-cert", default=None, help="PEM cert path")
    p.add_argument("--tls-key", default=None, help="PEM key path")
    args = p.parse_args(argv)
    serve = serve_directory
    if args.grpc:
        from recommenders_addons_tpu_torch.serving.grpc_server import (
            serve_directory_grpc as serve,
        )
    srv = serve(args.dir, host=args.host, port=args.port,
                device=args.device, max_batch=args.max_batch,
                max_wait_ms=args.max_wait_ms, token=args.token,
                tls_cert=args.tls_cert, tls_key=args.tls_key)
    print(f"serving {list(srv._entries)} on {srv.host}:{srv.port}",
          flush=True)
    srv.start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
