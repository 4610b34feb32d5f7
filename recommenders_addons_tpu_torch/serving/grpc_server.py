"""gRPC serving front end for frozen dynamic-embedding tables — the port
of the JAX package's ``serving/grpc_server.py``, with its service name,
wire format and status codes.

No generated protobuf stubs: the service registers generic bytes-in /
bytes-out method handlers (``grpc.method_handlers_generic_handler``) with
a compact little-endian framing, so the dependency stays at ``grpcio``
alone and the hot path never JSON-encodes embedding payloads:

  Lookup request :  u16 name_len | u32 n | name utf8 | i64 ids[n]
  Lookup response:  u32 n | u32 dim | f32 values[n*dim] | u8 found[n]
  Status         :  empty request -> JSON bytes (the shape of /v1/status)

An unknown table answers ``NOT_FOUND``, a failed lookup ``INTERNAL``.
Auth: an optional shared token (``authorization: Bearer <token>``
metadata, else ``UNAUTHENTICATED``) checked by a server interceptor;
optional TLS from PEM cert and key paths. The micro-batching core
(``_TableEntry``, ``_Batcher``) is the HTTP server's, so a table's spill
tier (``tiers=``) is read through for its misses here too.

``grpc`` is imported only inside the functions that need it: importing
this module (and ``serving``) works without ``grpcio``. The lookup's
body, :func:`lookup_bytes`, takes and returns the wire bytes and needs
no transport.
"""

from __future__ import annotations

import json
import struct
from concurrent import futures
from typing import Any, Dict, Optional

import numpy as np

from recommenders_addons_tpu_torch.serving.server import (
    _Batcher,
    _TableEntry,
    load_directory,
)

SERVICE = "tfra.dynamic_embedding.EmbeddingService"


class UnknownTableError(LookupError):
    """A lookup named a table the server does not hold (``NOT_FOUND``)."""


class LookupFailedError(RuntimeError):
    """The table's lookup raised (``INTERNAL``); the message is the
    cause's type and text."""


def _pack_lookup_request(table: str, ids: np.ndarray) -> bytes:
    name = table.encode("utf-8")
    ids = np.ascontiguousarray(ids, np.int64)
    return struct.pack("<HI", len(name), len(ids)) + name + ids.tobytes()


def _unpack_lookup_request(data: bytes):
    name_len, n = struct.unpack_from("<HI", data, 0)
    off = 6
    name = data[off:off + name_len].decode("utf-8")
    off += name_len
    ids = np.frombuffer(data, np.int64, count=n, offset=off)
    return name, ids


def _pack_lookup_response(vals: np.ndarray, found: np.ndarray) -> bytes:
    vals = np.ascontiguousarray(vals, np.float32)
    found = np.ascontiguousarray(found, np.uint8)
    n, dim = vals.shape
    return struct.pack("<II", n, dim) + vals.tobytes() + found.tobytes()


def _unpack_lookup_response(data: bytes):
    n, dim = struct.unpack_from("<II", data, 0)
    off = 8
    vals = np.frombuffer(data, np.float32, count=n * dim,
                         offset=off).reshape(n, dim)
    off += n * dim * 4
    found = np.frombuffer(data, np.uint8, count=n, offset=off).astype(bool)
    return vals, found


def lookup_bytes(batchers: Dict[str, _Batcher], request: bytes) -> bytes:
    """One Lookup call without a transport: the request's bytes in, the
    response's bytes out, through the table's micro-batcher. Raises
    :class:`UnknownTableError` or :class:`LookupFailedError`."""
    name, ids = _unpack_lookup_request(request)
    batcher = batchers.get(name)
    if batcher is None:
        raise UnknownTableError(f"no table {name}")
    out = batcher.lookup(ids)
    if isinstance(out, Exception):
        raise LookupFailedError(f"{type(out).__name__}: {out}") from out
    vals, found = out
    return _pack_lookup_response(np.asarray(vals), np.asarray(found))


class _TokenInterceptor:
    """Rejects calls without the shared bearer token (UNAUTHENTICATED)."""

    def __init__(self, token: str):
        import grpc

        self._expect = f"Bearer {token}"

        def abort(request, context):
            context.abort(grpc.StatusCode.UNAUTHENTICATED, "bad token")

        self._reject = grpc.unary_unary_rpc_method_handler(abort)

    def intercept_service(self, continuation, handler_call_details):
        md = dict(handler_call_details.invocation_metadata or ())
        if md.get("authorization") == self._expect:
            return continuation(handler_call_details)
        return self._reject


class GrpcEmbeddingServer:
    """gRPC front end over one or more tables (FrozenTable, or anything
    with ``.lookup(ids, return_exists=True)`` / ``.spec`` / ``.size()``
    and a ``state`` on its device).

    ``tiers={name: SpillTier}`` reads a table's misses through its
    host-DRAM tier. ``token``: require ``authorization: Bearer <token>``
    metadata. ``tls_cert``/``tls_key``: PEM file paths -> TLS server
    credentials."""

    def __init__(self, tables: Dict[str, Any],
                 tiers: Optional[Dict[str, Any]] = None,
                 host: str = "127.0.0.1", port: int = 8500,
                 token: Optional[str] = None,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 max_batch: int = 16384, max_wait_ms: float = 2.0,
                 max_workers: int = 16):
        import grpc

        tiers = tiers or {}
        self._entries = {name: _TableEntry(tbl, tiers.get(name))
                         for name, tbl in tables.items()}
        self._batchers = {name: _Batcher(e, max_batch, max_wait_ms)
                          for name, e in self._entries.items()}

        def lookup(request: bytes, context) -> bytes:
            try:
                return lookup_bytes(self._batchers, request)
            except UnknownTableError as e:
                context.abort(grpc.StatusCode.NOT_FOUND, str(e))
            except LookupFailedError as e:
                context.abort(grpc.StatusCode.INTERNAL, str(e))

        def status(request: bytes, context) -> bytes:
            return json.dumps({
                "tables": {n: e.info() for n, e in self._entries.items()}
            }).encode()

        handlers = {
            "Lookup": grpc.unary_unary_rpc_method_handler(lookup),
            "Status": grpc.unary_unary_rpc_method_handler(status),
        }
        interceptors = [_TokenInterceptor(token)] if token else []
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            interceptors=interceptors)
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, handlers),))
        addr = f"{host}:{port}"
        if tls_cert and tls_key:
            with open(tls_key, "rb") as f:
                key = f.read()
            with open(tls_cert, "rb") as f:
                cert = f.read()
            creds = grpc.ssl_server_credentials(((key, cert),))
            self.port = self._server.add_secure_port(addr, creds)
        else:
            self.port = self._server.add_insecure_port(addr)
        self.host = host

    def start(self):
        self._server.start()
        return self

    def stop(self, grace: float = 1.0):
        self._server.stop(grace)
        for b in self._batchers.values():
            b.shutdown()

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()


class GrpcEmbeddingClient:
    """Client for :class:`GrpcEmbeddingServer`. ``token`` adds the bearer
    metadata; ``tls_root`` (PEM path) switches to a TLS channel (pass the
    server's certificate for a self-signed deployment)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8500,
                 token: Optional[str] = None,
                 tls_root: Optional[str] = None,
                 timeout: float = 30.0):
        import grpc

        self._timeout = timeout
        self._md = (("authorization", f"Bearer {token}"),) if token else ()
        target = f"{host}:{port}"
        if tls_root:
            with open(tls_root, "rb") as f:
                creds = grpc.ssl_channel_credentials(f.read())
            self._channel = grpc.secure_channel(target, creds)
        else:
            self._channel = grpc.insecure_channel(target)
        self._lookup = self._channel.unary_unary(f"/{SERVICE}/Lookup")
        self._status = self._channel.unary_unary(f"/{SERVICE}/Status")

    def lookup(self, table: str, ids):
        ids = np.asarray(ids, np.int64).reshape(-1)
        resp = self._lookup(_pack_lookup_request(table, ids),
                            timeout=self._timeout, metadata=self._md)
        return _unpack_lookup_response(resp)

    def status(self) -> dict:
        return json.loads(self._status(b"", timeout=self._timeout,
                                       metadata=self._md))

    def close(self):
        self._channel.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def serve_directory_grpc(directory: str, host: str = "127.0.0.1",
                         port: int = 8500, device=None,
                         **kw) -> GrpcEmbeddingServer:
    """The gRPC twin of ``server.serve_directory``: load every
    ``*_serving`` compressed export under ``directory`` onto ``device``
    (default CUDA) and serve it."""
    return GrpcEmbeddingServer(load_directory(directory, device), host=host,
                               port=port, **kw)
