"""Serving runtime: a standalone embedding-lookup server over frozen,
compressed tables (ops/serving.py) with optional host-DRAM spill tiers,
answering batched lookups over HTTP and gRPC (binary framing; optional
bearer-token auth and TLS on both; gRPC needs ``grpcio``, imported only
when a gRPC server or client is made), and the networked shared KV tier
(``serving/kv.py``).

    python -m recommenders_addons_tpu_torch.serving --dir <export_dir> --port 8501
    python -m recommenders_addons_tpu_torch.serving --dir <export_dir> --grpc --port 8500
"""

from recommenders_addons_tpu_torch.serving.grpc_server import (  # noqa: F401
    GrpcEmbeddingClient,
    GrpcEmbeddingServer,
    serve_directory_grpc,
)

from recommenders_addons_tpu_torch.serving.kv import (  # noqa: F401
    HostKVServer,
    RemoteKVStore,
    ShardedRemoteKVStore,
)
from recommenders_addons_tpu_torch.serving.server import (  # noqa: F401
    EmbeddingClient,
    EmbeddingServer,
    serve_directory,
)
