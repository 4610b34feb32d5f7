"""Serving runtime: a standalone embedding-lookup server over frozen,
compressed tables (ops/serving.py), answering batched lookups over HTTP
(optional bearer-token auth and TLS).

    python -m recommenders_addons_tpu_torch.serving --dir <export_dir> --port 8501
"""

from recommenders_addons_tpu_torch.serving.server import (  # noqa: F401
    EmbeddingClient,
    EmbeddingServer,
    serve_directory,
)
