"""Layers of the port: the embedding layers and layer normalization
(``nn/layers.py``), the dense MLP tower (``nn/mlp.py``) and DCN-v2's
low-rank cross network (``nn/cross.py``)."""

from recommenders_addons_tpu_torch.nn.layers import (  # noqa: F401
    AllToAllEmbedding,
    BasicEmbedding,
    Embedding,
    FieldWiseEmbedding,
    HvdAllToAllEmbedding,
    LayerNormalization,
    SquashedEmbedding,
)
from recommenders_addons_tpu_torch.nn.cross import LowRankCrossNet  # noqa: F401
from recommenders_addons_tpu_torch.nn.mlp import MLP  # noqa: F401
from recommenders_addons_tpu_torch.nn import mlp  # noqa: F401
