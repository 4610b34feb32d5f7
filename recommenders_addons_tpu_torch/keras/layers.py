"""`de.keras.layers`: the embedding layers under the reference's import
path (they live in ``recommenders_addons_tpu_torch.nn``)."""

from recommenders_addons_tpu_torch.nn.layers import (  # noqa: F401
    AllToAllEmbedding,
    BasicEmbedding,
    Embedding,
    FieldWiseEmbedding,
    HvdAllToAllEmbedding,
    LayerNormalization,
    SquashedEmbedding,
)
