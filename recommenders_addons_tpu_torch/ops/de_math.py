"""`de.math` namespace of the port (the reference's ``math_ops``):
segment combiners and the sparse-tensor helpers the reference groups
here."""

from recommenders_addons_tpu_torch.ops.segment import (  # noqa: F401
    segment_sum,
    sparse_segment_mean,
    sparse_segment_sqrt_n,
    sparse_segment_sum,
    weighted_segment_combine,
)
from recommenders_addons_tpu_torch.ops.sparse import (  # noqa: F401
    sparse_fill_empty_rows,
    sparse_reshape,
)
