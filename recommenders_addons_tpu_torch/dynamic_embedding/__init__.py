"""Public `dynamic_embedding` API of the port (the serving and training
subset of the JAX package's ``dynamic_embedding``; the table functions,
deferred dedup, bp_v2 and evicted-row capture among them, are
``raw_table``'s).

Usage::

    from recommenders_addons_tpu_torch import dynamic_embedding as de
"""

from recommenders_addons_tpu_torch.ops.hashtable import (  # noqa: F401
    TableSpec,
    TableState,
    unique_static,
)
from recommenders_addons_tpu_torch.ops import hashtable as raw_table  # noqa: F401
from recommenders_addons_tpu_torch.ops.variable import (  # noqa: F401
    EvictStrategy,
    EvictStrategy as HkvEvictStrategy,  # the reference's name
    LookupContext,
    Variable,
)
from recommenders_addons_tpu_torch.ops.optimizer import (  # noqa: F401
    FTRL,
    SGD,
    Adagrad,
    Adam,
    AdamW,
    DynamicEmbeddingOptimizer,
    Momentum,
    RMSprop,
    SparseOptimizer,
    apply_gradients,
    create_slots,
)
from recommenders_addons_tpu_torch.ops import initializers  # noqa: F401
from recommenders_addons_tpu_torch.ops import serving  # noqa: F401
from recommenders_addons_tpu_torch.ops.serving import freeze  # noqa: F401
