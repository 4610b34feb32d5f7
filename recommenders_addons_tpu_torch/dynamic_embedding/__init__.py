"""Public `dynamic_embedding` API of the port, under the JAX package's
names: tables (``Variable``, ``raw_table``), the sparse optimizers, the
sparse lookup API (``embedding_lookup_sparse``,
``safe_embedding_lookup_sparse``, the ragged lookups), ``de.math`` and
``data_flow``, the scope store (``get_variable``), string hashing, the
serving format, and the table lifecycle: the object tables and their
creators (``CuckooHashTable``, ``HkvHashTable``, ``RedisTable``,
``KVCreator``), the shadow ops, the restrict policies and warm start,
and the host-DRAM spill tier (``SpillTier``, ``ShardedSpillTier``,
``HybridTable``, ``HostKVStore``, ``make_spill_tier``).

Usage::

    from recommenders_addons_tpu_torch import dynamic_embedding as de
"""

from recommenders_addons_tpu_torch.ops.hashing import (  # noqa: F401
    EMPTY_KEY,
    default_partition_fn,
    hash_strings,
)
from recommenders_addons_tpu_torch.ops.hashtable import (  # noqa: F401
    TableSpec,
    TableState,
    unique_static,
)
from recommenders_addons_tpu_torch.ops import hashtable as raw_table  # noqa: F401
from recommenders_addons_tpu_torch.ops.variable import (  # noqa: F401
    EvictStrategy,
    EvictStrategy as HkvEvictStrategy,  # the reference's name
    GraphKeys,
    LookupContext,
    ModelMode,
    Variable,
    clear_variable_store,
    enable_inference_mode,
    enable_train_mode,
    get_model_mode,
    get_variable,
)
from recommenders_addons_tpu_torch.ops.optimizer import (  # noqa: F401
    FTRL,
    SGD,
    Adagrad,
    Adam,
    AdamW,
    DynamicEmbeddingOptimizer,
    Momentum,
    OptaxSparseOptimizer,
    RMSprop,
    SparseOptimizer,
    apply_gradients,
    create_slots,
)
from recommenders_addons_tpu_torch.ops import initializers  # noqa: F401
from recommenders_addons_tpu_torch.ops import de_math as math  # noqa: F401
from recommenders_addons_tpu_torch.ops import data_flow  # noqa: F401
from recommenders_addons_tpu_torch.ops.sparse import (  # noqa: F401
    RaggedIds,
    RaggedValues,
    SparseIds,
    SparseLookupContext,
    apply_sparse_gradients,
    dense_to_sparse,
    embedding_lookup_ragged,
    embedding_lookup_sparse,
    ragged_fill_empty_rows,
    safe_embedding_lookup_sparse,
    sparse_fill_empty_rows,
    sparse_reshape,
)
from recommenders_addons_tpu_torch.ops import sparse as ragged_embedding_ops  # noqa: F401
from recommenders_addons_tpu_torch.ops.table_api import (  # noqa: F401
    CuckooHashTable,
    CuckooHashTableConfig,
    CuckooHashTableCreator,
    DynamicEmbeddingSaver,
    FileSystemSaver,
    HkvHashTable,
    HkvHashTableConfig,
    HkvHashTableCreator,
    KVCreator,
    RedisTable,
    RedisTableConfig,
    RedisTableCreator,
)
from recommenders_addons_tpu_torch.ops import shadow_ops  # noqa: F401
from recommenders_addons_tpu_torch.ops.shadow_ops import (  # noqa: F401
    DEResourceVariable,
    DistributedVariableWrapper,
    EmbeddingWeights,
    HvdVariable,
    ShadowVariable,
    TrainableWrapper,
    trainable_wrapper_filter,
)
from recommenders_addons_tpu_torch.ops.restrict import (  # noqa: F401
    FrequencyRestrictPolicy,
    RestrictPolicy,
    TimestampRestrictPolicy,
)
from recommenders_addons_tpu_torch.ops.warm_start import (  # noqa: F401
    WarmStartHook,
    warm_start,
)
from recommenders_addons_tpu_torch.ops.spill import (  # noqa: F401
    HostKVStore,
    HybridTable,
    ShardedSpillTier,
    SpillTier,
    make_spill_tier,
)
from recommenders_addons_tpu_torch.ops import serving  # noqa: F401
from recommenders_addons_tpu_torch.ops.serving import (  # noqa: F401
    FrozenTable,
    export_compressed,
    freeze,
    load_compressed,
)


def patch_on_tf(*_a, **_k):
    """A no-op kept for the reference's API: the reference patches TF's
    optimizer and saver at import; the port threads its state
    explicitly and needs no patches."""
    return None


def patch_on_tf_save_restore(*_a, **_k):
    """A no-op kept for the reference's API."""
    return None


def embedding_lookup(var, state, ids, **kwargs):
    """Trainable lookup with dedup: ``(emb, ctx)`` (the reference's
    ``embedding_lookup``)."""
    return var.embedding_lookup(state, ids, **kwargs)


# every trainable lookup dedups (the reference's embedding_lookup_unique)
embedding_lookup_unique = embedding_lookup
embedding_lookup_trainable = embedding_lookup


from recommenders_addons_tpu_torch import keras  # noqa: E402,F401
from recommenders_addons_tpu_torch import train  # noqa: E402,F401
