"""recommenders_addons_tpu_torch — the dynamic-embedding framework in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of ``recommenders_addons_tpu`` (JAX/XLA/Pallas), which stays beside
it as the reference. Module and function names follow the JAX package, so
each module here has its counterpart there; table state is a
``TableState`` dataclass of tensors threaded state-in -> state-out.

Every entry point takes ``device=`` and defaults to CUDA; without a card it
raises unless the caller asks for ``device="cpu"``, where each kernel
wrapper runs its plain PyTorch version.

Ported: the serving path (``python -m recommenders_addons_tpu_torch.serving
--dir <export_dir>``), the training path (``Variable.embedding_lookup``
-> ``apply_gradients`` with the named row-wise optimizers), the sparse
lookup API (``de.embedding_lookup_sparse``,
``de.safe_embedding_lookup_sparse``, ``de.apply_sparse_gradients``), the
layers (``nn`` / ``keras.layers``) and the model families in ``models/``
(DLRM, DCN, MovieLens, two-tower retrieval, seq-and-dense), driven by
``train.train_loop`` or their ``run_demo``; and the table lifecycle:
restrict policies, ``Variable.grow``, chunked exports, the object tables
(``de.CuckooHashTable``, ``de.HkvHashTable``), warm start and KV-native
checkpoints (``train.DECheckpoint``), whose sidecar files are the JAX
package's byte for byte; and sharding (``parallel``): ``ShardedVariable``
routes each key to its owner shard by all-to-all over an in-process mesh
(``parallel.create_mesh``; several logical shards may share one card) or
a ``torch.distributed`` process group (``parallel.GroupMesh``), with the
``mesh=`` models and layers and sharded checkpoints; and the host-DRAM
spill tier (``de.SpillTier``, ``de.HybridTable``; ops/spill.py) with its
native C++ store (``native/``) and the networked shared KV tier
(``serving.kv``); the optax-style sparse optimizer
(``de.OptaxSparseOptimizer`` over the optax-shaped ``transforms``) and
the gRPC front end (``serving.GrpcEmbeddingServer``).
"""

from __future__ import annotations

__version__ = "0.1.0"

from recommenders_addons_tpu_torch import dynamic_embedding  # noqa: E402,F401
from recommenders_addons_tpu_torch.ops import transforms  # noqa: E402,F401


def register_all(**_kwargs):
    """A no-op kept for the reference's ``tfra.register_all``, which loads
    custom-op libraries for SavedModel serving; the port has no op
    registry."""
    return None
