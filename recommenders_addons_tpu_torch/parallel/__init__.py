"""Sharded tables over a mesh: the port of the JAX package's
``parallel/`` (``create_mesh``, ``ShardedVariable``) on an in-process
mesh of devices or a ``torch.distributed`` process group."""

from recommenders_addons_tpu_torch.parallel.mesh import (  # noqa: F401
    GroupMesh,
    Mesh,
    create_mesh,
)
from recommenders_addons_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedLookupContext,
    ShardedState,
    ShardedVariable,
)
