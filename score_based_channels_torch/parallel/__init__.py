"""Data parallelism on torch.distributed, the counterpart of the JAX
package's parallel/ (a 1-D ('data',) mesh over processes)."""

from .mesh import (  # noqa: F401
    Mesh, data_sharding, make_mesh, pad_to_multiple, replicate, shard_batch,
)
from .multihost import initialize, is_primary  # noqa: F401
