"""Multi-device training and scoring over ``torch.distributed`` (the JAX
package's ``parallel/``): the mesh, multihost, ring attention and the
tensor-parallel rules.  Every module imports torch only."""

from .mesh import create_mesh, replicate, shard_batch  # noqa: F401
from . import multihost  # noqa: F401
from .ring import (  # noqa: F401
    encode_sequence_parallel,
    make_ring_attention,
    ring_attention,
)
