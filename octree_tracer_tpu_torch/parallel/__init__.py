"""Row-sharded frames and the adaptive Session over ``torch.distributed``
(the port of the JAX package's ``parallel/``)."""

from .dryrun import dryrun_multichip
from .launch import run_ranks
from .mesh import Mesh, make_mesh, render_frame_sharded, replicate, shard_rows
from .session import ShardedSession

__all__ = [
    "Mesh", "ShardedSession", "dryrun_multichip", "make_mesh", "render_frame_sharded",
    "replicate", "run_ranks", "shard_rows",
]
