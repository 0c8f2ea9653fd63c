"""Multi-GPU: the bodies sharded over a ring of ranks on ``torch.distributed``.

Counterpart of ``n_body_problem_tpu.parallel``: the exact ring, the half
ring, the sharded treecode with replicated sources and the staged treecode
(replicated summaries, the near sources streamed round the ring).
"""

from n_body_problem_tpu_torch.parallel.mesh import RingMesh, make_ring_mesh, spawn_ring
from n_body_problem_tpu_torch.parallel.ring import (
    half_ring_acc,
    make_sharded_step,
    ring_acc,
    shard_state,
)
from n_body_problem_tpu_torch.parallel.sharded import ShardedSimulation, eager_run
from n_body_problem_tpu_torch.parallel.stream import (
    make_staged_flat_force,
    make_staged_force,
    make_staged_run,
    staged_acc_ranks,
)
from n_body_problem_tpu_torch.parallel.tree import (
    make_sharded_treecode_force,
    make_sharded_treecode_run,
)

__all__ = [
    "RingMesh",
    "make_ring_mesh",
    "spawn_ring",
    "ring_acc",
    "half_ring_acc",
    "make_sharded_step",
    "shard_state",
    "ShardedSimulation",
    "eager_run",
    "make_sharded_treecode_force",
    "make_sharded_treecode_run",
    "make_staged_force",
    "make_staged_flat_force",
    "make_staged_run",
    "staged_acc_ranks",
]
