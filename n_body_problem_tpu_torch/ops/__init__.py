from n_body_problem_tpu_torch.ops.forces import (
    direct_acc,
    blocked_acc,
    mxu_acc,
    pair_accel_tile,
)
from n_body_problem_tpu_torch.ops.registry import make_force_fn, resolve_solver
from n_body_problem_tpu_torch.ops import integrators

__all__ = [
    "direct_acc",
    "blocked_acc",
    "mxu_acc",
    "pair_accel_tile",
    "make_force_fn",
    "resolve_solver",
    "integrators",
]
