"""Solver registry: config -> force function.

Counterpart of ``n_body_problem_tpu.ops.registry``. ``"auto"`` resolves by
device type: on ``"cuda"`` to the hand-written kernels, by the same body
count rule as the JAX package uses on the TPU; elsewhere to ``"mxu"``.
"""

from __future__ import annotations

from typing import Callable

import torch

from n_body_problem_tpu_torch.config import SimConfig
from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric, forces

ForceFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# The JAX package's cap, kept so that both packages pick the same solver for
# the same N. On the TPU it was a VMEM limit of the resident symmetric
# kernel; the CUDA kernel has no such limit. Revisit once both CUDA kernels
# have H100 times across N.
SYMMETRIC_RESIDENT_CAP = 262_144

_NOT_PORTED = {
    "treecode": "ROADMAP §1 item 3 (hierarchical treecode)",
    "pair_matrix": "ROADMAP §1 item 5 (pair_matrix foil)",
}


def resolve_solver(solver: str, device_type: str = "cpu",
                   n: int | None = None) -> str:
    """Resolve ``"auto"`` to a concrete solver name for ``device_type``.

    Raises NotImplementedError for a solver this package does not have yet.
    """
    if solver in _NOT_PORTED:
        raise NotImplementedError(
            f"solver {solver!r} is not ported yet: {_NOT_PORTED[solver]}")
    if solver != "auto":
        return solver
    if device_type != "cuda":
        return "mxu"
    if n is None or n <= SYMMETRIC_RESIDENT_CAP:
        return "pallas_symmetric"
    return "pallas"


def make_force_fn(cfg: SimConfig, device_type: str = "cpu",
                  n: int | None = None) -> ForceFn:
    """Build ``(pos, mass) -> acc`` for the configured solver.

    The returned function needs N already padded as
    :func:`~n_body_problem_tpu_torch.ops.forces.required_padding` says.
    ``n`` only informs the ``"auto"`` resolution.
    """
    solver = resolve_solver(cfg.solver, device_type, n)
    kw = dict(eps2=cfg.eps2, compensate=cfg.compensate, G=cfg.G)

    if solver == "direct":
        return lambda pos, mass: forces.direct_acc(pos, mass, **kw)
    if solver == "blocked":
        return lambda pos, mass: forces.blocked_acc(
            pos, mass, block_size=cfg.block_size, **kw)
    if solver == "mxu":
        return lambda pos, mass: forces.mxu_acc(
            pos, mass, block_size=cfg.block_size, **kw)
    if solver == "pallas":
        return lambda pos, mass: cuda_force.allpairs_acc(
            pos, mass, tile_i=cfg.pallas_tile_i, tile_j=cfg.pallas_tile_j, **kw)
    if solver == "pallas_symmetric":
        return lambda pos, mass: cuda_symmetric.symmetric_acc(
            pos, mass, tile=cfg.pallas_sym_tile,
            precision=cfg.pallas_sym_precision, **kw)
    raise ValueError(f"unknown solver {solver!r}")
