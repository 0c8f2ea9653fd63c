"""Solver registry: config -> force function.

Counterpart of ``n_body_problem_tpu.ops.registry``. ``"auto"`` resolves by
device type: on ``"cuda"`` to the hand-written kernels, by the same body
count rule as the JAX package uses on the TPU; elsewhere to ``"mxu"``.
``"treecode"`` is the hierarchical treecode (``ops/treecode.py``); its
single-level flat and dense paths are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from n_body_problem_tpu_torch.config import SimConfig, resolve_vip_tiles
from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric, forces, treecode

ForceFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# The JAX package's cap, kept so that both packages pick the same solver for
# the same N. On the TPU it was a VMEM limit of the resident symmetric
# kernel; the CUDA kernel has no such limit. Revisit once both CUDA kernels
# have H100 times across N.
SYMMETRIC_RESIDENT_CAP = 262_144

_NOT_PORTED = {
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
    if solver == "treecode":
        return _treecode_force(cfg, device_type, n)
    raise ValueError(f"unknown solver {solver!r}")


def treecode_not_ported(cfg: SimConfig, device_type: str) -> str | None:
    """Why this treecode configuration cannot run yet, or None when it takes
    the hierarchical path (the only treecode path ported so far)."""
    if not cfg.tree_hier:
        return ("tree_hier=False needs the single-level flat treecode "
                "(ROADMAP §1 item 4)")
    if cfg.tree_flat_cap < 0 or (cfg.tree_flat_cap == 0 and device_type != "cuda"):
        return ("the treecode with tree_flat_cap left at 0 off the GPU (or "
                "-1) runs the dense treecode path (ROADMAP §1 item 10); pin "
                "tree_flat_cap and tree_far_cap to run the hierarchical path")
    if cfg.tree_flat_cap > 0 and cfg.tree_far_cap <= 0:
        return ("tree_flat_cap without tree_far_cap runs the single-level "
                "flat treecode (ROADMAP §1 item 4)")
    return None


def tree_kwargs(cfg: SimConfig) -> tuple[dict, dict]:
    """Keyword arguments of ``treecode.build_tree_hier_cols`` and
    ``treecode.treecode_acc_hier`` for a resolved treecode config."""
    sel = dict(tile=cfg.tree_tile or 32, src_tile=cfg.tree_src_tile,
               theta=cfg.tree_theta,
               max_near=cfg.tree_max_near or treecode.DEFAULT_MAX_NEAR,
               vip_tiles=cfg.tree_vip_tiles)
    build_kw = dict(slack=cfg.tree_near_slack, flat_cap=cfg.tree_flat_cap,
                    far_max=cfg.tree_far_max, far_cap=cfg.tree_far_cap,
                    mac_tau=cfg.tree_hier_tau, mac_tau0=cfg.tree_mac_tau,
                    union_coarse=cfg.tree_hier_union, eps2=cfg.eps2,
                    compensate=cfg.compensate, **sel)
    acc_kw = dict(eps2=cfg.eps2, compensate=cfg.compensate, G=cfg.G,
                  far_max=cfg.tree_far_max, **sel)
    return build_kw, acc_kw


def _treecode_force(cfg: SimConfig, device_type: str, n: int | None) -> ForceFn:
    """The hierarchical treecode as ``(pos, mass) -> acc``, building its
    acceptance lists on every call (``Simulation.run`` keeps them for
    ``tree_rebuild_every`` steps instead). ``pos`` must be Morton-sorted and
    the capacities set (``Simulation`` plans them when they are 0)."""
    why = treecode_not_ported(cfg, device_type)
    if why:
        raise NotImplementedError(why)
    if cfg.tree_flat_cap == 0 or cfg.tree_far_cap == 0:
        raise ValueError("the treecode force needs tree_flat_cap and "
                         "tree_far_cap; Simulation plans them")
    if cfg.tree_vip_tiles == -1:
        cfg = cfg.replace(tree_vip_tiles=resolve_vip_tiles(-1, n if n else 262144))
    build_kw, acc_kw = tree_kwargs(cfg)

    def force(pos, mass):
        aux = treecode.build_tree_hier_cols(pos[:, 0], pos[:, 1], pos[:, 2],
                                            mass, **build_kw)
        return treecode.treecode_acc_hier(pos, mass, aux, **acc_kw)

    return force
