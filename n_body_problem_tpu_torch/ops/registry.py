"""Solver registry: config -> force function.

Counterpart of ``n_body_problem_tpu.ops.registry``. ``"auto"`` resolves by
device type: on ``"cuda"`` to the hand-written kernels, by the same body
count rule as the JAX package uses on the TPU; elsewhere to ``"mxu"``.
``"treecode"`` is the treecode (``ops/treecode.py``) on the path the
configuration names (:func:`tree_path`).
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
        return _treecode_force(cfg, n)
    raise ValueError(f"unknown solver {solver!r}")


def tree_path(cfg: SimConfig) -> str:
    """The treecode path a config runs, as the JAX package's
    ``make_treecode_run`` and ``make_force_fn`` choose it: ``"hier"`` with
    both list capacities (and ``tree_hier``), ``"flat"`` with the near-list
    capacity alone, else ``"dense"``. ``Simulation`` plans the capacities
    so that this is the path the JAX package takes for the same N on the TPU
    (on the CPU, the path it takes there)."""
    if cfg.tree_flat_cap > 0:
        return "hier" if cfg.tree_hier and cfg.tree_far_cap > 0 else "flat"
    return "dense"


def tree_kwargs(cfg: SimConfig) -> tuple[dict, dict]:
    """Keyword arguments of the acceptance build and of the force of the
    config's path (``treecode.build_tree_hier_cols`` and
    ``treecode_acc_hier``, ``build_tree_flat`` and ``treecode_acc_flat``, or
    ``build_tree`` and ``treecode_acc``)."""
    path = tree_path(cfg)
    sel = dict(tile=cfg.tree_tile or 32, theta=cfg.tree_theta,
               max_near=cfg.tree_max_near or treecode.DEFAULT_MAX_NEAR,
               vip_tiles=cfg.tree_vip_tiles)
    phys = dict(eps2=cfg.eps2, compensate=cfg.compensate)
    if path == "dense":
        return dict(mac_tau=cfg.tree_mac_tau, **phys, **sel), dict(G=cfg.G, **phys, **sel)
    sel["src_tile"] = cfg.tree_src_tile
    build_kw = dict(slack=cfg.tree_near_slack, flat_cap=cfg.tree_flat_cap, **phys, **sel)
    acc_kw = dict(G=cfg.G, **phys, **sel)
    if path == "flat":
        return dict(build_kw, mac_tau=cfg.tree_mac_tau), acc_kw
    build_kw.update(far_max=cfg.tree_far_max, far_cap=cfg.tree_far_cap,
                    mac_tau=cfg.tree_hier_tau, mac_tau0=cfg.tree_mac_tau,
                    union_coarse=cfg.tree_hier_union)
    return build_kw, dict(acc_kw, far_max=cfg.tree_far_max)


_TREE_FNS = {
    "hier": (lambda pos, mass, **kw: treecode.build_tree_hier_cols(*pos.unbind(1), mass, **kw),
             treecode.treecode_acc_hier),
    "flat": (treecode.build_tree_flat, treecode.treecode_acc_flat),
    "dense": (treecode.build_tree, treecode.treecode_acc),
}


def tree_fns(cfg: SimConfig):
    """``(build(pos, mass) -> lists, force(pos, mass, lists) -> acc)`` of the
    config's treecode path, for a resolved config."""
    build_kw, acc_kw = tree_kwargs(cfg)
    build, acc = _TREE_FNS[tree_path(cfg)]
    return (lambda pos, mass: build(pos, mass, **build_kw),
            lambda pos, mass, aux: acc(pos, mass, aux, **acc_kw))


def _treecode_force(cfg: SimConfig, n: int | None) -> ForceFn:
    """The treecode as ``(pos, mass) -> acc``, building its acceptance lists
    on every call (``Simulation.run`` keeps them for ``tree_rebuild_every``
    steps instead). ``pos`` must be Morton-sorted."""
    if cfg.tree_vip_tiles == -1:
        cfg = cfg.replace(tree_vip_tiles=resolve_vip_tiles(-1, n if n else 262144))
    build, force = tree_fns(cfg)
    return lambda pos, mass: force(pos, mass, build(pos, mass))
