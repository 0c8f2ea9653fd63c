"""Multi-GPU Barnes-Hut: replicated sources, sharded target rows.

Counterpart of ``n_body_problem_tpu.parallel.tree``. Bodies stay globally
Morton-sorted and each rank holds a contiguous block of them, so a
contiguous range of target rows. Per force evaluation every rank gathers
every position (one ``all_gather``), rebuilds the global source summaries
itself, and evaluates its own rows only: the acceptance and work lists are
(K_t / D, ...) against all K_s sources, the near fields read the gathered
bodies, the far fields the global summaries. The VIP split is global and
the same on every rank; each rank's VIP sweep gives a partial reaction,
the ranks' reactions are summed (one ``all_reduce``) and each rank writes
the VIP rows it holds. Every ``tree_rebuild_every`` steps each rank sorts
the gathered columns (the same sort on every rank) and keeps its own slice.

Each force is one per-rank function of tensors, :func:`rank_acc` (its own
rows, the gathered columns and its rank in; its acceleration and partial
VIP reaction out), built on lists from :func:`rank_lists`; the collectives
sit in the thin layer around them (:func:`sharded_tree_parts`,
:func:`make_sharded_treecode_force`). :func:`treecode_acc_ranks` runs the
per-rank functions for every rank in one process, the reactions added over
the ranks, which is what the collectives deliver.

A run is the three pieces of ``simulation.TreeParts`` (the global resort,
the build of the rank's lists, one step on them), which
``ShardedSimulation`` replays as CUDA graphs (``graphs.tree_programs``) and
:func:`chunked_run` loops over eagerly, as the reference.

The paths (:func:`sharded_path`): hierarchical (near kernel 7 in its local
form, far kernels 8/9, VIP kernel 6), single-level flat (7, far kernel 3,
6) and dense (gather 4, near-panel 5, far 3, 6); on the CPU each wrapper
runs its plain twin.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from n_body_problem_tpu_torch.config import SimConfig
from n_body_problem_tpu_torch.simulation import TreeParts, chunk_loop
from n_body_problem_tpu_torch.ops import treecode as tc
from n_body_problem_tpu_torch.parallel.mesh import RingMesh
from n_body_problem_tpu_torch.state import SimState
from n_body_problem_tpu_torch.utils.morton import morton_order


def sharded_path(cfg: SimConfig) -> str:
    """The path a resolved config runs sharded: ``"hier"`` with both list
    capacities and the far bound, ``"flat"`` with the near capacity alone,
    else ``"dense"`` (the JAX package's ``make_sharded_treecode_run``)."""
    if cfg.tree_flat_cap > 0:
        hier = cfg.tree_hier and cfg.tree_far_cap > 0 and cfg.tree_far_max > 0
        return "hier" if hier else "flat"
    return "dense"


def rank_lists(path: str, cfg: SimConfig, pos_l, pos_g, mass_g, rank: int):
    """The work lists of rank ``rank``'s rows ``pos_l`` (B, 3) against every
    body (``pos_g``, ``mass_g``), on ``path``: those of
    ``treecode.build_hier_local``, ``build_flat_local`` or
    ``build_dense_local``. Every rank computes the same global VIP split."""
    common = dict(row_offset=rank * (pos_l.shape[0] // cfg.tree_tile), tile=cfg.tree_tile,
                  theta=cfg.tree_theta, max_near=cfg.tree_max_near,
                  vip_tiles=cfg.tree_vip_tiles, eps2=cfg.eps2, compensate=cfg.compensate)
    if path == "dense":
        return tc.build_dense_local(pos_l, pos_g, mass_g, mac_tau=cfg.tree_mac_tau, **common)
    common.update(src_tile=cfg.tree_src_tile, slack=cfg.tree_near_slack,
                  flat_cap=cfg.tree_flat_cap)
    cols = (*pos_l.unbind(1), *pos_g.unbind(1), mass_g)
    if path == "hier":
        return tc.build_hier_local(*cols, far_max=cfg.tree_far_max, far_cap=cfg.tree_far_cap,
                                   mac_tau=cfg.tree_hier_tau, mac_tau0=cfg.tree_mac_tau,
                                   union_coarse=cfg.tree_hier_union, **common)
    return tc.build_flat_local(*cols, mac_tau=cfg.tree_mac_tau, **common)


def rank_acc(path: str, cfg: SimConfig, pos_l, mass_l, pos_g, mass_g, aux):
    """A rank's treecode force: ``(acc (B, 3), react (W, 3) | None,
    vip_body_g (W,) | None)``, its rows' acceleration with the VIP panel's
    pull added, its partial pull on the panel and the panel's global body
    ids. The reactions, summed over the ranks, are the VIP bodies' whole
    accelerations (:func:`apply_reaction`)."""
    kw = dict(eps2=cfg.eps2, compensate=cfg.compensate, G=cfg.G, tile=cfg.tree_tile,
              vip_tiles=cfg.tree_vip_tiles)
    if path == "dense":
        return tc.dense_local_acc(pos_l, mass_l, pos_g, mass_g, aux, **kw)
    kw.update(src_tile=cfg.tree_src_tile, max_near=cfg.tree_max_near)
    cols = (*pos_l.unbind(1), mass_l, *pos_g.unbind(1), mass_g, aux)
    if path == "hier":
        ax, ay, az, react, idx = tc.hier_local_acc(*cols, far_max=cfg.tree_far_max,
                                                   theta=cfg.tree_theta, **kw)
    else:
        ax, ay, az, react, idx = tc.flat_local_acc(*cols, **kw)
    return torch.stack([ax, ay, az], 1), react, idx


def apply_reaction(acc_l, react, vip_body_g, rank: int) -> torch.Tensor:
    """``acc_l`` with the rows of the VIP bodies this rank holds set to
    their summed reactions. The write is masked: the other VIPs go to a
    discard row past the end (an index there would raise, or assert on the
    card, where JAX drops it)."""
    if react is None:
        return acc_l
    n_l = acc_l.shape[0]
    rel = vip_body_g - rank * n_l
    dest = torch.where((rel >= 0) & (rel < n_l), rel, n_l)
    out = torch.cat([acc_l, acc_l.new_zeros((1, 3))])
    out[dest] = react.to(out.dtype)
    return out[:n_l]


def _reduced(mesh: RingMesh, acc, react, vip_body_g) -> torch.Tensor:
    """A rank's force with the reactions summed over the ranks (one
    ``all_reduce``) written into its VIP rows."""
    if react is None:
        return acc
    return apply_reaction(acc, mesh.all_reduce(react), vip_body_g, mesh.rank)


def treecode_acc_ranks(cfg: SimConfig, pos, mass, size: int):
    """The sharded force of every rank of a ring of ``size``, in this
    process, one rank after another: ``(acc (N, 3), lists)``, the ranks'
    accelerations in rank order and each rank's work lists. Each rank's
    slice of ``pos`` is its rows and all of ``pos`` its gathered columns;
    the partial reactions are added in rank order."""
    path = sharded_path(cfg)
    b = pos.shape[0] // size
    if b * size != pos.shape[0]:
        raise ValueError(f"N={pos.shape[0]} not divisible by {size} ranks")
    mine = [slice(r * b, (r + 1) * b) for r in range(size)]
    lists = [rank_lists(path, cfg, pos[m], pos, mass, r) for r, m in enumerate(mine)]
    parts = [rank_acc(path, cfg, pos[m], mass[m], pos, mass, aux)
             for m, aux in zip(mine, lists)]
    if parts[0][1] is None:
        return torch.cat([p[0] for p in parts]), lists
    react = parts[0][1]
    for p in parts[1:]:
        react = react + p[1]
    return torch.cat([apply_reaction(acc, react, idx, r)
                      for r, (acc, _, idx) in enumerate(parts)]), lists


def merge_rank_lists(path: str, lists, rows: int, entries: int):
    """The ranks' work lists as one device's: each rank's live chunks in
    rank order with its ``rows`` local row ids made global (so the tags
    stay non-decreasing), the masks and dense lists stacked; ``entries``
    source tiles a near chunk. The single-device force
    (``treecode.treecode_acc_hier``, ``treecode_acc_flat``, ``treecode_acc``)
    on them computes what the ranks computed."""
    if path == "dense":
        return (torch.cat([a[0] for a in lists]), torch.cat([a[1] for a in lists]),
                lists[0][2])

    def merged(src_at: int, entries: int):
        src, tgt = [], []
        for r, a in enumerate(lists):
            live = a[src_at + 1] < rows
            src.append(a[src_at].reshape(-1, entries)[live].reshape(-1))
            tgt.append(a[src_at + 1][live] + r * rows)
        return torch.cat(src), torch.cat(tgt).to(torch.int32)

    if path == "flat":
        return (*merged(0, entries), torch.cat([a[2] for a in lists]), lists[0][3])
    return (*merged(0, entries), *merged(2, tc.FAR_ENTRIES), lists[0][4])


def _resorted(state: SimState, ids: torch.Tensor, mesh: RingMesh):
    """The global Morton resort, the same on every rank: gather the body
    columns, sort them by the gathered keys, keep this rank's slice.
    Returns ``(state, ids)``."""
    b = state.n
    cols = mesh.all_gather(torch.cat([state.pos, state.vel, state.acc, state.mass[:, None],
                                      state.eps[:, None]], 1))
    ids_g = mesh.all_gather(ids)
    perm = morton_order(cols[:, 0], cols[:, 1], cols[:, 2], state.n_real)
    mine = perm[mesh.rank * b:(mesh.rank + 1) * b]
    loc = cols[mine]
    state = dataclasses.replace(
        state, pos=loc[:, 0:3].contiguous(), vel=loc[:, 3:6].contiguous(),
        acc=loc[:, 6:9].contiguous(), mass=loc[:, 9].contiguous(), eps=loc[:, 10].contiguous())
    return state, ids_g[mine]


def rank_ids(state: SimState, mesh: RingMesh) -> torch.Tensor:
    """The global slots of this rank's rows, the ids a run starts from."""
    b = state.n
    return torch.arange(mesh.rank * b, (mesh.rank + 1) * b, dtype=torch.int32,
                        device=state.device)


def sharded_tree_parts(cfg: SimConfig, mesh: RingMesh, build: Callable,
                       force: Callable) -> TreeParts:
    """The pieces of a sharded treecode run of this rank's shard: the
    global resort (:func:`_resorted`), ``build(state) -> aux`` (the rank's
    lists, after the gathers they need), one step (Euler or KDK leapfrog)
    with the force ``force(pos_l, mass_l, aux) -> acc_l``, and the time
    and step advanced once, at the end, as in the JAX package's sharded
    run. ``cfg`` must carry the resolved tile, VIP count and capacities
    (``ShardedSimulation`` resolves them)."""
    dt = cfg.dt
    leapfrog = cfg.integrator == "leapfrog"

    def step(state: SimState, aux) -> SimState:
        pos, vel, acc = state.pos, state.vel, state.acc
        if leapfrog:   # KDK, stored-acceleration form
            vel = vel + acc * (0.5 * dt)
            pos = pos + vel * dt
            acc = force(pos, state.mass, aux)
            vel = vel + acc * (0.5 * dt)
        else:
            acc = force(pos, state.mass, aux)
            vel = vel + acc * dt
            pos = pos + vel * dt
        return dataclasses.replace(state, pos=pos, vel=vel, acc=acc)

    def finish(state: SimState, n_steps: int) -> SimState:
        return dataclasses.replace(
            state, time=state.time + torch.full_like(state.time, n_steps * dt),
            step=state.step + n_steps)

    return TreeParts(cfg.tree_rebuild_every, lambda state, ids: _resorted(state, ids, mesh),
                     build, step, finish)


def replicated_parts(cfg: SimConfig, mesh: RingMesh) -> TreeParts:
    """The :class:`~n_body_problem_tpu_torch.simulation.TreeParts` of the
    replicated strategy (``"treecode"``): the build gathers the sorted
    positions and masses (one ``all_gather``) and makes this rank's lists
    (:func:`rank_lists`), kept with the gathered masses; a force gathers
    the positions and evaluates the rank's rows on them (:func:`rank_acc`,
    :func:`_reduced`)."""
    path = sharded_path(cfg)

    def build(state: SimState) -> tuple:
        cols = mesh.all_gather(torch.cat([state.pos, state.mass[:, None]], 1))
        pos_g, mass_g = cols[:, 0:3].contiguous(), cols[:, 3].contiguous()
        return (mass_g, *rank_lists(path, cfg, state.pos, pos_g, mass_g, mesh.rank))

    def force(pos_l, mass_l, aux):
        return _reduced(mesh, *rank_acc(path, cfg, pos_l, mass_l, mesh.all_gather(pos_l),
                                        aux[0], aux[1:]))

    return sharded_tree_parts(cfg, mesh, build, force)


def chunked_run(parts: TreeParts, mesh: RingMesh) -> Callable:
    """The sharded treecode's eager run loop, ``run(state, n_steps) ->
    (state, ids)``: every ``parts.rebuild_every`` steps the global resort
    and the rank's lists, then the chunk's steps on them
    (``simulation.chunk_loop``); ``ids[i]`` is the input slot (global) of
    the body now at this rank's row i. The reference of
    ``ShardedSimulation.run``'s replays."""
    def run(state: SimState, n_steps: int):
        state, ids, _ = chunk_loop(parts, state, rank_ids(state, mesh), n_steps)
        return parts.finish(state, n_steps), ids

    return run


def make_sharded_treecode_run(cfg: SimConfig, mesh: RingMesh) -> Callable:
    """``run(state, n_steps) -> (state, ids)`` of this rank's shard, the
    multi-GPU counterpart of ``simulation.make_treecode_run``, as an eager
    loop (:func:`chunked_run` of :func:`replicated_parts`)."""
    return chunked_run(replicated_parts(cfg, mesh), mesh)


def make_sharded_treecode_force(cfg: SimConfig, mesh: RingMesh) -> Callable:
    """One sharded treecode force, ``(pos_l, mass_l) -> acc_l``, with the
    acceptance built afresh (the leapfrog prime): the dense path, whatever
    the capacities say, as in the JAX package."""
    def force(pos_l, mass_l):
        pos_g, mass_g = mesh.all_gather(pos_l), mesh.all_gather(mass_l)
        aux = rank_lists("dense", cfg, pos_l, pos_g, mass_g, mesh.rank)
        return _reduced(mesh, *rank_acc("dense", cfg, pos_l, mass_l, pos_g, mass_g, aux))

    return force
