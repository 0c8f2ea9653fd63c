"""Multi-GPU Barnes-Hut, staged: ring-streamed source shards, replicated summaries.

Counterpart of ``n_body_problem_tpu.parallel.stream``, the strategy
``"treecode_staged"`` of ``ShardedSimulation``. The replicated sharded
treecode (``parallel/tree.py``) gathers every position each force, so a
rank keeps O(N) source data. Here only the source tiles' summaries are
gathered (11 floats a ``src_tile`` bodies), and the coarser levels of the
hierarchy merge from them on every rank (``treecode._merge_levels``, as one
device merges them), so the far field, flat or hierarchical, needs no body
of another rank. The near field's sources stream round the ring instead:
D stages, in each of which a rank evaluates its rows against the shard it
holds (kernel 7's local form, the visiting shard as its sources) and then
passes the shard on (``RingMesh.shift``). After s hops a rank holds shard
``(rank - s) % D``, so the near lists are compacted per source shard at
build time: the same scores and criterion as one device's, bucketed by the
stage that can serve them. The resident source data drops from O(N) to
O(N / D) plus the summaries.

- The VIP split is global and the same on every rank: each rank takes the
  largest-radius tiles of the gathered raw radii; the panel of VIP bodies
  is the sum over the ranks of each rank's masked pick (each tile has one
  owner), and the ranks' partial reactions are summed into the VIP rows, as
  on the replicated path.
- The MAC's median scale gathers each shard's sampled monopole magnitudes;
  the shard's stride equals the global one, so the samples are one device's
  and every rank takes the same median.
- Every ``tree_rebuild_every`` steps the global Morton resort gathers the
  body columns (``tree._resorted``, an O(N) transient, as in the JAX
  package).

Each force is a per-rank function of tensors (:func:`rank_staged_build`,
:func:`rank_staged_acc`) under a thin layer of collectives. The layer is
written once for the ranks a process holds (:class:`_Held`): one rank of a
world (``all_gather``, ``all_reduce``, the ring's shifts), or every rank of
a ring in this process (:func:`staged_acc_ranks`: a gather is a
concatenation, a visiting shard a slice, and sums add in rank order).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import torch

from n_body_problem_tpu_torch.config import SimConfig
from n_body_problem_tpu_torch.ops import cuda_treecode
from n_body_problem_tpu_torch.ops import treecode as tc
from n_body_problem_tpu_torch.parallel.mesh import RingMesh
from n_body_problem_tpu_torch.parallel.tree import apply_reaction, chunked_run, sharded_tree_parts
from n_body_problem_tpu_torch.simulation import TreeParts

_TINY = 1e-30   # floor of the MAC's median scale, as in the JAX module
_f32 = torch.float32


def staged_shapes(cfg: SimConfig, n_l: int, n_dev: int):
    """The static per-rank plan of ``n_l`` rows on a ring of ``n_dev``:
    ``(tile, src, entries, k_t_l, k_s_l, k_s_g, max_near, cap, vip_src,
    hier)``, ``cap`` a stage's near capacity and ``hier`` ``(plan, far_max,
    far_cap)`` or None (the single-level far field)."""
    tile = cfg.tree_tile or 32
    src = cfg.tree_src_tile
    entries = tc.CHUNK_LANES // src
    k_t_l = n_l // tile
    k_s_l = n_l // src
    k_s_g = k_s_l * n_dev
    if k_s_l < entries:
        # With fewer source tiles than chunk entries, max_near clamps below
        # one chunk and a shard's lists would hold no chunk: the near field,
        # the self tile too, would fall silently into the far field.
        raise ValueError(
            f"staged streaming needs per-shard K_src >= entries: "
            f"N/D={n_l} gives {k_s_l} source tiles of {src} < "
            f"{entries} chunk entries (CHUNK_LANES={tc.CHUNK_LANES}); "
            f"use fewer devices, more bodies, or a larger src_tile")
    max_near = max(-(-cfg.tree_max_near // entries) * entries, entries)
    max_near = min(max_near, k_s_l - (k_s_l % entries) or k_s_l)
    cap = max(cfg.tree_flat_cap, k_t_l * entries)
    cap = -(-cap // entries) * entries
    vip_src = tc._clamp_vip(tc._vip_src_tiles(cfg.tree_vip_tiles, tile, src), k_s_g)
    hier = None
    if cfg.tree_hier and cfg.tree_far_cap > 0 and cfg.tree_far_max > 0:
        if k_s_g < tc.FAR_ENTRIES:
            raise ValueError(
                f"staged hierarchical treecode needs global K_src >= "
                f"{tc.FAR_ENTRIES}; use the flat far field")
        plan = tc._level_plan(k_s_g, tc.HIER_BRANCH)
        fe = tc.FAR_ENTRIES
        far_max = max(-(-cfg.tree_far_max // fe) * fe, fe)
        far_max = min(far_max, (sum(plan) // fe) * fe)
        far_cap = max(cfg.tree_far_cap, k_t_l * fe)
        far_cap = -(-far_cap // fe) * fe
        hier = (plan, far_max, far_cap)
    return tile, src, entries, k_t_l, k_s_l, k_s_g, max_near, cap, vip_src, hier


# ------------------------------------------------------- per-rank functions
def _cols(pos_l):
    return pos_l.to(_f32).unbind(1)


def _gc3(cfg: SimConfig) -> float:
    """G c^3, the factor of a body's mass in the kernels' rows."""
    return cfg.G * (cfg.compensate * cfg.compensate) * cfg.compensate


def _rows(cfg: SimConfig, pos_l, mass_l) -> torch.Tensor:
    """The rank's rows (n_l, 4) [x y z G c^3 m]: the targets of its near and
    far fields and the rows of its VIP sweep."""
    return torch.stack([*_cols(pos_l), mass_l * _gc3(cfg)], 1).to(_f32)


def _vip_split(radii_g, n_l: int, rank: int, src: int, vip_src: int):
    """``(vip_idx (V,), is_vip_body_l (n_l,))``: the ``vip_src``
    largest-radius tiles of the gathered raw radii (largest first, ties to
    the lower id, as ``lax.top_k``) and which of the rank's bodies they
    hold."""
    k_s_l = n_l // src
    vip_idx = tc._top_k(radii_g[None], vip_src)[1][0]
    is_tile = torch.zeros(radii_g.shape, dtype=torch.bool, device=radii_g.device)
    is_tile.index_fill_(0, vip_idx, True)
    return vip_idx, is_tile[rank * k_s_l:(rank + 1) * k_s_l].repeat_interleave(src)


def _mass_tree(mass_l, is_vip_body_l):
    """The rank's masses with its VIP bodies taken out of the tree."""
    mass_l = mass_l.to(_f32)
    return mass_l if is_vip_body_l is None else torch.where(is_vip_body_l, 0.0, mass_l)


def _summaries(pos_l, mass_tree_l, src: int) -> torch.Tensor:
    """The rank's source tiles' summaries packed (K_s local, 11): com xyz,
    m, radius, the six second moments (``tile_summaries_cols``); one tensor
    of one dtype, what a gather takes."""
    com, m, radius, quad = tc.tile_summaries_cols(*_cols(pos_l), mass_tree_l, src)
    return torch.cat([com, m[:, None], radius[:, None], quad], 1)


def _level0(summaries_g):
    """The level-0 tuple of the gathered packed summaries."""
    s = summaries_g
    return tc._level0_from_summaries(s[:, 0:3], s[:, 3], s[:, 4], s[:, 5:11])


def _samples(cfg: SimConfig, pos_l, summaries_g, n_dev: int) -> torch.Tensor:
    """The rank's share of the MAC's sample: monopole acceleration
    magnitudes of every ``n_l / (2048 / D)``-th row. The shard's stride is
    one device's (``treecode._MEDIAN_SAMPLE`` bodies in all), so the
    gathered samples are one device's."""
    xl, yl, zl = _cols(pos_l)
    step = max(xl.shape[0] // max(tc._MEDIAN_SAMPLE // n_dev, 1), 1)
    cx, cy, cz, m = _level0(summaries_g)[:4]
    return tc._monopole_acc_mags(xl[::step], yl[::step], zl[::step], cx, cy, cz, m,
                                 eps2=cfg.eps2, c2=cfg.compensate * cfg.compensate)


def rank_staged_build(cfg: SimConfig, pos_l, rank: int, gathered: dict):
    """The acceptance build of rank ``rank``'s rows ``pos_l`` (n_l, 3):
    ``(flat_src_all (D, cap), chunk_tgt_all (D, cap / E), near_mask (K_t
    local, K_s global), far_src, far_tgt, vip_idx, is_vip_body_l)``, the
    last four None where the path has none, as the JAX package's
    ``_staged_build`` returns them.

    ``gathered`` holds what the other ranks contribute, every rank's in rank
    order: ``radii`` (the raw tile radii, None without VIPs), ``summaries``
    (K_s global, 11) of the tree masses (so the build needs no masses) and
    ``samples`` (the MAC's magnitudes, None on the single-level path). Row ``d`` of the near lists
    is compacted against shard ``d``'s source tiles alone, its sentinel
    that shard's zero tile; the far lists cover, over the gathered
    hierarchy, what the near entries that landed leave."""
    summaries_g = gathered["summaries"]
    n_l = pos_l.shape[0]
    n_dev = summaries_g.shape[0] // (n_l // cfg.tree_src_tile)
    (tile, src, entries, k_t_l, k_s_l, _, max_near, cap, vip_src,
     hier) = staged_shapes(cfg, n_l, n_dev)
    xl, yl, zl = _cols(pos_l)
    c2 = cfg.compensate * cfg.compensate
    vip_idx = is_vip = None
    if vip_src:
        vip_idx, is_vip = _vip_split(gathered["radii"], n_l, rank, src, vip_src)
    level0 = _level0(summaries_g)
    if hier is not None:
        plan, far_max, far_cap = hier
        levels = tc._merge_levels(level0, plan, tc.HIER_BRANCH)
        a_med = torch.clamp(tc._median(gathered["samples"]), min=_TINY)
        opens, fars, score0, thresh0 = tc._hier_open_masks(
            xl, yl, zl, levels, tile, src, mac_tau=cfg.tree_hier_tau, theta=cfg.tree_theta,
            a_med=a_med, row_offset=rank * k_t_l, mac_tau0=cfg.tree_mac_tau,
            union_coarse=cfg.tree_hier_union)
        evals, reach0 = tc._chain_evals(opens, tc.HIER_BRANCH)
        score0 = torch.where(reach0, score0, -1.0)
    else:
        cx, cy, cz, m, radius = level0[:5]
        score0, thresh0 = tc._opening_scores(
            xl, yl, zl, cx, cy, cz, m, radius, tile, theta=cfg.tree_theta,
            mac_tau=cfg.tree_mac_tau, row_offset=rank * k_t_l, src_tile=src,
            eps2=cfg.eps2, c2=c2)
    lists = [tc._compact_open_lists(score0[:, d * k_s_l:(d + 1) * k_s_l], thresh0,
                                    cfg.tree_near_slack, cap, entries, max_near)
             for d in range(n_dev)]
    near_mask = torch.cat([a[2] for a in lists], 1)
    far_src = far_tgt = None
    if hier is not None:
        far_src, far_tgt = tc._far_lists(fars, evals, reach0, near_mask, far_cap=far_cap,
                                         far_max=far_max)
    return (torch.stack([a[0] for a in lists]), torch.stack([a[1] for a in lists]),
            near_mask.contiguous(), far_src, far_tgt, vip_idx, is_vip)


def _shard_bodies(cfg: SimConfig, pos_l, mass_l, lists) -> torch.Tensor:
    """The rank's shard as near sources, the payload the ring passes on:
    (n_l + S, 4) rows [x y z G c^3 m_tree] with the zero tile last."""
    n_l, src = pos_l.shape[0], cfg.tree_src_tile
    bodies = pos_l.new_zeros((n_l + src, 4), dtype=_f32)
    bodies[:n_l, :3] = pos_l
    bodies[:n_l, 3] = _mass_tree(mass_l, lists[6]) * _gc3(cfg)
    return bodies


def _panel_pick(cfg: SimConfig, pos_l, mass_l, rank: int, vip_idx) -> torch.Tensor:
    """The rank's share of the VIP panel (V S, 4) [x y z G c^3 m]: the rows
    of the VIP tiles it holds, zero for the others. Summed over the ranks,
    the whole panel (each tile has one owner). The masked pick reads tile 0
    for the tiles of other ranks, never past the shard."""
    src = cfg.tree_src_tile
    k_s_l = pos_l.shape[0] // src
    rows = _rows(cfg, pos_l, mass_l)
    rel = vip_idx - rank * k_s_l
    own = (rel >= 0) & (rel < k_s_l)
    pick = rows.reshape(k_s_l, src, 4)[torch.where(own, rel, 0)]
    return torch.where(own[:, None, None], pick, 0.0).reshape(-1, 4)


def rank_staged_acc(cfg: SimConfig, pos_l, mass_l, rank: int, lists, sources,
                    summaries_g, panel):
    """One staged force of rank ``rank``'s rows: ``(acc (n_l, 3), react
    (W, 3) | None, vip_body_g (W,) | None)``, as ``tree.rank_acc`` returns
    them; the reactions summed over the ranks are the VIP bodies' whole
    accelerations (``tree.apply_reaction``).

    ``sources`` gives, stage by stage, the shard the rank holds (shard
    ``(rank - s) % D`` at stage s, :func:`_shard_bodies`); each stage is one
    launch of kernel 7 with the rank's rows as targets and that shard as
    sources, on the stage's list, and the stages add in stage order. Then
    the far field from the gathered summaries (``summaries_g``: kernels 8/9,
    or 3 with the near mask) and the VIP sweep (kernel 6) against ``panel``,
    the summed picks (:func:`_panel_pick`)."""
    n_l = pos_l.shape[0]
    flat_src_all, chunk_tgt_all, near_mask, far_src, far_tgt, vip_idx, _ = lists
    n_dev = flat_src_all.shape[0]
    (tile, src, entries, *_, vip_src, hier) = staged_shapes(cfg, n_l, n_dev)
    phys = dict(eps2=cfg.eps2, c2=cfg.compensate * cfg.compensate)
    rows = _rows(cfg, pos_l, mass_l)
    acc = None
    for s, bodies in enumerate(sources):
        sid = (rank - s) % n_dev
        part = cuda_treecode.near_field(rows, bodies, flat_src_all[sid], chunk_tgt_all[sid],
                                        n=n_l, n_s=n_l, tile=tile, src_tile=src,
                                        entries=entries, **phys)
        acc = part if acc is None else acc + part
    level0 = _level0(summaries_g)
    if hier is not None:
        summ = tc._summary_panel(tc._merge_levels(level0, hier[0], tc.HIER_BRANCH))
        acc = acc + cuda_treecode.far_field_hier(rows, summ, far_src, far_tgt, n=n_l,
                                                 tile=tile, G=cfg.G, **phys)
    else:
        acc = acc + cuda_treecode.far_field_single(rows, tc._summary_panel([level0]),
                                                   near_mask, n=n_l, tile=tile, G=cfg.G,
                                                   **phys)
    if not vip_src:
        return acc, None, None
    action, react = cuda_treecode.vip_both(rows, panel, **phys)
    vip_body_g = (vip_idx[:, None] * src
                  + torch.arange(src, device=vip_idx.device)[None, :]).reshape(-1)
    return acc + action, react, vip_body_g


# --------------------------------------------------- the collectives' layer
@dataclasses.dataclass(frozen=True)
class _Held:
    """The ranks of a ring of ``size`` whose shards this process holds and
    how their values meet: with ``mesh``, its one rank, through the
    collectives; without, every rank in turn, a gather a concatenation and
    a sum added in rank order."""

    size: int
    mesh: RingMesh | None = None

    @property
    def ranks(self) -> list[int]:
        return [self.mesh.rank] if self.mesh else list(range(self.size))

    def gather(self, parts: list) -> torch.Tensor:
        """Every rank's part, stacked in rank order (``all_gather``)."""
        return self.mesh.all_gather(parts[0]) if self.mesh else torch.cat(parts)

    def total(self, parts: list) -> torch.Tensor:
        """The sum of every rank's part (``all_reduce``)."""
        if self.mesh:
            return self.mesh.all_reduce(parts[0])
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def visiting(self, bodies: list, i: int) -> Iterator[torch.Tensor]:
        """The shards the ``i``-th held rank holds stage by stage: in a world
        its own, then each passed one rank on (``RingMesh.shift``); here the
        shards themselves. The last stage's shard is not passed on: no stage
        reads it."""
        if self.mesh is None:
            rank = self.ranks[i]
            for s in range(self.size):
                yield bodies[(rank - s) % self.size]
            return
        payload = bodies[0]
        for s in range(self.size):
            yield payload
            if s + 1 < self.size:
                payload = self.mesh.shift(payload, 1)


def _staged_lists(cfg: SimConfig, held: _Held, pos_ls, mass_ls) -> list:
    """Each held rank's lists (:func:`rank_staged_build`), after the three
    gathers the build needs: the raw radii, the summaries of the tree
    masses and the MAC's samples."""
    n_l = pos_ls[0].shape[0]
    *_, vip_src, hier = staged_shapes(cfg, n_l, held.size)
    src = cfg.tree_src_tile
    radii, is_vip = None, [None] * len(pos_ls)
    if vip_src:
        radii = held.gather([tc._tile_radius(*_cols(p), m.to(_f32), src)
                             for p, m in zip(pos_ls, mass_ls)])
        is_vip = [_vip_split(radii, n_l, r, src, vip_src)[1] for r in held.ranks]
    summaries = held.gather([_summaries(p, _mass_tree(m, v), src)
                             for p, m, v in zip(pos_ls, mass_ls, is_vip)])
    samples = None
    if hier is not None:
        samples = held.gather([_samples(cfg, p, summaries, held.size) for p in pos_ls])
    gathered = dict(radii=radii, summaries=summaries, samples=samples)
    return [rank_staged_build(cfg, p, r, gathered) for r, p in zip(held.ranks, pos_ls)]


def _staged_forces(cfg: SimConfig, held: _Held, pos_ls, mass_ls, lists) -> list:
    """Each held rank's staged force on its lists: the summaries gathered
    and the VIP panel summed from the current positions, the near sources
    streamed, and the summed reactions written into the VIP rows."""
    src = cfg.tree_src_tile
    bodies = [_shard_bodies(cfg, p, m, a) for p, m, a in zip(pos_ls, mass_ls, lists)]
    summaries = held.gather([_summaries(p, _mass_tree(m, a[6]), src)
                             for p, m, a in zip(pos_ls, mass_ls, lists)])
    vips = lists[0][5] is not None
    panel = None
    if vips:
        panel = held.total([_panel_pick(cfg, p, m, r, a[5])
                            for r, p, m, a in zip(held.ranks, pos_ls, mass_ls, lists)])
    parts = [rank_staged_acc(cfg, p, m, r, a, held.visiting(bodies, i), summaries, panel)
             for i, (r, p, m, a) in enumerate(zip(held.ranks, pos_ls, mass_ls, lists))]
    if not vips:
        return [acc for acc, _, _ in parts]
    react = held.total([p[1] for p in parts])
    return [apply_reaction(acc, react, idx, r) for r, (acc, _, idx) in zip(held.ranks, parts)]


def make_staged_force(cfg: SimConfig, mesh: RingMesh) -> Callable:
    """One staged force of this rank's shard, ``(pos_l, mass_l) -> acc_l``,
    with the acceptance built afresh (the run loop keeps a build for
    ``tree_rebuild_every`` steps). Flat or hierarchical far field as
    ``cfg.tree_hier`` and ``tree_far_cap`` say, VIPs as ``tree_vip_tiles``.
    ``cfg`` carries explicit ``tree_tile``, ``tree_src_tile``,
    ``tree_max_near`` and ``tree_flat_cap``, a stage's near capacity of the
    rank (``treecode.suggest_flat_cap_sharded`` bounds a rank's whole demand,
    so any one stage's)."""
    held = _Held(mesh.size, mesh)

    def force(pos_l, mass_l):
        lists = _staged_lists(cfg, held, [pos_l], [mass_l])
        return _staged_forces(cfg, held, [pos_l], [mass_l], lists)[0]

    return force


def make_staged_flat_force(cfg: SimConfig, mesh: RingMesh) -> Callable:
    """The JAX package's earlier name of :func:`make_staged_force`, kept as
    its alias."""
    return make_staged_force(cfg, mesh)


def staged_parts(cfg: SimConfig, mesh: RingMesh) -> TreeParts:
    """The ``simulation.TreeParts`` of the staged strategy
    (``"treecode_staged"``): the global resort, this rank's staged lists
    (:func:`_staged_lists`, after its three gathers), and a step with
    ring-streamed near sources (:func:`_staged_forces`). Between steps a
    rank keeps its shard's columns, its lists and nothing of another
    rank's bodies."""
    held = _Held(mesh.size, mesh)

    def build(state) -> tuple:
        return tuple(_staged_lists(cfg, held, [state.pos], [state.mass])[0])

    def force(pos_l, mass_l, aux):
        return _staged_forces(cfg, held, [pos_l], [mass_l], [aux])[0]

    return sharded_tree_parts(cfg, mesh, build, force)


def make_staged_run(cfg: SimConfig, mesh: RingMesh) -> Callable:
    """``run(state, n_steps) -> (state, ids)`` of this rank's shard, the
    staged counterpart of ``tree.make_sharded_treecode_run``, as an eager
    loop (``tree.chunked_run`` of :func:`staged_parts`)."""
    return chunked_run(staged_parts(cfg, mesh), mesh)


def staged_acc_ranks(cfg: SimConfig, pos, mass, size: int):
    """The staged force of every rank of a ring of ``size``, in this process:
    ``(acc (N, 3), lists)``, the ranks' accelerations in rank order and each
    rank's lists. Rank r's rows are its slice of ``pos``; the gathers are
    concatenations, the visiting shards slices, and the VIP panel and
    reactions are added in rank order."""
    b = pos.shape[0] // size
    if b * size != pos.shape[0]:
        raise ValueError(f"N={pos.shape[0]} not divisible by {size} ranks")
    held = _Held(size)
    pos_ls = [pos[r * b:(r + 1) * b] for r in range(size)]
    mass_ls = [mass[r * b:(r + 1) * b] for r in range(size)]
    lists = _staged_lists(cfg, held, pos_ls, mass_ls)
    return torch.cat(_staged_forces(cfg, held, pos_ls, mass_ls, lists)), lists
