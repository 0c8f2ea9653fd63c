"""Barnes-Hut treecode on the Morton tiling.

Counterpart of ``n_body_problem_tpu.ops.treecode``, all three of its paths
(``Simulation`` picks one, as the JAX package does; see ``simulation.py``).
Bodies must be Morton-sorted; consecutive tiles are then compact clusters.
Every path splits off the VIP tiles first: the largest-radius source tiles
leave the tree and are evaluated exactly in both directions by one
rectangular sweep (``cuda_treecode.vip_both``; the JAX package's
``_vip_both_pallas_cols``). Then, per force evaluation:

- **Hierarchical** (:func:`build_tree_hier_cols`,
  :func:`treecode_acc_hier`): the exact near field over compacted work
  lists, chunk p holding ``entries = CHUNK_LANES / src_tile`` source tiles
  (``flat_src``) for target row ``chunk_tgt[p]`` (``cuda_treecode.
  near_field``; ``_near_field_flat_cols`` there), and a softened monopole +
  quadrupole far field from multi-level node summaries, ``FAR_ENTRIES``
  nodes a chunk (``cuda_treecode.far_field_hier``; ``_far_field_hier_cols``).
- **Single-level flat** (:func:`build_tree_flat_cols`,
  :func:`treecode_acc_flat`): the same near lists, and a far field that
  sweeps all level-0 source tiles except each target row's near mask
  (``cuda_treecode.far_field_single``; ``_far_field_pallas_cols``).
- **Dense** (:func:`build_tree`, :func:`treecode_acc`): fixed-size near
  lists ``near_idx`` (K, M) at one tile size for targets and sources; the
  near tiles are gathered into one panel a target tile
  (``cuda_treecode.gather_panels``; ``_gather_panels_pallas``) and swept
  exactly (``cuda_treecode.near_panel``; ``_near_field_pallas``), and the
  single-level far field covers the rest when ``max_near < K``.

The acceptance lists are built every ``tree_rebuild_every`` steps; node
summaries are recomputed from the current positions on every call. Names
follow the JAX package so each counterpart can be found; the static
planners return identical integers.

The acceptance build is plain PyTorch and never synchronises with the
host: capacities are static, and a capacity overflow is a ``torch.where``.

The hierarchical and flat paths stamp their phases (``utils.profiling``):
the build's ``build.levels``, ``build.open`` (``build.min_dist`` around each
:func:`_min_tile_dist`) and ``build.lists``, whose end carries the lists'
counters (:func:`_list_counters`), and the force's ``force.operands``,
``force.near``, ``force.far`` and ``force.vip``. The dense path, the
planners and the sharded helpers stamp nothing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from n_body_problem_tpu_torch.ops import cuda_treecode
from n_body_problem_tpu_torch.utils import profiling
from n_body_problem_tpu_torch.utils.profiling import NO_STAMPS

DEFAULT_TILE = 32
DEFAULT_THETA = 0.55
DEFAULT_MAC_TAU = 2e-4     # level-0 (flat) mass-aware MAC tolerance
MAC_REF_KSRC = 4096        # tau calibration point: threshold scales by
                           # sqrt(MAC_REF_KSRC / K_s)
DEFAULT_MAX_NEAR = 416     # fallback when the planner was not consulted
DEFAULT_VIP_TILES = 128
CHUNK_LANES = 2048         # near-work source bodies per work chunk
DEFAULT_SRC_TILE = 64      # source granularity (bodies)
DEFAULT_NEAR_SLACK = 8     # extra closest-far source tiles a target computes exactly
HIER_BRANCH = 2            # nodes merged per level (binary hierarchy)
DEFAULT_HIER_TAU = 0.01    # coarse-level MAC tolerance
FAR_ENTRIES = cuda_treecode.FAR_ENTRIES  # far-list node entries per work chunk
HIER_MIN_NODES = 16        # the coarsest level keeps at least this many nodes
DEFAULT_HIER_TILE = 128    # target-row granularity of the hierarchical path

_TINY = 1e-12
# Largest (rows x columns) block of the acceptance build's distance matrix
# materialised at once, as in the JAX package's chunking (8,192 bodies).
_DIST_BODIES = 8192
# Bodies sampled for the MAC's median acceleration scale.
_MEDIAN_SAMPLE = 2048

_f32 = torch.float32
_i32 = torch.int32


# ------------------------------------------------------------ static plans
def _clamp_vip(vip_tiles: int, k: int) -> int:
    """VIP capacity must leave a tree behind (and stay 0 for tiny K)."""
    return int(min(vip_tiles, k // 4))


def _vip_src_tiles(vip_tiles: int, tile: int, src_tile: int) -> int:
    """The VIP capacity, counted in 32-body units, at source granularity."""
    del tile
    return max(int(vip_tiles * DEFAULT_TILE // src_tile),
               1 if vip_tiles else 0)


def _flat_static(n, tile, src_tile, theta, max_near, vip_tiles):
    if src_tile % tile and tile % src_tile:
        raise ValueError(f"src_tile={src_tile} and tile={tile} must be "
                         f"multiples of one another")
    if n % tile:
        raise ValueError(f"flat treecode: N={n} must be a multiple of "
                         f"tile={tile}")
    if n % src_tile:
        raise ValueError(f"flat treecode: N={n} must be a multiple of "
                         f"src_tile={src_tile}")
    if not (0.0 < theta <= 1.0):
        raise ValueError(f"theta must be in (0, 1], got {theta}")
    if src_tile > CHUNK_LANES:
        raise ValueError(f"src_tile={src_tile} > {CHUNK_LANES}")
    k_t = n // tile
    k_s = n // src_tile
    entries = CHUNK_LANES // src_tile
    if k_s < entries:
        raise ValueError(f"flat path needs K_src >= {entries}; "
                         "use treecode_acc")
    max_near = max(-(-max_near // entries) * entries, entries)
    max_near = min(max_near, k_s - (k_s % entries) or k_s)
    vip_src = _clamp_vip(_vip_src_tiles(vip_tiles, tile, src_tile), k_s)
    return k_t, k_s, entries, max_near, vip_src


def _static_args(n, tile, theta, max_near, vip_tiles):
    """(K, max_near, vip_tiles) of the dense path: the capacity rounded up to
    a multiple of 4 and clamped to K, the VIP count clamped."""
    if n % tile:
        raise ValueError(f"treecode_acc: N={n} must be a multiple of tile={tile}")
    if not (0.0 < theta <= 1.0):
        raise ValueError(f"theta must be in (0, 1], got {theta}")
    k = n // tile
    max_near = min(-(-max_near // 4) * 4, k)
    return k, max_near, _clamp_vip(vip_tiles, k)


def _level_plan(k_s: int, branch: int = HIER_BRANCH,
                min_nodes: int = HIER_MIN_NODES) -> tuple[int, ...]:
    """Node counts per level, finest first."""
    ks = [k_s]
    while ks[-1] % branch == 0 and ks[-1] // branch >= min_nodes:
        ks.append(ks[-1] // branch)
    return tuple(ks)


def _hier_static(n, tile, src_tile, theta, max_near, vip_tiles, far_max,
                 branch):
    k_t, k_s, entries, max_near, vip_src = _flat_static(
        n, tile, src_tile, theta, max_near, vip_tiles)
    if k_s < FAR_ENTRIES:
        raise ValueError(
            f"hierarchical treecode needs K_src >= {FAR_ENTRIES} "
            f"(N >= {FAR_ENTRIES * src_tile}); use the flat path")
    plan = _level_plan(k_s, branch)
    k_total = sum(plan)
    far_max = max(-(-far_max // FAR_ENTRIES) * FAR_ENTRIES, FAR_ENTRIES)
    far_max = min(far_max, (k_total // FAR_ENTRIES) * FAR_ENTRIES)
    return k_t, k_s, entries, max_near, vip_src, plan, k_total, far_max


# --------------------------------------------------------------- summaries
def _tiles(a: torch.Tensor, k: int) -> torch.Tensor:
    return a.reshape(k, a.shape[0] // k)


def tile_summaries(pos, mass, tile: int):
    """:func:`tile_summaries_cols` of (N, 3) positions."""
    return tile_summaries_cols(*pos.unbind(1), mass, tile)


def tile_summaries_cols(xc, yc, zc, mass, tile: int):
    """Per-tile (com (K,3), m_tot (K,), radius (K,), quad (K,6)).

    ``radius`` spans bodies with mass > 0 only; ``quad`` is the raw second
    moment sum_a m_a outer(d_a, d_a), packed [xx, yy, zz, xy, xz, yz].
    Massless tiles get m_tot = radius = quad = 0.
    """
    (cx, cy, cz, m_tot, radius, _, q) = _level0(xc, yc, zc, mass, tile)
    return torch.stack([cx, cy, cz], 1), m_tot, radius, torch.stack(q, 1)


def _level0(xc, yc, zc, mass, src_tile: int):
    """Level-0 summary tuple (see :func:`_level_summaries`)."""
    k0 = xc.shape[0] // src_tile
    x, y, z, m = (_tiles(a, k0) for a in (xc, yc, zc, mass))
    m_tot = m.sum(1)
    inv = 1.0 / torch.clamp(m_tot, min=_TINY)
    has = m_tot > 0
    cx = torch.where(has, (m * x).sum(1) * inv, x.mean(1))
    cy = torch.where(has, (m * y).sum(1) * inv, y.mean(1))
    cz = torch.where(has, (m * z).sum(1) * inv, z.mean(1))
    dx = x - cx[:, None]
    dy = y - cy[:, None]
    dz = z - cz[:, None]
    r2 = dx * dx + dy * dy + dz * dz
    radius = torch.sqrt(torch.where(m > 0, r2, 0.0).amax(1))
    return _finish(m_tot, cx, cy, cz, radius,
                   (m * dx * dx).sum(1), (m * dy * dy).sum(1),
                   (m * dz * dz).sum(1), (m * dx * dy).sum(1),
                   (m * dx * dz).sum(1), (m * dy * dz).sum(1))


def _finish(m_tot, cx, cy, cz, radius, qxx, qyy, qzz, qxy, qxz, qyz):
    rms2 = (qxx + qyy + qzz) / torch.clamp(m_tot, min=_TINY)
    return (cx, cy, cz, m_tot, radius, rms2, (qxx, qyy, qzz, qxy, qxz, qyz))


def _tile_radius(xc, yc, zc, mass, tile: int) -> torch.Tensor:
    """Radius-only summary (the VIP selector needs nothing else)."""
    k = xc.shape[0] // tile
    x, y, z, m = (_tiles(a, k) for a in (xc, yc, zc, mass))
    inv_m = 1.0 / torch.clamp(m.sum(1), min=_TINY)
    cx = (m * x).sum(1) * inv_m
    cy = (m * y).sum(1) * inv_m
    cz = (m * z).sum(1) * inv_m
    dx = x - cx[:, None]
    dy = y - cy[:, None]
    dz = z - cz[:, None]
    r2 = dx * dx + dy * dy + dz * dz
    return torch.sqrt(torch.where(m > 0, r2, 0.0).amax(1))


def _vip_split(xc, yc, zc, mass, tile: int, vip_tiles: int):
    """(mass_tree, vip_body_idx (W,), is_vip_body (N,)): pull the
    ``vip_tiles`` largest-radius tiles out of the tree."""
    k = xc.shape[0] // tile
    radius = _tile_radius(xc, yc, zc, mass, tile)
    vip_idx = _top_k(radius[None], vip_tiles)[1][0]
    body_idx = (vip_idx[:, None] * tile
                + torch.arange(tile, device=xc.device)[None, :]).reshape(-1)
    is_vip_tile = torch.zeros((k,), dtype=torch.bool, device=xc.device)
    is_vip_tile.index_fill_(0, vip_idx, True)
    is_vip_body = is_vip_tile.repeat_interleave(tile)
    mass_tree = torch.where(is_vip_body, 0.0, mass)
    return mass_tree, body_idx, is_vip_body


def _level_summaries(xc, yc, zc, mass, src_tile: int, plan, branch: int):
    """Multipole summaries for every level of the hierarchy, finest first:
    tuples ``(cx, cy, cz, m_tot, radius, rms2, (qxx, qyy, qzz, qxy, qxz,
    qyz))`` of (K_l,) tensors. com and quad merge exactly (parallel axis);
    radius merges conservatively as max(child distance + child radius)."""
    return _merge_levels(_level0(xc, yc, zc, mass, src_tile), plan, branch)


def _level0_from_summaries(com, m_tot, radius, quad):
    """The level-0 tuple from per-tile summaries as :func:`tile_summaries_cols`
    returns them: the staged sharded treecode builds level 0 on each rank,
    gathers these four arrays and merges the coarser levels from them
    (:func:`_merge_levels`); positions never leave their rank. Bitwise
    :func:`_level0` of the same tiles."""
    return _finish(m_tot, com[:, 0], com[:, 1], com[:, 2], radius,
                   *(quad[:, i] for i in range(6)))


def _merge_levels(level0, plan, branch: int):
    """Branch-``branch`` upward merges of the level tuples."""
    levels = [level0]
    for k in plan[1:]:
        cx, cy, cz, m_tot, radius, _, q = levels[-1]
        qxx, qyy, qzz, qxy, qxz, qyz = q

        def part(a):
            return a.reshape(k, branch)

        mc = part(m_tot)
        mp = mc.sum(1)
        invp = 1.0 / torch.clamp(mp, min=_TINY)
        hasp = mp > 0
        cxp = torch.where(hasp, (mc * part(cx)).sum(1) * invp, part(cx).mean(1))
        cyp = torch.where(hasp, (mc * part(cy)).sum(1) * invp, part(cy).mean(1))
        czp = torch.where(hasp, (mc * part(cz)).sum(1) * invp, part(cz).mean(1))
        ddx = part(cx) - cxp[:, None]
        ddy = part(cy) - cyp[:, None]
        ddz = part(cz) - czp[:, None]
        d2 = ddx * ddx + ddy * ddy + ddz * ddz
        radp = torch.where(mc > 0, torch.sqrt(d2) + part(radius), 0.0).amax(1)
        levels.append(_finish(
            mp, cxp, cyp, czp, radp,
            (part(qxx) + mc * ddx * ddx).sum(1),
            (part(qyy) + mc * ddy * ddy).sum(1),
            (part(qzz) + mc * ddz * ddz).sum(1),
            (part(qxy) + mc * ddx * ddy).sum(1),
            (part(qxz) + mc * ddx * ddz).sum(1),
            (part(qyz) + mc * ddy * ddz).sum(1)))
    return levels


def _summary_panel(levels) -> torch.Tensor:
    """(K_total + 1, 12) node summaries for the far kernel, one dense row
    per node: cx cy cz m qxx qyy qzz qxy qxz qyz tr and a zero pad; the
    last row is the all-zero sentinel (it contributes exactly nothing)."""
    cat = [torch.cat([lv[i] for lv in levels]) for i in range(4)]
    qs = [torch.cat([lv[6][i] for lv in levels]) for i in range(6)]
    tr = qs[0] + qs[1] + qs[2]
    summ = torch.stack(cat + qs + [tr, torch.zeros_like(tr)], 1)
    return torch.cat([summ, summ.new_zeros((1, 12))])


# -------------------------------------------------------------- acceptance
def _min_tile_dist(xc, yc, zc, cx, cy, cz, tile: int) -> torch.Tensor:
    """(K_t, K_s): min over the bodies of target tile i of |y - com_j|,
    computed a block of target tiles at a time."""
    n = xc.shape[0]
    k_t = n // tile
    rows = max(_DIST_BODIES // tile, 1)
    out = []
    for r in range(0, k_t, rows):
        sl = slice(r * tile, min(r + rows, k_t) * tile)
        dx = cx[None, :] - xc[sl, None]
        dy = cy[None, :] - yc[sl, None]
        dz = cz[None, :] - zc[sl, None]
        d2 = dx * dx + dy * dy + dz * dz
        out.append(d2.reshape(-1, tile, cx.shape[0]).amin(1))
    return torch.sqrt(torch.cat(out))


def _monopole_acc_mags(xs, ys, zs, cx, cy, cz, m_tot, *, eps2, c2):
    """(S,) per-G acceleration magnitudes of sample bodies, estimated from
    monopole tile summaries."""
    c3 = c2 * math.sqrt(c2)
    dx = cx[None, :] - xs[:, None]
    dy = cy[None, :] - ys[:, None]
    dz = cz[None, :] - zs[:, None]
    r2 = dx * dx + dy * dy + dz * dz
    u2 = 1.0 / (c2 * r2 + eps2)
    w = m_tot[None, :] * u2 * torch.sqrt(u2) * c3
    ax = (w * dx).sum(1)
    ay = (w * dy).sum(1)
    az = (w * dz).sum(1)
    return torch.sqrt(ax * ax + ay * ay + az * az)


def _median(v: torch.Tensor) -> torch.Tensor:
    """numpy's median: the mean of the two middle values for an even count
    (``torch.median`` would take the lower one)."""
    s = torch.sort(v).values
    k = s.shape[0]
    if k % 2:
        return s[k // 2]
    return s[k // 2 - 1] * 0.5 + s[k // 2] * 0.5


def _median_monopole_acc(xc, yc, zc, cx, cy, cz, m_tot, *, eps2, c2):
    """Median per-G acceleration magnitude of a body sample: the MAC's
    normalisation scale."""
    step = max(xc.shape[0] // _MEDIAN_SAMPLE, 1)
    return _median(_monopole_acc_mags(
        xc[::step], yc[::step], zc[::step], cx, cy, cz, m_tot,
        eps2=eps2, c2=c2))


def _self_overlap(k_t: int, k_s: int, tile: int, src_tile: int,
                  device, row_offset: int = 0) -> torch.Tensor:
    """(K_t, K_s) bool: target row i and source column j share bodies.
    ``row_offset`` maps local target rows to global source columns (a rank
    of the sharded treecode holds rows ``row_offset`` onwards)."""
    rows = torch.arange(k_t, device=device)[:, None] + row_offset
    cols = torch.arange(k_s, device=device)[None, :]
    return (rows // max(src_tile // tile, 1)) == (cols // max(tile // src_tile, 1))


def _flat_mac(min_d, m, radius, a_med, tau: float):
    """The single-level mass-aware MAC: scores m r^3 / d^5 / a_med (K_t, K_s)
    and their threshold tau * sqrt(MAC_REF_KSRC / K_s)."""
    d5 = torch.square(torch.square(min_d)) * min_d
    return ((m * radius * radius * radius)[None, :] / d5 / a_med,
            tau * math.sqrt(MAC_REF_KSRC / m.shape[0]))


def _opening_scores(xc, yc, zc, cx, cy, cz, m_tot, radius, tile: int, *,
                    theta: float, mac_tau: float, row_offset: int = 0,
                    src_tile: int | None = None, eps2: float = 1e-6,
                    c2: float = 0.01, stamp=NO_STAMPS):
    """(scores (K_t, K_s), threshold) of the single-level opening test, self
    tiles +inf: the mass-aware MAC when ``mac_tau > 0``, else the geometric
    radius / min-body-distance against ``theta``. The MAC's median scale
    comes from the target rows given (a rank's own rows on the sharded
    path, as in the JAX package)."""
    src_tile = src_tile or tile
    k_t = xc.shape[0] // tile
    stamp.begin("build.min_dist")
    min_d = torch.clamp(_min_tile_dist(xc, yc, zc, cx, cy, cz, tile), min=_TINY)
    stamp.end("build.min_dist")
    if mac_tau > 0:
        a_med = torch.clamp(_median_monopole_acc(
            xc, yc, zc, cx, cy, cz, m_tot, eps2=eps2, c2=c2), min=_TINY)
        score, thresh = _flat_mac(min_d, m_tot, radius, a_med, mac_tau)
    else:
        score, thresh = radius[None, :] / min_d, theta
    overlap = _self_overlap(k_t, cx.shape[0], tile, src_tile, xc.device, row_offset)
    return torch.where(overlap, torch.inf, score), thresh


def _row_bounds(xc, yc, zc, tile: int):
    """(centroid x, y, z, radius) of each target row: the coarse levels'
    com-minus-row-radius distance bound when ``union_coarse`` is off."""
    k_t = xc.shape[0] // tile
    tx, ty, tz = (_tiles(a, k_t) for a in (xc, yc, zc))
    tcx, tcy, tcz = tx.mean(1), ty.mean(1), tz.mean(1)
    ddx = tx - tcx[:, None]
    ddy = ty - tcy[:, None]
    ddz = tz - tcz[:, None]
    return tcx, tcy, tcz, torch.sqrt((ddx * ddx + ddy * ddy + ddz * ddz).amax(1))


def _hier_open_masks(xc, yc, zc, levels, tile: int, src_tile: int, *,
                     mac_tau: float, theta: float, eps2: float, c2: float,
                     row_offset: int = 0, a_med=None,
                     mac_tau0: float | None = None, union_coarse: bool = True,
                     stamp=NO_STAMPS):
    """Per-level (opens, min_d) and the level-0 score matrix for near
    ranking (self-overlapping nodes forced to +inf).

    ``mac_tau > 0``: open node j for target row i iff
    m_j rms_j^2 r_j / (d_ij - r_j)^5 > tau * a_med, with d the per-body
    union distance to the node's com (at the coarse levels, with
    ``union_coarse`` off, the row-centroid distance minus the row's radius).
    ``mac_tau0 > 0``: level 0 uses the flat criterion
    m r^3 / d^5 > mac_tau0 * sqrt(MAC_REF_KSRC / K_s) * a_med instead.
    ``mac_tau == 0``: the geometric radius / theta test.

    ``a_med`` defaults to the median over the rows in ``xc``; the sharded
    path passes the whole population's, so that every rank applies the same
    threshold, and its rows' ``row_offset``.
    """
    cx0, cy0, cz0, m0 = levels[0][:4]
    if mac_tau > 0 and a_med is None:
        a_med = torch.clamp(_median_monopole_acc(
            xc, yc, zc, cx0, cy0, cz0, m0, eps2=eps2, c2=c2), min=_TINY)
    opens, minds = [], []
    k_t = xc.shape[0] // tile
    score0 = thresh0 = None
    if not union_coarse:
        tcx, tcy, tcz, trad = _row_bounds(xc, yc, zc, tile)
    for lvl, (cx, cy, cz, m, radius, rms2, _) in enumerate(levels):
        if lvl == 0 or union_coarse:
            stamp.begin("build.min_dist")
            min_d = _min_tile_dist(xc, yc, zc, cx, cy, cz, tile)
            stamp.end("build.min_dist")
        else:
            dcx = cx[None, :] - tcx[:, None]
            dcy = cy[None, :] - tcy[:, None]
            dcz = cz[None, :] - tcz[:, None]
            min_d = torch.sqrt(dcx * dcx + dcy * dcy + dcz * dcz) - trad[:, None]
        min_d = torch.clamp(min_d, min=_TINY)
        if mac_tau > 0 and lvl == 0 and mac_tau0:
            score, thresh = _flat_mac(min_d, m, radius, a_med, mac_tau0)
        elif mac_tau > 0:
            amp = m * rms2 * radius
            delta = torch.clamp(min_d - radius[None, :], min=_TINY)
            d5 = torch.square(torch.square(delta)) * delta
            score = amp[None, :] / d5 / a_med
            thresh = mac_tau
        else:
            score = radius[None, :] / min_d
            thresh = theta
        k_l = score.shape[1]
        node_bodies = levels[0][0].shape[0] * src_tile // k_l
        score = torch.where(
            _self_overlap(k_t, k_l, tile, node_bodies, xc.device, row_offset),
            torch.inf, score)
        if lvl == 0:
            score0, thresh0 = score, thresh
        opens.append(score > thresh)
        minds.append(min_d)
    return opens, minds, score0, thresh0


def _chain_evals(opens, branch: int):
    """(evals per level, reach_0): the topmost passing node on each
    root-to-leaf path is evaluated; leaves with no passing ancestor reach
    level 0 (near candidates)."""
    n_levels = len(opens)
    reach = torch.ones_like(opens[-1])
    evals = [None] * n_levels
    for lvl in range(n_levels - 1, -1, -1):
        evals[lvl] = reach & ~opens[lvl]
        if lvl:
            reach = (reach & opens[lvl]).repeat_interleave(branch, dim=1)
    return evals, reach


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, largest
    first, ties to the lower index (as ``lax.top_k`` orders them)."""
    s = torch.sort(x, dim=1, descending=True, stable=True)
    return s.values[:, :k], s.indices[:, :k]


def _acceptance(xc, yc, zc, level0, tile: int, theta: float, max_near: int,
                mac_tau: float = 0.0, eps2: float = 1e-6, c2: float = 0.01,
                row_offset: int = 0):
    """Dense near lists of the target rows in ``xc`` against the tiles of
    ``level0``: (near_idx (K_t, M) int32, the ``max_near`` highest scores of
    each row, self first; near_mask (K_t, K) bool). The mask is scattered
    from the lists, never compared through a (K_t, M, K) tensor. A rank of
    the sharded treecode passes its own rows and their ``row_offset``."""
    cx, cy, cz, m_tot, radius = level0[:5]
    score, _ = _opening_scores(xc, yc, zc, cx, cy, cz, m_tot, radius, tile,
                               theta=theta, mac_tau=mac_tau, row_offset=row_offset,
                               eps2=eps2, c2=c2)
    near_idx = _top_k(score, max_near)[1]
    near_mask = torch.zeros(score.shape, dtype=torch.bool, device=score.device)
    near_mask.scatter_(1, near_idx, True)
    return near_idx.to(_i32), near_mask


def _compact_open_lists(ratio, theta, slack, flat_cap, entries, max_near, tally=None):
    """Compact per-row opening scores into flat work lists:
    (flat_src (flat_cap,), chunk_tgt (flat_cap/E,), near_mask (K_t, K_s)).

    Row i takes ``v_i = round_up(open_count_i + slack, E)`` slots, clamped
    to ``max_near``, best scores first. If the rows ask for more than
    ``flat_cap``, each keeps one chunk and the excess is scaled down
    (chosen by ``torch.where``, with no host synchronisation). Entries with
    a negative score point at the sentinel source ``K_s``; unused chunks
    carry the sentinel target ``K_t``. Both scatters write into a buffer one
    slot longer than the list, whose last slot takes the dropped entries.

    With a list ``tally``, appends (kept, shed) int64 scalars: the entries
    listed, and the opened entries (score above ``theta``) that the row
    capacity ``max_near`` or the list capacity ``flat_cap`` left out.
    """
    k_t, k_s = ratio.shape
    dev = ratio.device
    if flat_cap < k_t * entries:
        raise ValueError(
            f"flat_cap={flat_cap} < one chunk per target row "
            f"({k_t} * {entries}); use suggest_hier")
    vals, near_idx = _top_k(ratio, max_near)
    near_idx = torch.where(vals < 0, k_s, near_idx).to(_i32)
    cnt = (ratio > theta).sum(1, dtype=_i32)
    v = torch.clamp(((cnt + slack + entries - 1) // entries) * entries,
                    entries, max_near)
    total = v.sum()
    extra = v - entries
    # torch.full fills on the device; torch.tensor would copy from the host.
    sf = torch.div(torch.full((), float(flat_cap - k_t * entries), device=dev),
                   torch.clamp(extra.sum(), min=1).to(_f32))
    v_scaled = entries + (torch.floor(extra.to(_f32) * sf).to(_i32)
                          // entries) * entries
    v = torch.where(total > flat_cap, v_scaled, v)
    offs = torch.cumsum(v, 0, dtype=_i32) - v

    s_idx = torch.arange(max_near, device=dev, dtype=_i32)[None, :]
    dest = torch.where(s_idx < v[:, None], offs[:, None] + s_idx, flat_cap)
    flat_src = torch.full((flat_cap + 1,), k_s, dtype=_i32, device=dev)
    flat_src[dest.reshape(-1).long()] = near_idx.reshape(-1)
    flat_src = flat_src[:flat_cap]

    n_chunks = flat_cap // entries
    cpr = max_near // entries
    c_idx = torch.arange(cpr, device=dev, dtype=_i32)[None, :]
    cdest = torch.where(c_idx < (v // entries)[:, None],
                        offs[:, None] // entries + c_idx, n_chunks)
    rows = torch.arange(k_t, device=dev, dtype=_i32)[:, None].expand(k_t, cpr)
    chunk_tgt = torch.full((n_chunks + 1,), k_t, dtype=_i32, device=dev)
    chunk_tgt[cdest.reshape(-1).long()] = rows.reshape(-1)
    chunk_tgt = chunk_tgt[:n_chunks]
    if tally is not None:
        # A row's opened entries rank first: min(cnt, v) of them landed.
        tally.append(((flat_src != k_s).sum(dtype=torch.int64),
                      torch.clamp(cnt - v, min=0).sum(dtype=torch.int64)))

    # The far field complements the entries that landed.
    slot_rows = chunk_tgt.repeat_interleave(entries)
    mask = torch.zeros((k_t + 1, k_s + 1), dtype=torch.bool, device=dev)
    mask.index_put_((slot_rows.long(), flat_src[:n_chunks * entries].long()),
                    torch.ones((), dtype=torch.bool, device=dev))
    return flat_src, chunk_tgt, mask[:k_t, :k_s]


def _hier_lists(xc, yc, zc, mass, *, tile, src_tile, theta, vip_src, plan,
                branch, mac_tau, mac_tau0, eps2, c2, union_coarse, stamp=NO_STAMPS):
    """What the capacity planner and the acceptance build share: (is_vip_body,
    levels, opens, minds, score0, thresh0, evals, reach0)."""
    n = xc.shape[0]
    stamp.begin("build.levels")
    if vip_src:
        mass_tree, _, is_vip_body = _vip_split(xc, yc, zc, mass, src_tile,
                                               vip_src)
    else:
        is_vip_body = torch.zeros((n,), dtype=torch.bool, device=xc.device)
        mass_tree = mass
    levels = _level_summaries(xc, yc, zc, mass_tree, src_tile, plan, branch)
    stamp.begin("build.open")
    opens, minds, score0, thresh0 = _hier_open_masks(
        xc, yc, zc, levels, tile, src_tile, mac_tau=mac_tau, theta=theta,
        eps2=eps2, c2=c2, mac_tau0=mac_tau0, union_coarse=union_coarse, stamp=stamp)
    evals, reach0 = _chain_evals(opens, branch)
    return is_vip_body, levels, opens, minds, score0, thresh0, evals, reach0


def build_tree_hier_cols(
    xc, yc, zc, mass,
    *,
    tile: int = DEFAULT_HIER_TILE,
    src_tile: int = DEFAULT_SRC_TILE,
    theta: float = DEFAULT_THETA,
    max_near: int = DEFAULT_MAX_NEAR,
    vip_tiles: int = DEFAULT_VIP_TILES,
    slack: int = DEFAULT_NEAR_SLACK,
    flat_cap: int,
    far_max: int,
    far_cap: int,
    branch: int = HIER_BRANCH,
    mac_tau: float = DEFAULT_HIER_TAU,
    mac_tau0: float | None = None,
    eps2: float = 1e-6,
    compensate: float = 0.1,
    union_coarse: bool = True,
):
    """Hierarchical acceptance structures:
    ``(flat_src, chunk_tgt, far_src, far_tgt, is_vip_body)``.

    The near lists as described in :func:`_compact_open_lists`, plus
    compacted multi-level far lists (``far_cap`` node ids in chunks of
    ``FAR_ENTRIES``, per-target contiguous, tagged by ``far_tgt``). Together
    they cover every (target row, source leaf) pair once: near exactly,
    everything else at its topmost accepted ancestor. Size the capacities
    with :func:`suggest_hier`.
    """
    n = xc.shape[0]
    (_, _, entries, max_near, vip_src, plan, _,
     far_max) = _hier_static(n, tile, src_tile, theta, max_near, vip_tiles,
                             far_max, branch)
    xc, yc, zc, mass = (a.to(_f32) for a in (xc, yc, zc, mass))
    st = profiling.stamper(xc.device)
    (is_vip_body, levels, _, minds, score0, thresh0, evals,
     reach0) = _hier_lists(xc, yc, zc, mass, tile=tile, src_tile=src_tile,
                           theta=theta, vip_src=vip_src, plan=plan,
                           branch=branch, mac_tau=mac_tau, mac_tau0=mac_tau0,
                           eps2=eps2, c2=compensate * compensate,
                           union_coarse=union_coarse, stamp=st)
    st.begin("build.lists")
    tally = [] if st.live else None
    lists = _hier_compact(levels, minds, score0, thresh0, evals, reach0, slack=slack,
                          flat_cap=flat_cap, entries=entries, max_near=max_near,
                          far_cap=far_cap, far_max=far_max, tally=tally)
    st.end("build.lists", None if tally is None else
           _list_counters(tally, is_vip_body, tile=tile, src_tile=src_tile))
    return (*lists, is_vip_body)


def _list_counters(tally, is_vip_body, *, tile: int, src_tile: int) -> torch.Tensor:
    """The build's counters (``utils.profiling.COUNTERS``), an int64 (8,)
    tensor on the device, from the near and far compactions' (kept, shed)
    entries: those, the VIP bodies, and what a step on the lists computes:
    near body pairs (a kept near entry is a source tile against a target
    row), far body-node terms (a kept far entry is a node against a row)
    and VIP body pairs (every body against every VIP body)."""
    (near_kept, near_shed), (far_kept, far_shed) = tally
    vip = is_vip_body.sum(dtype=torch.int64)
    return torch.stack([near_kept, near_shed, far_kept, far_shed, vip,
                        near_kept * (src_tile * tile), far_kept * tile,
                        vip * is_vip_body.shape[0]])


def _hier_compact(levels, minds, score0, thresh0, evals, reach0, *, slack, flat_cap,
                  entries, max_near, far_cap, far_max, tally=None):
    """The hierarchical build's work lists from its open masks:
    ``(flat_src, chunk_tgt, far_src, far_tgt)``; ``tally`` as
    :func:`_compact_open_lists`'s, near then far."""
    # Near: only leaves the chain reaches (a leaf under an accepted
    # ancestor is already covered: score -1 ranks it out as a sentinel).
    score0 = torch.where(reach0, score0, -1.0)
    flat_src, chunk_tgt, near_mask = _compact_open_lists(
        score0, thresh0, slack, flat_cap, entries, max_near, tally)
    return (flat_src, chunk_tgt,
            *_far_lists(levels, minds, evals, reach0, near_mask, far_cap=far_cap,
                        far_max=far_max, tally=tally))


def _far_lists(levels, minds, evals, reach0, near_mask, *, far_cap, far_max, tally=None):
    """``(far_src, far_tgt)``: the level-0 complements of the near entries
    that landed (``near_mask``), plus the chain evals at coarser levels,
    ranked by monopole strength m / d^2 so an overflow sheds the weakest
    contributors."""
    evals = [reach0 & ~near_mask] + list(evals[1:])
    key = torch.cat([torch.where(ev, lv[3][None, :] / (md * md), -1.0)
                     for ev, lv, md in zip(evals, levels, minds)], 1)
    far_src, far_tgt, _ = _compact_open_lists(
        key, 0.0, 0, far_cap, FAR_ENTRIES, far_max, tally)
    return far_src, far_tgt


def _tree_mass(xc, yc, zc, mass, tile: int, vip_tiles: int):
    """(mass_tree, is_vip_body): the masses with the VIP tiles taken out."""
    if vip_tiles:
        mass_tree, _, is_vip_body = _vip_split(xc, yc, zc, mass, tile, vip_tiles)
        return mass_tree, is_vip_body
    return mass, torch.zeros(mass.shape, dtype=torch.bool, device=mass.device)


def build_tree(pos, mass, *, tile: int = DEFAULT_TILE,
               theta: float = DEFAULT_THETA, max_near: int = DEFAULT_MAX_NEAR,
               vip_tiles: int = DEFAULT_VIP_TILES, mac_tau: float = 0.0,
               eps2: float = 1e-6, compensate: float = 0.1):
    """Dense acceptance structures ``(near_idx (K, M) int32, near_mask
    (K, K) bool, is_vip_body (N,) bool)``: each target tile's ``max_near``
    worst source tiles (self first) after the VIP split."""
    n = pos.shape[0]
    _, max_near, vip_tiles = _static_args(n, tile, theta, max_near, vip_tiles)
    xc, yc, zc = pos.to(_f32).unbind(1)
    mass_tree, is_vip_body = _tree_mass(xc, yc, zc, mass.to(_f32), tile, vip_tiles)
    near_idx, near_mask = _acceptance(
        xc, yc, zc, _level0(xc, yc, zc, mass_tree, tile), tile, theta, max_near,
        mac_tau=mac_tau, eps2=eps2, c2=compensate * compensate)
    return near_idx, near_mask, is_vip_body


def build_tree_flat_cols(xc, yc, zc, mass, *, tile: int = DEFAULT_TILE,
                         src_tile: int = DEFAULT_SRC_TILE,
                         theta: float = DEFAULT_THETA,
                         max_near: int = DEFAULT_MAX_NEAR,
                         vip_tiles: int = DEFAULT_VIP_TILES,
                         slack: int = DEFAULT_NEAR_SLACK, flat_cap: int,
                         mac_tau: float = 0.0, eps2: float = 1e-6,
                         compensate: float = 0.1):
    """Single-level flat acceptance structures ``(flat_src, chunk_tgt,
    near_mask (K_t, K_s) bool, is_vip_body)``: the near work lists as
    described in :func:`_compact_open_lists`, and the mask of the entries
    that landed, which the far field leaves out. Size ``flat_cap`` with
    :func:`suggest_flat_cap`."""
    n = xc.shape[0]
    _, _, entries, max_near, vip_src = _flat_static(n, tile, src_tile, theta,
                                                    max_near, vip_tiles)
    xc, yc, zc, mass = (a.to(_f32) for a in (xc, yc, zc, mass))
    st = profiling.stamper(xc.device)
    st.begin("build.levels")
    mass_tree, is_vip_body = _tree_mass(xc, yc, zc, mass, src_tile, vip_src)
    cx, cy, cz, m_tot, radius = _level0(xc, yc, zc, mass_tree, src_tile)[:5]
    st.begin("build.open")
    score, thresh = _opening_scores(
        xc, yc, zc, cx, cy, cz, m_tot, radius, tile, theta=theta, mac_tau=mac_tau,
        src_tile=src_tile, eps2=eps2, c2=compensate * compensate, stamp=st)
    st.begin("build.lists")
    tally = [] if st.live else None
    flat_src, chunk_tgt, near_mask = _compact_open_lists(
        score, thresh, slack, flat_cap, entries, max_near, tally)
    # The far kernel reads the mask as contiguous (K_t, K_s) bytes.
    near_mask = near_mask.contiguous()
    if tally is not None:
        # The far field sweeps every level-0 node the mask leaves: no list,
        # nothing shed.
        far = near_mask.numel() - near_mask.sum(dtype=torch.int64)
        tally.append((far, torch.zeros_like(far)))
    st.end("build.lists", None if tally is None else
           _list_counters(tally, is_vip_body, tile=tile, src_tile=src_tile))
    return flat_src, chunk_tgt, near_mask, is_vip_body


def build_tree_flat(pos, mass, **kw):
    """:func:`build_tree_flat_cols` of (N, 3) positions."""
    return build_tree_flat_cols(*pos.unbind(1), mass, **kw)


def aux_from_numpy(aux, device=None):
    """The five acceptance arrays of either package (e.g. the JAX
    ``build_tree_hier_cols`` output through ``np.asarray``) as this
    package's tensors: int32 lists and a bool VIP mask."""
    flat_src, chunk_tgt, far_src, far_tgt, is_vip = (np.asarray(a) for a in aux)
    as_i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=device)  # noqa: E731
    return (as_i32(flat_src), as_i32(chunk_tgt), as_i32(far_src),
            as_i32(far_tgt), torch.as_tensor(is_vip.astype(bool), device=device))


# ------------------------------------------------------------------ forces
def _vip_tile_index(is_vip_body, k_s: int, src_tile: int,
                    vip_src: int) -> torch.Tensor:
    """(vip_src,) ascending ids of the VIP source tiles, without a host
    sync (``jnp.nonzero(size=...)`` in the JAX package): each VIP tile is
    scattered to its rank, the rest to a slot past the end."""
    is_tile = is_vip_body.reshape(k_s, src_tile)[:, 0]
    rank = torch.cumsum(is_tile, 0) - 1
    dest = torch.where(is_tile, rank, vip_src)
    out = torch.zeros((vip_src + 1,), dtype=torch.int64, device=is_tile.device)
    out[dest] = torch.arange(k_s, device=is_tile.device)
    return out[:vip_src]


def kernel_operands(pos, mass, is_vip_body, *, compensate: float = 0.1,
                    G: float = 1.0, src_tile: int = DEFAULT_SRC_TILE,
                    vip_src: int, plan, branch: int = HIER_BRANCH) -> dict:
    """What the kernels of one force evaluation take, in the GPU layouts of
    ``ops/cuda_treecode.py``: ``bodies`` (N + S, 4) with the VIP bodies
    massless and a zero tile last, ``summ`` (K_total + 1, 12) node rows of
    the levels ``plan`` from the current positions (None when ``plan`` is
    None), and for the VIP sweep ``rows`` (N, 4), ``panel`` (W, 4) and
    ``vip_tile_idx`` (None without VIPs). The single-level paths pass
    ``plan=(K_s,)``; the dense path's source tile is its target tile."""
    n = pos.shape[0]
    k_s = n // src_tile
    gc3 = G * (compensate * compensate) * compensate
    mass_tree = torch.where(is_vip_body, 0.0, mass) if vip_src else mass
    bodies = pos.new_zeros((n + src_tile, 4))
    bodies[:n, :3] = pos
    bodies[:n, 3] = mass_tree * gc3
    summ = None if plan is None else _summary_panel(_level_summaries(
        pos[:, 0], pos[:, 1], pos[:, 2], mass_tree, src_tile, plan, branch))
    ops = dict(bodies=bodies, summ=summ, rows=None, panel=None, vip_tile_idx=None)
    if vip_src:
        # VIP bodies are whole source tiles, so the panel gather (and the
        # reaction overwrite) are row slices of the (K_s, S, .) view.
        idx = _vip_tile_index(is_vip_body, k_s, src_tile, vip_src)
        rows = torch.cat([pos, (mass * gc3)[:, None]], 1)
        ops.update(rows=rows, vip_tile_idx=idx,
                   panel=rows.reshape(k_s, src_tile, 4)[idx].reshape(-1, 4))
    return ops


def _add_vips(acc, ops, tile: int, *, eps2: float, c2: float) -> torch.Tensor:
    """``acc`` plus the VIP panel's exact pull, with the VIP bodies' rows
    overwritten by their exact accelerations (the sweep's reaction). VIP
    bodies are whole tiles, so the overwrite is a row slice of the
    (K, tile, 3) view."""
    action, react = cuda_treecode.vip_both(ops["rows"], ops["panel"], eps2=eps2, c2=c2)
    acc = (acc + action).reshape(-1, tile, 3)
    acc[ops["vip_tile_idx"]] = react.reshape(-1, tile, 3)
    return acc.reshape(-1, 3)


def treecode_acc_hier(
    pos, mass, aux_hier,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    tile: int = DEFAULT_HIER_TILE,
    src_tile: int = DEFAULT_SRC_TILE,
    theta: float = DEFAULT_THETA,
    max_near: int = DEFAULT_MAX_NEAR,
    vip_tiles: int = DEFAULT_VIP_TILES,
    far_max: int = 0,
    branch: int = HIER_BRANCH,
) -> torch.Tensor:
    """Hierarchical treecode acceleration (N, 3) of Morton-sorted bodies.

    ``aux_hier`` comes from :func:`build_tree_hier_cols` with the same
    static knobs. Exact near field + monopole/quadrupole far field at the
    topmost accepted ancestor + the exact two-way VIP sweep, whose
    reaction overwrites the VIP bodies' rows.
    """
    n = pos.shape[0]
    (_, k_s, _, _, vip_src, plan, _, _) = _hier_static(
        n, tile, src_tile, theta, max_near, vip_tiles, far_max, branch)
    c2 = compensate * compensate
    flat_src, chunk_tgt, far_src, far_tgt, is_vip_body = aux_hier
    st = profiling.stamper(pos.device)
    st.begin("force.operands")
    ops = kernel_operands(pos.to(_f32), mass.to(_f32), is_vip_body,
                          compensate=compensate, G=G, src_tile=src_tile,
                          vip_src=vip_src, plan=plan, branch=branch)
    st.begin("force.near")
    acc = cuda_treecode.near_field(ops["bodies"], ops["bodies"], flat_src, chunk_tgt,
                                   n=n, n_s=n, tile=tile, src_tile=src_tile,
                                   entries=CHUNK_LANES // src_tile,
                                   eps2=eps2, c2=c2)
    # One far kernel whatever the panel's size (the TPU kept small panels
    # in VMEM and fetched large ones entry by entry).
    st.begin("force.far")
    acc = acc + cuda_treecode.far_field_hier(ops["bodies"], ops["summ"],
                                             far_src, far_tgt, n=n, tile=tile,
                                             eps2=eps2, c2=c2, G=G)
    if vip_src:
        st.begin("force.vip")
        acc = _add_vips(acc, ops, src_tile, eps2=eps2, c2=c2)
    st.end()
    return acc


def treecode_acc_hier_cols(xc, yc, zc, mass, aux_hier, **kw):
    """Columnar form of :func:`treecode_acc_hier`: (N,) columns in,
    ``(ax, ay, az)`` out, as the JAX package's function takes and gives."""
    acc = treecode_acc_hier(torch.stack([xc, yc, zc], 1), mass, aux_hier, **kw)
    return acc[:, 0], acc[:, 1], acc[:, 2]


def treecode_acc_flat(
    pos, mass, aux_flat,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    tile: int = DEFAULT_TILE,
    src_tile: int = DEFAULT_SRC_TILE,
    theta: float = DEFAULT_THETA,
    max_near: int = DEFAULT_MAX_NEAR,
    vip_tiles: int = DEFAULT_VIP_TILES,
) -> torch.Tensor:
    """Single-level flat treecode acceleration (N, 3) of Morton-sorted
    bodies, ``aux_flat`` from :func:`build_tree_flat_cols` with the same
    static knobs: exact near field over the compacted lists + monopole /
    quadrupole far field of every other level-0 source tile + the exact
    two-way VIP sweep."""
    n = pos.shape[0]
    _, k_s, entries, _, vip_src = _flat_static(n, tile, src_tile, theta,
                                               max_near, vip_tiles)
    c2 = compensate * compensate
    flat_src, chunk_tgt, near_mask, is_vip_body = aux_flat
    st = profiling.stamper(pos.device)
    st.begin("force.operands")
    ops = kernel_operands(pos.to(_f32), mass.to(_f32), is_vip_body,
                          compensate=compensate, G=G, src_tile=src_tile,
                          vip_src=vip_src, plan=(k_s,))
    st.begin("force.near")
    acc = cuda_treecode.near_field(ops["bodies"], ops["bodies"], flat_src, chunk_tgt,
                                   n=n, n_s=n, tile=tile, src_tile=src_tile,
                                   entries=entries, eps2=eps2, c2=c2)
    st.begin("force.far")
    acc = acc + cuda_treecode.far_field_single(ops["bodies"], ops["summ"], near_mask,
                                               n=n, tile=tile, eps2=eps2, c2=c2, G=G)
    if vip_src:
        st.begin("force.vip")
        acc = _add_vips(acc, ops, src_tile, eps2=eps2, c2=c2)
    st.end()
    return acc


def treecode_acc_flat_cols(xc, yc, zc, mass, aux_flat, **kw):
    """Columnar form of :func:`treecode_acc_flat`."""
    acc = treecode_acc_flat(torch.stack([xc, yc, zc], 1), mass, aux_flat, **kw)
    return acc[:, 0], acc[:, 1], acc[:, 2]


def treecode_acc(
    pos, mass, aux=None,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    tile: int = DEFAULT_TILE,
    theta: float = DEFAULT_THETA,
    max_near: int = DEFAULT_MAX_NEAR,
    vip_tiles: int = DEFAULT_VIP_TILES,
    mac_tau: float = 0.0,
) -> torch.Tensor:
    """Dense treecode acceleration (N, 3) of Morton-sorted bodies: each
    target tile's near tiles gathered into one panel and swept exactly, the
    single-level far field over the rest when ``max_near < K`` (else the
    near field is the direct sum), and the exact two-way VIP sweep.

    ``aux`` comes from :func:`build_tree` with the same static knobs; None
    builds it for this call.
    """
    n = pos.shape[0]
    k, max_near, vip_tiles = _static_args(n, tile, theta, max_near, vip_tiles)
    c2 = compensate * compensate
    pos, mass = pos.to(_f32), mass.to(_f32)
    if aux is None:
        aux = build_tree(pos, mass, tile=tile, theta=theta, max_near=max_near,
                         vip_tiles=vip_tiles, mac_tau=mac_tau, eps2=eps2,
                         compensate=compensate)
    near_idx, near_mask, is_vip_body = aux
    ops = kernel_operands(pos, mass, is_vip_body, compensate=compensate, G=G,
                          src_tile=tile, vip_src=vip_tiles,
                          plan=(k,) if max_near < k else None)
    panels = cuda_treecode.gather_panels(ops["bodies"], near_idx, tile=tile)
    acc = cuda_treecode.near_panel(ops["bodies"], panels, tile=tile, eps2=eps2, c2=c2)
    if max_near < k:
        acc = acc + cuda_treecode.far_field_single(ops["bodies"], ops["summ"], near_mask,
                                                   n=n, tile=tile, eps2=eps2, c2=c2, G=G)
    return _add_vips(acc, ops, tile, eps2=eps2, c2=c2) if vip_tiles else acc


# ---------------------------------------------------------- sharded helpers
# A rank of the sharded treecode (``parallel/tree.py``) holds a contiguous
# block of target rows and every body as a source (the gathered columns,
# suffix ``g``; its own, suffix ``l``). Each rank computes the same global VIP
# split and source summaries from the gathered columns, then builds and
# evaluates work lists for its own rows only: row ids are local, source ids
# global. Named as in the JAX package.
def _flat_src_static(n_g: int, tile: int, src_tile: int, max_near: int,
                     vip_tiles: int):
    """(k_s, entries, max_near, vip_src) of a global source population of
    ``n_g`` bodies (the sharded path checks rows and sources apart)."""
    if n_g % src_tile:
        raise ValueError(f"flat treecode: global N={n_g} must be a "
                         f"multiple of src_tile={src_tile}")
    k_s = n_g // src_tile
    entries = CHUNK_LANES // src_tile
    if k_s < entries:
        raise ValueError(f"flat path needs K_src >= {entries}")
    max_near = max(-(-max_near // entries) * entries, entries)
    max_near = min(max_near, k_s - (k_s % entries) or k_s)
    vip_src = _clamp_vip(_vip_src_tiles(vip_tiles, tile, src_tile), k_s)
    return k_s, entries, max_near, vip_src


def build_flat_local(xl, yl, zl, xg, yg, zg, mass_g, *, tile: int, src_tile: int,
                     theta: float, max_near: int, vip_tiles: int, slack: int,
                     flat_cap: int, row_offset: int, mac_tau: float = 0.0,
                     eps2: float = 1e-6, compensate: float = 0.1):
    """Flat acceptance of a rank's target rows against every source:
    ``(flat_src, chunk_tgt, near_mask (K_t local, K_s), is_vip_g (N,))``;
    ``flat_cap`` is the rank's capacity (:func:`suggest_flat_cap_sharded`),
    ``row_offset`` the global id of its first row. The MAC's median scale
    is that of the rank's own rows, as in the JAX package."""
    n_g = xg.shape[0]
    k_s, entries, max_near, vip_src = _flat_src_static(n_g, tile, src_tile, max_near,
                                                       vip_tiles)
    xl, yl, zl, xg, yg, zg, mass_g = (a.to(_f32) for a in (xl, yl, zl, xg, yg, zg, mass_g))
    mass_tree_g, is_vip_g = _tree_mass(xg, yg, zg, mass_g, src_tile, vip_src)
    cx, cy, cz, m_tot, radius = _level0(xg, yg, zg, mass_tree_g, src_tile)[:5]
    score, thresh = _opening_scores(
        xl, yl, zl, cx, cy, cz, m_tot, radius, tile, theta=theta, mac_tau=mac_tau,
        row_offset=row_offset, src_tile=src_tile, eps2=eps2, c2=compensate * compensate)
    flat_src, chunk_tgt, near_mask = _compact_open_lists(
        score, thresh, slack, flat_cap, entries, max_near)
    return flat_src, chunk_tgt, near_mask.contiguous(), is_vip_g


def _local_rows(xl, yl, zl, ml, gc3: float) -> torch.Tensor:
    """A rank's rows (N local, 4) [x y z G c^3 m]: the targets of its near
    and far fields and the rows of its VIP sweep."""
    return torch.stack([xl, yl, zl, ml * gc3], 1).to(_f32)


def _local_vips(acc, rows, ops, src_tile: int, vip_src: int, *, eps2: float, c2: float):
    """``(acc, react (W, 3) | None, vip_body_idx (W,) | None)``: the rank's
    acceleration with the VIP panel's pull added, its partial pull on the
    panel (the caller sums it over the ranks and writes it into the VIP rows
    it holds) and the panel's global body ids."""
    if not vip_src:
        return acc, None, None
    action, react = cuda_treecode.vip_both(rows, ops["panel"], eps2=eps2, c2=c2)
    idx = ops["vip_tile_idx"]
    vip_body_idx = (idx[:, None] * src_tile
                    + torch.arange(src_tile, device=idx.device)[None, :]).reshape(-1)
    return acc + action, react, vip_body_idx


def flat_local_acc(xl, yl, zl, ml, xg, yg, zg, mass_g, aux, *, eps2: float,
                   compensate: float, G: float, tile: int, src_tile: int,
                   max_near: int, vip_tiles: int):
    """Flat treecode acceleration of a rank's rows from every source,
    ``aux`` from :func:`build_flat_local`: ``(ax, ay, az, react, vip_body_idx)``
    (:func:`_local_vips`; columns, as the JAX package returns them). The near kernel takes the rank's rows as its
    targets and the gathered bodies as its sources; the far fields read the
    rank's rows only."""
    flat_src, chunk_tgt, near_mask, is_vip_g = aux
    n_g, n_l = xg.shape[0], xl.shape[0]
    k_s, entries, _, vip_src = _flat_src_static(n_g, tile, src_tile, max_near, vip_tiles)
    c2 = compensate * compensate
    ops = kernel_operands(torch.stack([xg, yg, zg], 1).to(_f32), mass_g.to(_f32), is_vip_g,
                          compensate=compensate, G=G, src_tile=src_tile, vip_src=vip_src,
                          plan=(k_s,))
    rows = _local_rows(xl, yl, zl, ml, G * c2 * compensate)
    acc = cuda_treecode.near_field(rows, ops["bodies"], flat_src, chunk_tgt, n=n_l, n_s=n_g,
                                   tile=tile, src_tile=src_tile, entries=entries,
                                   eps2=eps2, c2=c2)
    acc = acc + cuda_treecode.far_field_single(rows, ops["summ"], near_mask, n=n_l,
                                               tile=tile, eps2=eps2, c2=c2, G=G)
    acc, react, idx = _local_vips(acc, rows, ops, src_tile, vip_src, eps2=eps2, c2=c2)
    return acc[:, 0], acc[:, 1], acc[:, 2], react, idx


def build_hier_local(xl, yl, zl, xg, yg, zg, mass_g, *, tile: int, src_tile: int,
                     theta: float, max_near: int, vip_tiles: int, slack: int,
                     flat_cap: int, far_max: int, far_cap: int, row_offset: int,
                     branch: int = HIER_BRANCH, mac_tau: float = DEFAULT_HIER_TAU,
                     mac_tau0: float | None = None, eps2: float = 1e-6,
                     compensate: float = 0.1, union_coarse: bool = True):
    """Hierarchical acceptance of a rank's target rows against every source:
    ``(flat_src, chunk_tgt, far_src, far_tgt, is_vip_g)``, the multi-level
    form of :func:`build_flat_local`. ``flat_cap`` and ``far_cap`` are the
    rank's capacities (:func:`suggest_hier_sharded`). The MAC's median
    scale is the whole population's, so every rank applies one threshold."""
    n_g = xg.shape[0]
    (_, _, entries, max_near, vip_src, plan, _,
     far_max) = _hier_static(n_g, tile, src_tile, theta, max_near, vip_tiles, far_max,
                             branch)
    xl, yl, zl, xg, yg, zg, mass_g = (a.to(_f32) for a in (xl, yl, zl, xg, yg, zg, mass_g))
    c2 = compensate * compensate
    mass_tree_g, is_vip_g = _tree_mass(xg, yg, zg, mass_g, src_tile, vip_src)
    levels = _level_summaries(xg, yg, zg, mass_tree_g, src_tile, plan, branch)
    a_med = None
    if mac_tau > 0:
        cx0, cy0, cz0, m0 = levels[0][:4]
        a_med = torch.clamp(_median_monopole_acc(xg, yg, zg, cx0, cy0, cz0, m0,
                                                 eps2=eps2, c2=c2), min=_TINY)
    opens, minds, score0, thresh0 = _hier_open_masks(
        xl, yl, zl, levels, tile, src_tile, mac_tau=mac_tau, theta=theta, eps2=eps2,
        c2=c2, row_offset=row_offset, a_med=a_med, mac_tau0=mac_tau0,
        union_coarse=union_coarse)
    evals, reach0 = _chain_evals(opens, branch)
    return (*_hier_compact(levels, minds, score0, thresh0, evals, reach0, slack=slack,
                           flat_cap=flat_cap, entries=entries, max_near=max_near,
                           far_cap=far_cap, far_max=far_max), is_vip_g)


def hier_local_acc(xl, yl, zl, ml, xg, yg, zg, mass_g, aux, *, eps2: float,
                   compensate: float, G: float, tile: int, src_tile: int,
                   max_near: int, vip_tiles: int, far_max: int,
                   theta: float = DEFAULT_THETA, branch: int = HIER_BRANCH):
    """Hierarchical treecode acceleration of a rank's rows from every source,
    ``aux`` from :func:`build_hier_local`: ``(ax, ay, az, react,
    vip_body_idx)``, the multi-level form of :func:`flat_local_acc`."""
    flat_src, chunk_tgt, far_src, far_tgt, is_vip_g = aux
    n_g, n_l = xg.shape[0], xl.shape[0]
    (_, _, entries, _, vip_src, plan, _, _) = _hier_static(
        n_g, tile, src_tile, theta, max_near, vip_tiles, far_max, branch)
    c2 = compensate * compensate
    ops = kernel_operands(torch.stack([xg, yg, zg], 1).to(_f32), mass_g.to(_f32), is_vip_g,
                          compensate=compensate, G=G, src_tile=src_tile, vip_src=vip_src,
                          plan=plan, branch=branch)
    rows = _local_rows(xl, yl, zl, ml, G * c2 * compensate)
    acc = cuda_treecode.near_field(rows, ops["bodies"], flat_src, chunk_tgt, n=n_l, n_s=n_g,
                                   tile=tile, src_tile=src_tile, entries=entries,
                                   eps2=eps2, c2=c2)
    acc = acc + cuda_treecode.far_field_hier(rows, ops["summ"], far_src, far_tgt, n=n_l,
                                             tile=tile, eps2=eps2, c2=c2, G=G)
    acc, react, idx = _local_vips(acc, rows, ops, src_tile, vip_src, eps2=eps2, c2=c2)
    return acc[:, 0], acc[:, 1], acc[:, 2], react, idx


def _near_field_xla(rows, panels, *, eps2: float, c2: float, tile: int) -> torch.Tensor:
    """The dense path's near field (K T, 3) of target rows ``rows`` against
    their gathered ``panels`` (K, M T, 4): the near-panel kernel on the
    card, its plain twin on the CPU (the JAX package's CPU form of the
    same step has this name)."""
    return cuda_treecode.near_panel(rows, panels, tile=tile, eps2=eps2, c2=c2)


# ----------------------------------------------------------------- planners
def hier_counts(pos, mass, *, tile: int = DEFAULT_HIER_TILE,
                src_tile: int = DEFAULT_SRC_TILE,
                theta: float = DEFAULT_THETA,
                vip_tiles: int = DEFAULT_VIP_TILES,
                branch: int = HIER_BRANCH,
                mac_tau: float = DEFAULT_HIER_TAU,
                mac_tau0: float | None = None,
                eps2: float = 1e-6,
                compensate: float = 0.1,
                union_coarse: bool = True):
    """(near_count (K_t,), far_count (K_t,)) of the hierarchical chain on
    this distribution, uncapped: the capacity planner's input."""
    n = pos.shape[0]
    k_s = n // src_tile
    plan = _level_plan(k_s, branch)
    vip_src = _clamp_vip(_vip_src_tiles(vip_tiles, tile, src_tile), k_s)
    pos = pos.to(_f32)
    (_, _, opens, _, _, _, evals, reach0) = _hier_lists(
        pos[:, 0], pos[:, 1], pos[:, 2], mass.to(_f32), tile=tile,
        src_tile=src_tile, theta=theta, vip_src=vip_src, plan=plan,
        branch=branch, mac_tau=mac_tau, mac_tau0=mac_tau0, eps2=eps2,
        c2=compensate * compensate, union_coarse=union_coarse)
    near = (reach0 & opens[0]).sum(1)
    far = sum(ev.sum(1) for ev in evals)
    return near, far


def suggest_hier(pos, mass, *, tile: int = DEFAULT_HIER_TILE,
                 src_tile: int = DEFAULT_SRC_TILE,
                 theta: float = DEFAULT_THETA,
                 vip_tiles: int = DEFAULT_VIP_TILES,
                 slack: int = DEFAULT_NEAR_SLACK,
                 branch: int = HIER_BRANCH,
                 mac_tau: float = DEFAULT_HIER_TAU,
                 mac_tau0: float | None = None,
                 eps2: float = 1e-6,
                 compensate: float = 0.1,
                 union_coarse: bool = True,
                 margin: float = 1.3,
                 far_margin: float = 1.25) -> dict:
    """Host-side capacity planner for the hierarchical path:
    ``{"max_near", "flat_cap", "far_max", "far_cap"}``."""
    near, far = hier_counts(
        pos, mass, tile=tile, src_tile=src_tile, theta=theta,
        vip_tiles=vip_tiles, branch=branch, mac_tau=mac_tau,
        mac_tau0=mac_tau0, eps2=eps2, compensate=compensate,
        union_coarse=union_coarse)
    near = near.cpu().numpy()
    far = far.cpu().numpy()
    entries = CHUNK_LANES // src_tile
    k_t = len(near)

    def rnd(v, e):
        return ((v + e - 1) // e) * e

    max_near = int(rnd(int(math.ceil(near.max() * margin)), entries))
    v = np.maximum(rnd(near + slack, entries), entries)
    flat_cap = int(rnd(max(int(math.ceil(v.sum() * margin)),
                           k_t * entries), entries))
    far_max = int(rnd(int(math.ceil(far.max() * far_margin)), FAR_ENTRIES))
    w = np.maximum(rnd(far, FAR_ENTRIES), FAR_ENTRIES)
    far_cap = int(rnd(max(int(math.ceil(w.sum() * far_margin)),
                          k_t * FAR_ENTRIES), FAR_ENTRIES))
    return {"max_near": max_near, "flat_cap": flat_cap,
            "far_max": far_max, "far_cap": far_cap}


def open_counts(pos, mass, *, tile: int = DEFAULT_TILE,
                theta: float = DEFAULT_THETA,
                vip_tiles: int = DEFAULT_VIP_TILES,
                src_tile: int | None = None, mac_tau: float = 0.0,
                eps2: float = 1e-6, compensate: float = 0.1) -> torch.Tensor:
    """(K_t,) count of source tiles each target row opens (self included),
    after the VIP split; ``src_tile`` defaults to ``tile`` (the dense
    path)."""
    src_tile = src_tile or tile
    k_s = pos.shape[0] // src_tile
    vip_src = _clamp_vip(_vip_src_tiles(vip_tiles, tile, src_tile), k_s)
    xc, yc, zc = pos.to(_f32).unbind(1)
    mass_tree, _ = _tree_mass(xc, yc, zc, mass.to(_f32), src_tile, vip_src)
    cx, cy, cz, m_tot, radius = _level0(xc, yc, zc, mass_tree, src_tile)[:5]
    score, thresh = _opening_scores(
        xc, yc, zc, cx, cy, cz, m_tot, radius, tile, theta=theta, mac_tau=mac_tau,
        src_tile=src_tile, eps2=eps2, c2=compensate * compensate)
    return (score > thresh).sum(1)


def suggest_max_near(pos, mass, *, tile: int = DEFAULT_TILE,
                     theta: float = DEFAULT_THETA,
                     vip_tiles: int = DEFAULT_VIP_TILES, margin: float = 1.2,
                     multiple: int = 32, src_tile: int | None = None,
                     mac_tau: float = 0.0, eps2: float = 1e-6,
                     compensate: float = 0.1) -> int:
    """Host-side near-list capacity (in source tiles): the largest open
    count with ``margin``, rounded up to ``multiple`` and clamped to K_s."""
    counts = open_counts(pos, mass, tile=tile, theta=theta, vip_tiles=vip_tiles,
                         src_tile=src_tile, mac_tau=mac_tau, eps2=eps2,
                         compensate=compensate).cpu().numpy()
    k = max(pos.shape[0] // (src_tile or tile), 1)
    need = int(math.ceil(float(counts.max()) * margin))
    need = ((need + multiple - 1) // multiple) * multiple
    return int(min(max(need, 1), k))


def suggest_flat_cap(pos, mass, *, tile: int = DEFAULT_TILE,
                     src_tile: int = DEFAULT_SRC_TILE,
                     theta: float = DEFAULT_THETA,
                     vip_tiles: int = DEFAULT_VIP_TILES,
                     slack: int = DEFAULT_NEAR_SLACK, margin: float = 1.25,
                     mac_tau: float = 0.0, eps2: float = 1e-6,
                     compensate: float = 0.1) -> int:
    """Host-side flat-list capacity: every row's chunks with ``margin``, at
    least one chunk a row."""
    counts = open_counts(pos, mass, tile=tile, theta=theta, vip_tiles=vip_tiles,
                         src_tile=src_tile, mac_tau=mac_tau, eps2=eps2,
                         compensate=compensate).cpu().numpy()
    entries = CHUNK_LANES // src_tile
    v = np.maximum(((counts + slack + entries - 1) // entries) * entries, entries)
    need = int(math.ceil(float(v.sum()) * margin))
    need = max(need, max(pos.shape[0] // tile, 1) * entries)
    return ((need + entries - 1) // entries) * entries


def _per_rank(v: np.ndarray, n_dev: int) -> np.ndarray:
    """Sums of ``v`` (K_t,) over each rank's contiguous row block."""
    k_t = len(v)
    if k_t % n_dev:
        raise ValueError(f"K_t={k_t} not divisible by n_dev={n_dev}")
    return v.reshape(n_dev, k_t // n_dev).sum(1)


def suggest_flat_cap_sharded(pos, mass, n_dev: int, *, tile: int = DEFAULT_TILE,
                             src_tile: int = DEFAULT_SRC_TILE,
                             theta: float = DEFAULT_THETA,
                             vip_tiles: int = DEFAULT_VIP_TILES,
                             slack: int = DEFAULT_NEAR_SLACK, margin: float = 1.4,
                             mac_tau: float = 0.0, eps2: float = 1e-6,
                             compensate: float = 0.1) -> int:
    """Host-side flat-list capacity of one rank when the target rows are
    split over ``n_dev`` ranks: the worst rank's demand (the core's rows
    open more tiles than the halo's) with a margin above
    :func:`suggest_flat_cap`'s for drift."""
    counts = open_counts(pos, mass, tile=tile, theta=theta, vip_tiles=vip_tiles,
                         src_tile=src_tile, mac_tau=mac_tau, eps2=eps2,
                         compensate=compensate).cpu().numpy()
    entries = CHUNK_LANES // src_tile
    v = np.maximum(((counts + slack + entries - 1) // entries) * entries, entries)
    per_rank = _per_rank(v, n_dev)
    need = int(math.ceil(float(per_rank.max()) * margin))
    need = max(need, (len(v) // n_dev) * entries)
    return ((need + entries - 1) // entries) * entries


def suggest_hier_sharded(pos, mass, n_dev: int, *, tile: int = DEFAULT_HIER_TILE,
                         src_tile: int = DEFAULT_SRC_TILE,
                         theta: float = DEFAULT_THETA,
                         vip_tiles: int = DEFAULT_VIP_TILES,
                         slack: int = DEFAULT_NEAR_SLACK,
                         branch: int = HIER_BRANCH,
                         mac_tau: float = DEFAULT_HIER_TAU,
                         mac_tau0: float | None = None,
                         eps2: float = 1e-6,
                         compensate: float = 0.1,
                         union_coarse: bool = True,
                         margin: float = 1.4,
                         far_margin: float = 1.6) -> dict:
    """Capacity planner of one rank on the sharded hierarchical path:
    ``max_near`` and ``far_max`` stay global bounds a row; ``flat_cap`` and
    ``far_cap`` are the worst rank's demand, with margins above
    :func:`suggest_hier`'s for drift."""
    near, far = hier_counts(
        pos, mass, tile=tile, src_tile=src_tile, theta=theta,
        vip_tiles=vip_tiles, branch=branch, mac_tau=mac_tau,
        mac_tau0=mac_tau0, eps2=eps2, compensate=compensate,
        union_coarse=union_coarse)
    near = near.cpu().numpy()
    far = far.cpu().numpy()
    entries = CHUNK_LANES // src_tile
    k_l = len(near) // n_dev

    def rnd(v, e):
        return ((v + e - 1) // e) * e

    max_near = int(rnd(int(math.ceil(near.max() * margin)), entries))
    v = np.maximum(rnd(near + slack, entries), entries)
    flat_cap = int(rnd(max(int(math.ceil(_per_rank(v, n_dev).max() * margin)),
                           k_l * entries), entries))
    far_max = int(rnd(int(math.ceil(far.max() * far_margin)), FAR_ENTRIES))
    w = np.maximum(rnd(far, FAR_ENTRIES), FAR_ENTRIES)
    far_cap = int(rnd(max(int(math.ceil(_per_rank(w, n_dev).max() * far_margin)),
                          k_l * FAR_ENTRIES), FAR_ENTRIES))
    return {"max_near": max_near, "flat_cap": flat_cap,
            "far_max": far_max, "far_cap": far_cap}
