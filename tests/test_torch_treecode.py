"""The port's hierarchical treecode against the JAX package's.

Same Morton-sorted Plummer bodies (numpy, seeded) through both packages at
N=8,192. On the CPU the port's kernel wrappers run their plain twins; the
JAX side runs its Pallas kernels in interpret mode, as
tests/test_treecode_hier.py runs them. Integer structures (plans,
capacities, work lists) must be equal; forces agree within rtol=1e-4,
atol=2e-6 (the bound the CUDA kernels are held to against the plain
twins), and meet the JAX tests' error envelopes against the direct sum.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from n_body_problem_tpu import models as jmodels
from n_body_problem_tpu.ops import treecode as jtc
from n_body_problem_tpu.utils.morton import morton_argsort
from n_body_problem_tpu_torch.ops import cuda_treecode as ct
from n_body_problem_tpu_torch.ops import treecode as ttc
from n_body_problem_tpu_torch.ops.forces import direct_acc

EPS2, COMP = 1e-6, 0.1
C2 = COMP * COMP
TOL = dict(rtol=1e-4, atol=2e-6)
N = 8192
KW = dict(tile=128, src_tile=64, vip_tiles=128, mac_tau=jtc.DEFAULT_HIER_TAU,
          mac_tau0=jtc.DEFAULT_MAC_TAU, eps2=EPS2, compensate=COMP)
SEL = dict(tile=128, src_tile=64, vip_tiles=128)


def _sorted_plummer(n, seed):
    st = jmodels.plummer(n, seed=seed)
    pos = np.asarray(st.pos)
    perm = morton_argsort(pos)
    return pos[perm], np.asarray(st.mass)[perm]


def _rel_err(acc, exact):
    return (np.linalg.norm(acc - exact, axis=1)
            / np.maximum(np.linalg.norm(exact, axis=1), 1e-12))


@pytest.fixture(scope="module")
def case():
    pos, mass = _sorted_plummer(N, seed=3)
    jpos, jmass = jnp.asarray(pos), jnp.asarray(mass)
    tpos, tmass = torch.from_numpy(pos.copy()), torch.from_numpy(mass.copy())
    caps = jtc.suggest_hier(jpos, jmass, **KW)
    lists = dict(flat_cap=caps["flat_cap"], max_near=caps["max_near"],
                 far_max=caps["far_max"], far_cap=caps["far_cap"])
    jaux = tuple(np.asarray(a) for a in jtc.build_tree_hier_cols(
        jpos[:, 0], jpos[:, 1], jpos[:, 2], jmass, **lists, **KW))
    taux = ttc.build_tree_hier_cols(tpos[:, 0], tpos[:, 1], tpos[:, 2], tmass,
                                    **lists, **KW)
    st = ttc._hier_static(N, 128, 64, KW.get("theta", 0.55), caps["max_near"],
                          128, caps["far_max"], ttc.HIER_BRANCH)
    return dict(pos=pos, mass=mass, jpos=jpos, jmass=jmass, tpos=tpos,
                tmass=tmass, caps=caps, jaux=jaux, taux=taux, vip_src=st[4],
                plan=st[5], acc_kw=dict(eps2=EPS2, max_near=caps["max_near"],
                                        far_max=caps["far_max"], **SEL))


def _jcols(case):
    return case["jpos"][:, 0], case["jpos"][:, 1], case["jpos"][:, 2]


def _operands(case):
    """The port's kernel operands on the JAX package's lists."""
    aux = ttc.aux_from_numpy(case["jaux"])
    ops = ttc.kernel_operands(case["tpos"], case["tmass"], aux[4], compensate=COMP,
                              src_tile=64, vip_src=case["vip_src"], plan=case["plan"])
    return aux, ops


# ------------------------------------------------------------ static plans
@pytest.mark.parametrize("n,tile,src,max_near,vip,far_max", [
    (8192, 128, 64, 130, 128, 100), (20480, 128, 32, 384, 16, 512),
    (65536, 128, 64, 0, 32, 0), (524288, 128, 64, 896, 128, 3200),
    (4096, 32, 64, 416, 8, 64)])
def test_static_planners_equal_jax(n, tile, src, max_near, vip, far_max):
    assert ttc._level_plan(n // src) == jtc._level_plan(n // src)
    assert ttc._vip_src_tiles(vip, tile, src) == jtc._vip_src_tiles(vip, tile, src)
    assert ttc._clamp_vip(vip, n // src) == jtc._clamp_vip(vip, n // src)
    assert (ttc._flat_static(n, tile, src, 0.55, max_near, vip)
            == jtc._flat_static(n, tile, src, 0.55, max_near, vip))
    assert (ttc._hier_static(n, tile, src, 0.55, max_near, vip, far_max, 2)
            == jtc._hier_static(n, tile, src, 0.55, max_near, vip, far_max, 2))


def test_constants_equal_jax():
    for name in ("CHUNK_LANES", "DEFAULT_SRC_TILE", "DEFAULT_NEAR_SLACK",
                 "FAR_ENTRIES", "HIER_BRANCH", "HIER_MIN_NODES",
                 "DEFAULT_HIER_TILE", "DEFAULT_HIER_TAU", "DEFAULT_MAC_TAU",
                 "MAC_REF_KSRC", "DEFAULT_MAX_NEAR", "_TINY"):
        assert getattr(ttc, name) == getattr(jtc, name), name


def test_capacities_equal_jax(case):
    assert ttc.suggest_hier(case["tpos"], case["tmass"], **KW) == case["caps"]
    jn, jf = jtc.hier_counts(case["jpos"], case["jmass"], **KW)
    tn, tf = ttc.hier_counts(case["tpos"], case["tmass"], **KW)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


# --------------------------------------------------------------- summaries
def test_level_summaries_match_jax(case):
    plan = case["plan"]
    mass_tree = np.where(case["jaux"][4], 0.0, case["mass"]).astype(np.float32)
    jl = jtc._level_summaries(*_jcols(case), jnp.asarray(mass_tree), 64, plan, 2)
    tl = ttc._level_summaries(*case["tpos"].unbind(1), torch.from_numpy(mass_tree),
                              64, plan, 2)
    assert len(tl) == len(jl) == len(plan)
    for jlv, tlv in zip(jl, tl):
        for j, t in zip((*jlv[:6], *jlv[6]), (*tlv[:6], *tlv[6])):
            # rtol=1e-5: float32 sums of the same terms in another order;
            # atol covers the moments that cancel to ~0 (scale 1e-3).
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-9)
    for j, t in zip(jtc.tile_summaries_cols(*_jcols(case), jnp.asarray(mass_tree), 32),
                    ttc.tile_summaries_cols(*case["tpos"].unbind(1),
                                            torch.from_numpy(mass_tree), 32)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-9)
    jsumm = np.asarray(jtc._summary_panel(jl))[:, 0, :11]
    tsumm = ttc._summary_panel(tl).numpy()
    assert tsumm.shape == (sum(plan) + 1, 12)
    np.testing.assert_allclose(tsumm[:, :11], jsumm, rtol=1e-5, atol=1e-9)
    assert not tsumm[-1].any() and not tsumm[:, 11].any()


# -------------------------------------------------------------- work lists
def _row_sets(src, tgt, entries, k_t):
    rows = {}
    for p, t in enumerate(np.asarray(tgt)):
        if t != k_t:
            rows.setdefault(int(t), set()).update(np.asarray(src)[p * entries:(p + 1) * entries].tolist())
    return rows


def test_work_lists_match_jax(case):
    """Per target row, the same near and far entries. The port orders
    ties as ``lax.top_k`` does, so the lists come out equal."""
    jaux, taux = case["jaux"], [a.numpy() for a in case["taux"]]
    k_t = N // 128
    for s, t, e in ((0, 1, 2048 // 64), (2, 3, ttc.FAR_ENTRIES)):
        assert taux[s].shape == jaux[s].shape and taux[t].shape == jaux[t].shape
        jr, tr = _row_sets(jaux[s], jaux[t], e, k_t), _row_sets(taux[s], taux[t], e, k_t)
        same = sum(jr.get(r) == tr.get(r) for r in range(k_t))
        assert same >= 0.99 * k_t, (s, same)
        np.testing.assert_array_equal(taux[s], jaux[s])
        np.testing.assert_array_equal(taux[t], jaux[t])
    np.testing.assert_array_equal(taux[4], jaux[4])
    assert taux[0].dtype == taux[1].dtype == np.int32


def test_work_lists_without_the_coarse_union_equal_jax(case):
    """``union_coarse=False`` (``tree_hier_union``): the coarse levels bound
    the distance by the row centroid's distance to the node's com minus the
    row's radius (JAX treecode.py:1982-2014). Same capacities and lists."""
    kw = dict(KW, union_coarse=False)
    caps = jtc.suggest_hier(case["jpos"], case["jmass"], **kw)
    assert ttc.suggest_hier(case["tpos"], case["tmass"], **kw) == caps
    assert caps != case["caps"]     # the bound changes what opens
    lists = dict(flat_cap=caps["flat_cap"], max_near=caps["max_near"],
                 far_max=caps["far_max"], far_cap=caps["far_cap"])
    want = jtc.build_tree_hier_cols(*_jcols(case), case["jmass"], **lists, **kw)
    got = ttc.build_tree_hier_cols(*case["tpos"].unbind(1), case["tmass"], **lists, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("flat_cap", [2048, 768])   # fits / overflows
def test_compact_open_lists_equal_jax(flat_cap):
    """Including the capacity overflow, which the port takes with a
    ``torch.where`` (no host sync) where the JAX package used ``jnp.where``."""
    rng = np.random.default_rng(flat_cap)
    ratio = rng.exponential(1.0, (16, 256)).astype(np.float32)
    ratio[rng.random((16, 256)) < 0.3] = -1.0
    ratio[np.arange(16), np.arange(16) * 16] = np.inf
    want = jtc._compact_open_lists(jnp.asarray(ratio), 1.5, 4, flat_cap, 16, 64)
    got = ttc._compact_open_lists(torch.from_numpy(ratio), 1.5, 4, flat_cap, 16, 64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_vip_tile_index_equals_nonzero(case):
    is_vip = case["jaux"][4]
    want = np.nonzero(is_vip.reshape(N // 64, 64)[:, 0])[0]
    got = ttc._vip_tile_index(torch.from_numpy(is_vip.copy()), N // 64, 64,
                              case["vip_src"])
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------- plain twins vs JAX kernels
def test_near_plain_matches_jax_kernel(case):
    aux, ops = _operands(case)
    mass_tree = jnp.where(jnp.asarray(case["jaux"][4]), 0.0, case["jmass"]) * (C2 * COMP)
    x, y, z = _jcols(case)
    tiles = jnp.stack([a.reshape(N // 64, 64) for a in (x, y, z, mass_tree)], axis=1)
    tiles = jnp.concatenate([tiles, jnp.zeros((1, 4, 64), jnp.float32)])
    want = np.asarray(jtc._near_field_flat_cols(
        x, y, z, tiles, jnp.asarray(case["jaux"][0]), jnp.asarray(case["jaux"][1]),
        eps2=EPS2, c2=C2, tile=128, src_tile=64, interpret=True))[:N, :3]
    got = ct.near_field_plain(ops["bodies"], ops["bodies"], aux[0], aux[1], n=N, n_s=N,
                              tile=128, src_tile=64, entries=32, eps2=EPS2, c2=C2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("variant", ["vmem", "hbm"])
def test_far_plain_matches_jax_kernels(case, variant, monkeypatch):
    """Against both TPU far kernels: the VMEM-resident panel
    (``_far_hier_kernel_vmem``) and the per-entry HBM fetch
    (``_far_hier_kernel``), which the one CUDA kernel replaces."""
    if variant == "hbm":
        monkeypatch.setattr(jtc, "_SUMM_VMEM_BYTES", 0)
    aux, ops = _operands(case)
    summ = jtc._summary_panel(jtc._level_summaries(
        *_jcols(case), jnp.where(jnp.asarray(case["jaux"][4]), 0.0, case["jmass"]),
        64, case["plan"], 2))
    acc = np.asarray(jtc._far_field_hier_cols(
        *_jcols(case), summ, jnp.asarray(case["jaux"][2]), jnp.asarray(case["jaux"][3]),
        eps2=EPS2, c2=C2, G=1.0, tile=128, interpret=True))
    want = acc[:N // 128, :3, :].transpose(0, 2, 1).reshape(N, 3)
    got = ct.far_field_hier_plain(ops["bodies"], ops["summ"], aux[2], aux[3], n=N,
                                  tile=128, eps2=EPS2, c2=C2, G=1.0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_vip_plain_matches_jax_kernel(case):
    _, ops = _operands(case)
    idx = ops["vip_tile_idx"].numpy()
    scaled = case["jmass"] * (C2 * COMP)
    vrow = [jnp.asarray(np.asarray(a).reshape(N // 64, 64)[idx].reshape(-1))
            for a in (*_jcols(case), scaled)]
    action, react = jtc._vip_both_pallas_cols(*_jcols(case), scaled, *vrow,
                                              eps2=EPS2, c2=C2, interpret=True)
    got_a, got_r = ct.vip_both_plain(ops["rows"], ops["panel"], eps2=EPS2, c2=C2)
    assert got_r.shape == (case["vip_src"] * 64, 3)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(action)[:, :3], **TOL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(react)[:3].T, **TOL)


# ------------------------------------------------------------- whole force
def test_treecode_acc_matches_jax(case):
    jacc = np.stack([np.asarray(a) for a in jtc.treecode_acc_hier_cols(
        *_jcols(case), case["jmass"], tuple(jnp.asarray(a) for a in case["jaux"]),
        **case["acc_kw"])], axis=1)
    tx, ty, tz = ttc.treecode_acc_hier_cols(
        *case["tpos"].unbind(1), case["tmass"], ttc.aux_from_numpy(case["jaux"]),
        **case["acc_kw"])
    np.testing.assert_allclose(torch.stack([tx, ty, tz], 1).numpy(), jacc, **TOL)


def test_treecode_error_envelope(case):
    """The port's own lists: tests/test_treecode_hier.py:126-127."""
    acc = ttc.treecode_acc_hier(case["tpos"], case["tmass"], case["taux"],
                                **case["acc_kw"]).numpy()
    exact = direct_acc(case["tpos"], case["tmass"], eps2=EPS2, compensate=COMP).numpy()
    err = _rel_err(acc, exact)
    assert np.isfinite(acc).all()
    assert np.percentile(err, 99) < 2.5e-3, np.percentile(err, 99)
    assert np.median(err) < 5e-4, np.median(err)


def test_exact_limit():
    """tau -> 0 opens everything and the near field is the direct sum
    (tests/test_treecode_hier.py:164-179)."""
    pos, mass = (torch.from_numpy(a.copy()) for a in _sorted_plummer(4096, seed=5))
    kw = dict(tile=128, src_tile=64, vip_tiles=0, mac_tau=1e-12, eps2=EPS2,
              compensate=COMP)
    caps = ttc.suggest_hier(pos, mass, **kw)
    assert caps["max_near"] >= 4096 // 64
    aux = ttc.build_tree_hier_cols(*pos.unbind(1), mass, flat_cap=caps["flat_cap"],
                                   max_near=caps["max_near"], far_max=caps["far_max"],
                                   far_cap=caps["far_cap"], **kw)
    acc = ttc.treecode_acc_hier(pos, mass, aux, eps2=EPS2, tile=128, src_tile=64,
                                vip_tiles=0, max_near=caps["max_near"],
                                far_max=caps["far_max"]).numpy()
    exact = direct_acc(pos, mass, eps2=EPS2, compensate=COMP).numpy()
    assert np.percentile(_rel_err(acc, exact), 99) < 1e-5


def test_kernel_operands_layout(case):
    _, ops = _operands(case)
    assert ops["bodies"].shape == (N + 64, 4) and not ops["bodies"][N:].any()
    is_vip = torch.from_numpy(case["jaux"][4].copy())
    assert not ops["bodies"][:N, 3][is_vip].any()          # VIPs leave the tree
    torch.testing.assert_close(ops["bodies"][:N, :3], case["tpos"], rtol=0, atol=0)
    assert ops["panel"].shape == (case["vip_src"] * 64, 4)
    assert ops["rows"][:, 3].sum() > ops["bodies"][:, 3].sum()


def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.empty((8256, 4), device="meta")
    lists = torch.zeros(32, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ct.near_field(meta, meta, lists, lists[:1], n=8192, n_s=8192, tile=128,
                      src_tile=64, entries=32, eps2=EPS2, c2=C2)
    with pytest.raises(ValueError, match="no kernel"):
        ct.vip_both(meta, meta, eps2=EPS2, c2=C2)


# ------------------------------------------------------- minimum distances
def _centres(case, level):
    """The node centres (cx, cy, cz) of one level of the case's plan."""
    mass_tree = torch.from_numpy(np.where(case["jaux"][4], 0.0, case["mass"]).astype(np.float32))
    lv = ttc._level_summaries(*case["tpos"].unbind(1), mass_tree, 64, case["plan"], 2)
    return lv[level][:3]


@pytest.mark.parametrize("tile,level", [(128, 0), (128, 3), (32, 0), (64, 1)])
def test_min_tile_dist_on_the_cpu_is_its_plain_twin(case, tile, level):
    """``_min_tile_dist`` takes the plain twin on a CPU tensor: the same bits
    from the strided columns of ``pos.unbind(1)``, and the JAX package's
    distances within float32 rounding (XLA rounds the chain otherwise)."""
    cols, cen = case["tpos"].unbind(1), _centres(case, level)
    got = ttc._min_tile_dist(*cols, *cen, tile)
    want = ct.min_tile_dist_plain(*(c.contiguous() for c in cols), *cen, tile)
    assert got.shape == (N // tile, cen[0].shape[0]) and got.dtype == torch.float32
    assert torch.equal(got, want)
    jcom = jnp.asarray(torch.stack(cen, 1).numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(jtc._min_tile_dist(*_jcols(case), jcom, tile)),
                               rtol=2e-6, atol=0)
    brute = torch.cdist(case["tpos"].double().reshape(-1, 3), torch.stack(cen, 1).double())
    np.testing.assert_allclose(got.numpy(), brute.reshape(N // tile, tile, -1).amin(1).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_min_tile_dist_carries_a_nan_through_its_tile(case):
    """A NaN coordinate makes its target tile's row NaN and leaves every
    other row as it was (torch.amin propagates it; the kernel does too)."""
    cols = [c.contiguous() for c in case["tpos"].unbind(1)]
    cen = _centres(case, 0)
    clean = ttc._min_tile_dist(*cols, *cen, 128)
    cols[1] = cols[1].clone()
    cols[1][5 * 128 + 17] = float("nan")
    got = ttc._min_tile_dist(*cols, *cen, 128)
    assert torch.isnan(got[5]).all()
    keep = torch.arange(N // 128) != 5
    assert torch.equal(got[keep], clean[keep])


def test_min_tile_dist_refuses_a_device_without_a_kernel():
    meta = torch.empty(8192, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ct.min_tile_dist(meta, meta, meta, meta[:128], meta[:128], meta[:128], 128)


# ------------------------------------------------------- the opening test
def _parent_open_masks(xc, yc, zc, levels, tile, src_tile, *, mac_tau, theta, a_med,
                       row_offset, mac_tau0, union_coarse):
    """The hierarchical opening test as the build formed it before the
    kernel took it over, a PyTorch pass at a time: per level (opens,
    m / d^2), level 0's scores and threshold."""
    opens, fars = [], []
    k_t = xc.shape[0] // tile
    score0 = thresh0 = None
    if not union_coarse:
        tcx, tcy, tcz, trad = ttc._row_bounds(xc, yc, zc, tile)
    for lvl, (cx, cy, cz, m, radius, rms2, _) in enumerate(levels):
        if lvl == 0 or union_coarse:
            min_d = ct.min_tile_dist_plain(xc, yc, zc, cx, cy, cz, tile)
        else:
            dcx = cx[None, :] - tcx[:, None]
            dcy = cy[None, :] - tcy[:, None]
            dcz = cz[None, :] - tcz[:, None]
            min_d = torch.sqrt(dcx * dcx + dcy * dcy + dcz * dcz) - trad[:, None]
        min_d = torch.clamp(min_d, min=1e-12)
        if mac_tau > 0 and lvl == 0 and mac_tau0:
            d5 = torch.square(torch.square(min_d)) * min_d
            score = (m * radius * radius * radius)[None, :] / d5 / a_med
            thresh = mac_tau0 * math.sqrt(ttc.MAC_REF_KSRC / m.shape[0])
        elif mac_tau > 0:
            delta = torch.clamp(min_d - radius[None, :], min=1e-12)
            d5 = torch.square(torch.square(delta)) * delta
            score = (m * rms2 * radius)[None, :] / d5 / a_med
            thresh = mac_tau
        else:
            score = radius[None, :] / min_d
            thresh = theta
        k_l = score.shape[1]
        node = levels[0][0].shape[0] * src_tile // k_l
        rows = torch.arange(k_t)[:, None] + row_offset
        cols = torch.arange(k_l)[None, :]
        overlap = (rows // max(node // tile, 1)) == (cols // max(tile // node, 1))
        score = torch.where(overlap, torch.inf, score)
        if lvl == 0:
            score0, thresh0 = score, thresh
        opens.append(score > thresh)
        fars.append(m[None, :] / (min_d * min_d))
    return opens, fars, score0, thresh0


def _same_bits(a, b):
    """float32 tensors equal bit for bit, NaN where the other is NaN."""
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


@pytest.fixture(scope="module")
def open_bodies():
    """Morton-sorted (pos, mass, eps2, c2) of 8,192 bodies: the case's
    Plummer sphere, the same with one NaN coordinate, and a sample of the
    AGORA disk (two particle masses) at its benchmark physics."""
    from n_body_problem_tpu_torch import models as tmodels
    from n_body_problem_tpu_torch.utils.morton import morton_argsort as t_argsort

    pos, mass = _sorted_plummer(N, seed=3)
    bad = pos.copy()
    bad[17 * 128 + 5, 1] = np.nan
    disk = tmodels.agora_disk(N, seed=1)
    dpos, dmass = disk.pos.numpy(), disk.mass.numpy()
    perm = t_argsort(dpos)
    assert dmass.max() / dmass.min() > 30    # the halo's bodies and the stars'
    return {"plummer": (pos, mass, EPS2, C2), "plummer with a NaN": (bad, mass, EPS2, C2),
            "agora": (dpos[perm], dmass[perm], 0.0064, 1.0)}


# (mac_tau, mac_tau0): the flat MAC at level 0 and the hierarchical one above
# (the defaults), the hierarchical MAC at every level, the geometric test.
OPEN_MODES = {"flat": (jtc.DEFAULT_HIER_TAU, jtc.DEFAULT_MAC_TAU),
              "hier": (jtc.DEFAULT_HIER_TAU, None), "geometric": (0.0, None)}


@pytest.mark.parametrize("rank", [0, 1], ids=["one card", "rank 1 of 4"])
@pytest.mark.parametrize("union", [True, False], ids=["union", "row bound"])
@pytest.mark.parametrize("mode", list(OPEN_MODES))
@pytest.mark.parametrize("bodies", ["plummer", "plummer with a NaN", "agora"])
def test_opening_test_twin_is_the_parent_glue_bitwise(open_bodies, bodies, mode, union, rank):
    """``_hier_open_masks`` (``cuda_treecode.min_dist_open``'s plain twin on
    the CPU; ``open_test_plain`` at the row-bound levels) gives every
    level's opens and far keys, and level 0's scores and threshold, bit for
    bit as the PyTorch chain it replaced: each MAC mode, with and without
    the coarse union, on one card and for a rank's rows (``row_offset``)."""
    pos, mass, eps2, c2 = open_bodies[bodies]
    mac_tau, mac_tau0 = OPEN_MODES[mode]
    cols = [torch.from_numpy(pos[:, i].copy()) for i in range(3)]
    mass = torch.from_numpy(mass.copy())
    plan = ttc._level_plan(N // 64)
    vip = ttc._clamp_vip(ttc._vip_src_tiles(128, 128, 64), N // 64)
    mass_tree, _ = ttc._tree_mass(*cols, mass, 64, vip)
    levels = ttc._level_summaries(*cols, mass_tree, 64, plan, 2)
    a_med = (torch.clamp(ttc._median_monopole_acc(*cols, *levels[0][:4], eps2=eps2, c2=c2),
                         min=1e-12) if mac_tau > 0 else None)
    rows, row_offset = cols, 0
    if rank:
        q = N // 4
        rows, row_offset = [c[q:2 * q].contiguous() for c in cols], q // 128
    kw = dict(mac_tau=mac_tau, theta=0.55, a_med=a_med, row_offset=row_offset,
              mac_tau0=mac_tau0, union_coarse=union)
    opens, fars, score0, thresh0 = ttc._hier_open_masks(*rows, levels, 128, 64, **kw)
    w_opens, w_fars, w_score0, w_thresh0 = _parent_open_masks(*rows, levels, 128, 64, **kw)
    assert len(opens) == len(fars) == len(plan)
    for lvl, (o, f, wo, wf) in enumerate(zip(opens, fars, w_opens, w_fars)):
        assert o.dtype == torch.bool and torch.equal(o, wo), lvl
        assert f.dtype == torch.float32 and _same_bits(f, wf), lvl
    assert _same_bits(score0, w_score0) and thresh0 == w_thresh0
    assert opens[0].any() and not opens[0].all()
    if bodies == "plummer with a NaN":
        assert torch.isnan(score0).any() and torch.isnan(fars[0]).any()


# ------------------------------------------------------------ row selection
def _rows(kind: str, cols: int, seed: int = 0) -> np.ndarray:
    """(4, cols) float32 rows whose ties the selection has to order: the
    build's sentinels (-1.0) with and without self-overlaps (+inf) and real
    scores among them, one signed zero throughout, a few repeated values."""
    rng = np.random.default_rng(seed)
    x = np.full((4, cols), -1.0, np.float32)
    if kind in ("inf", "scores"):
        x[:, ::7] = np.inf
    if kind == "scores":
        live = rng.random((4, cols)) < 0.3
        x[live] = rng.random(int(live.sum())).astype(np.float32)
    if kind == "zeros":
        x[:] = 0.0
    if kind == "negative zeros":
        x[:] = -0.0
    if kind == "repeated":
        x = rng.integers(0, 5, (4, cols)).astype(np.float32) / 4
    return x


TIE_KINDS = ["sentinels", "inf", "scores", "zeros", "negative zeros", "repeated"]


@pytest.mark.parametrize("kind", TIE_KINDS)
@pytest.mark.parametrize("cols,k", [(64, 1), (64, 20), (300, 64), (300, 300)])
def test_top_k_orders_ties_as_lax_top_k(kind, cols, k):
    """``_top_k`` on the CPU: the k largest of each row, largest first, ties
    to the lower index, the same values and indices (every bit) as
    ``lax.top_k``."""
    from jax import lax

    x = _rows(kind, cols)
    vals, idx = ttc._top_k(torch.from_numpy(x), k)
    want_v, want_i = lax.top_k(jnp.asarray(x), k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy().view(np.uint32), np.asarray(want_v).view(np.uint32))


@pytest.mark.parametrize("kind", TIE_KINDS)
def test_top_k_on_the_cpu_is_its_plain_twin(kind):
    """The wrapper takes the plain twin on a CPU tensor: the same bits, from
    a whole matrix and from a column slice of one (a staged rank's rows)."""
    x = torch.from_numpy(_rows(kind, 1000, seed=3))
    for a in (x, x[:, 100:700]):
        got, want = ct.top_k(a, 77), ct.top_k_plain(a, 77)
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])


def test_top_k_ties_signed_zeros_by_column():
    """-0.0 and +0.0 tie (torch.sort's order, which the kernel keeps on the
    card), so a row of both keeps their columns' order; ``lax.top_k`` puts
    +0.0 first. Neither occurs in the build's scores."""
    x = torch.tensor([[-0.0, 0.0, -1.0, -0.0, 0.0, 2.0]])
    vals, idx = ct.top_k(x, 6)
    assert idx.tolist() == [[5, 0, 1, 3, 4, 2]]
    assert [math.copysign(1.0, v) for v in vals[0].tolist()] == [1, -1, 1, -1, 1, -1]


def test_top_k_refuses_what_it_does_not_take():
    x = torch.zeros((4, 16))
    for k in (0, 17):
        with pytest.raises(ValueError, match="row length"):
            ct.top_k(x, k)
    with pytest.raises(TypeError, match="float32"):
        ct.top_k(x.double(), 4)
    with pytest.raises(ValueError, match="2-D"):
        ct.top_k(x[0], 4)


def test_top_k_refuses_a_device_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        ct.top_k(torch.empty((8, 64), device="meta"), 8)
