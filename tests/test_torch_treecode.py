"""The port's hierarchical treecode against the JAX package's.

Same Morton-sorted Plummer bodies (numpy, seeded) through both packages at
N=8,192. On the CPU the port's kernel wrappers run their plain twins; the
JAX side runs its Pallas kernels in interpret mode, as
tests/test_treecode_hier.py runs them. Integer structures (plans,
capacities, work lists) must be equal; forces agree within rtol=1e-4,
atol=2e-6 (the bound the CUDA kernels are held to against the plain
twins), and meet the JAX tests' error envelopes against the direct sum.
"""

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
    got = ct.near_field_plain(ops["bodies"], aux[0], aux[1], n=N, tile=128,
                              src_tile=64, entries=32, eps2=EPS2, c2=C2)
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
        ct.near_field(meta, lists, lists[:1], n=8192, tile=128, src_tile=64,
                      entries=32, eps2=EPS2, c2=C2)
    with pytest.raises(ValueError, match="no kernel"):
        ct.vip_both(meta, meta, eps2=EPS2, c2=C2)
