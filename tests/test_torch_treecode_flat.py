"""The port's single-level flat treecode against the JAX package's.

Same Morton-sorted Plummer bodies (numpy, seeded) through both packages at
N=4,096, target rows of 32 bodies and source tiles of 64. On the CPU the
port's kernel wrappers run their plain twins; the JAX side runs its Pallas
kernels in interpret mode, as tests/test_treecode.py:195-218 runs them.
Integer structures (planners, work lists, masks) must be equal; forces agree
within rtol=1e-4, atol=2e-6 (the bound the CUDA kernels are held to against
their twins), and meet the JAX tests' error envelopes against the direct sum.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import jax.numpy as jnp
import morton_ties
import numpy as np
import pytest
import torch

import n_body_problem_tpu as jnb
import n_body_problem_tpu_torch as tnb
from n_body_problem_tpu import models as jmodels
from n_body_problem_tpu.ops import treecode as jtc
from n_body_problem_tpu.utils.morton import morton_argsort
from n_body_problem_tpu_torch.ops import cuda_treecode as ct
from n_body_problem_tpu_torch.ops import treecode as ttc
from n_body_problem_tpu_torch.ops.forces import direct_acc
from n_body_problem_tpu_torch.ops.registry import tree_path

EPS2, COMP = 1e-6, 0.1
C2 = COMP * COMP
TOL = dict(rtol=1e-4, atol=2e-6)
N = 4096
SEL = dict(tile=32, src_tile=64, vip_tiles=32)
MAC = dict(mac_tau=jtc.DEFAULT_MAC_TAU, eps2=EPS2, compensate=COMP)


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
    max_near = jtc.suggest_max_near(jpos, jmass, **SEL, **MAC)
    flat_cap = jtc.suggest_flat_cap(jpos, jmass, **SEL, **MAC)
    kw = dict(max_near=max_near, flat_cap=flat_cap, **SEL, **MAC)
    jaux = tuple(np.asarray(a) for a in jtc.build_tree_flat(jpos, jmass, **kw))
    taux = ttc.build_tree_flat(tpos, tmass, **kw)
    vip_src = ttc._flat_static(N, 32, 64, 0.55, max_near, 32)[4]
    return dict(pos=pos, mass=mass, jpos=jpos, jmass=jmass, tpos=tpos, tmass=tmass,
                max_near=max_near, flat_cap=flat_cap, jaux=jaux, taux=taux,
                vip_src=vip_src, acc_kw=dict(eps2=EPS2, max_near=max_near, **SEL))


def _jcols(case):
    return case["jpos"][:, 0], case["jpos"][:, 1], case["jpos"][:, 2]


def _taux(case):
    """The JAX package's lists as the port's tensors."""
    flat_src, chunk_tgt, near_mask, is_vip = case["jaux"]
    return (torch.from_numpy(flat_src.astype(np.int32)),
            torch.from_numpy(chunk_tgt.astype(np.int32)),
            torch.from_numpy(near_mask.copy()), torch.from_numpy(is_vip.copy()))


def _operands(case):
    aux = _taux(case)
    ops = ttc.kernel_operands(case["tpos"], case["tmass"], aux[3], compensate=COMP,
                              src_tile=64, vip_src=case["vip_src"], plan=(N // 64,))
    return aux, ops


# ------------------------------------------------------------------ planners
@pytest.mark.parametrize("src_tile", [64, None])
@pytest.mark.parametrize("mac_tau", [0.0, jtc.DEFAULT_MAC_TAU])
def test_planners_equal_jax(case, src_tile, mac_tau):
    """``open_counts``, ``suggest_max_near`` and ``suggest_flat_cap`` give
    the JAX package's integers, at the flat path's source tiles and at the
    dense path's (``src_tile=None``)."""
    kw = dict(tile=32, vip_tiles=32, src_tile=src_tile, mac_tau=mac_tau, eps2=EPS2,
              compensate=COMP)
    np.testing.assert_array_equal(
        ttc.open_counts(case["tpos"], case["tmass"], **kw).numpy(),
        np.asarray(jtc.open_counts(case["jpos"], case["jmass"], **kw)))
    assert (ttc.suggest_max_near(case["tpos"], case["tmass"], **kw)
            == jtc.suggest_max_near(case["jpos"], case["jmass"], **kw))
    if src_tile:
        assert (ttc.suggest_flat_cap(case["tpos"], case["tmass"], **kw)
                == jtc.suggest_flat_cap(case["jpos"], case["jmass"], **kw))


def test_build_tree_flat_equals_jax(case):
    """The same work lists, far mask and VIP bodies; the port orders top-k
    ties as ``lax.top_k`` does, so they come out equal."""
    taux = [a.numpy() for a in case["taux"]]
    for got, want in zip(taux, case["jaux"]):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert taux[0].dtype == taux[1].dtype == np.int32
    assert taux[2].dtype == np.bool_ and case["taux"][2].is_contiguous()


# ------------------------------------------------- plain twins vs JAX kernels
@pytest.mark.parametrize("variant", ["xla", "pallas"])
def test_far_single_plain_matches_jax(case, variant):
    """The far twin against ``_far_field`` and against the TPU kernel
    ``_far_kernel`` (through ``_far_field_pallas_cols``, interpreted)."""
    aux, ops = _operands(case)
    mass_tree = jnp.where(jnp.asarray(case["jaux"][3]), 0.0, case["jmass"])
    com, m_tot, _, quad = jtc.tile_summaries_cols(*_jcols(case), mass_tree, 64)
    mask = jnp.asarray(case["jaux"][2])
    kw = dict(eps2=EPS2, c2=C2, G=1.0, tile=32)
    if variant == "xla":
        want = jtc._far_field(case["jpos"], com, m_tot, quad, mask, **kw)
    else:
        want = jtc._far_field_pallas_cols(*_jcols(case), com, m_tot, quad, mask,
                                          interpret=True, **kw)[:, :3]
    got = ct.far_field_single_plain(ops["bodies"], ops["summ"], aux[2], n=N, tile=32,
                                    eps2=EPS2, c2=C2, G=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_near_plain_at_tile_32_matches_jax_kernel(case):
    """Kernel 7's twin at the flat path's 32-body target rows."""
    aux, ops = _operands(case)
    scaled = jnp.where(jnp.asarray(case["jaux"][3]), 0.0, case["jmass"]) * (C2 * COMP)
    tiles = jnp.stack([a.reshape(N // 64, 64) for a in (*_jcols(case), scaled)], axis=1)
    tiles = jnp.concatenate([tiles, jnp.zeros((1, 4, 64), jnp.float32)])
    want = np.asarray(jtc._near_field_flat_cols(
        *_jcols(case), tiles, jnp.asarray(case["jaux"][0]), jnp.asarray(case["jaux"][1]),
        eps2=EPS2, c2=C2, tile=32, src_tile=64, interpret=True))[:N, :3]
    got = ct.near_field_plain(ops["bodies"], ops["bodies"], aux[0], aux[1], n=N, n_s=N,
                              tile=32, src_tile=64, entries=32, eps2=EPS2, c2=C2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ------------------------------------------------------------- whole force
def test_treecode_acc_flat_matches_jax(case):
    want = np.asarray(jtc.treecode_acc_flat(
        case["jpos"], case["jmass"], tuple(jnp.asarray(a) for a in case["jaux"]),
        interpret=True, **case["acc_kw"]))
    got = ttc.treecode_acc_flat(case["tpos"], case["tmass"], _taux(case), **case["acc_kw"])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    cols = ttc.treecode_acc_flat_cols(*case["tpos"].unbind(1), case["tmass"], _taux(case),
                                      **case["acc_kw"])
    torch.testing.assert_close(torch.stack(cols, 1), got, rtol=0, atol=0)


def test_error_envelope(case):
    """The port's own lists: tests/test_treecode.py:215-218."""
    acc = ttc.treecode_acc_flat(case["tpos"], case["tmass"], case["taux"],
                                **case["acc_kw"]).numpy()
    exact = direct_acc(case["tpos"], case["tmass"], eps2=EPS2, compensate=COMP).numpy()
    err = _rel_err(acc, exact)
    assert np.isfinite(acc).all()
    assert np.median(err) < 5e-4, np.median(err)
    assert np.percentile(err, 99) < 2e-3, np.percentile(err, 99)


def test_flat_capacity_overflow_is_consistent():
    """tests/test_treecode.py:258-303 through the port: a starved capacity
    keeps every row's self tile, the far mask is exactly what landed, and
    the force degrades without a coverage hole."""
    pos, mass = (torch.from_numpy(a.copy()) for a in _sorted_plummer(4096, seed=43))
    kw = dict(tile=32, src_tile=128, theta=0.5, max_near=32, vip_tiles=0)
    full = ttc.suggest_flat_cap(pos, mass, tile=32, src_tile=128, theta=0.5,
                                vip_tiles=0, slack=0, margin=1.0)
    cap = max((4096 // 32) * 16, (full // 2) // 16 * 16)
    aux = ttc.build_tree_flat(pos, mass, slack=0, flat_cap=cap, **kw)
    flat_src, chunk_tgt, near_mask, _ = (a.numpy() for a in aux)
    k_t, k_s = 4096 // 32, 4096 // 128
    landed = np.zeros((k_t, k_s), bool)
    self_ok = np.zeros(k_t, bool)
    for r, s in zip(np.repeat(chunk_tgt, 16), flat_src):
        if r < k_t and s < k_s:
            landed[r, s] = True
            self_ok[r] |= s == (r * 32) // 128
    assert self_ok.all()
    np.testing.assert_array_equal(near_mask, landed)
    got = ttc.treecode_acc_flat(pos, mass, aux, eps2=EPS2, **kw).numpy()
    err = _rel_err(got, direct_acc(pos, mass, eps2=EPS2).numpy())
    assert np.isfinite(got).all()
    assert np.percentile(err, 99) < 1.0 and np.median(err) < 2e-2


def test_planner_clamp_leaves_the_envelope_in_both_packages():
    """At 3,072 bodies K_s = 48 source tiles is no multiple of the 32
    entries a chunk: ``_flat_static`` clamps max_near to 32 while rows open
    up to 41 tiles, so opened tiles fall to the far field. The port does
    what the JAX package does, error included (ROADMAP §3)."""
    n = 3072
    pos, mass = _sorted_plummer(n, seed=0)
    jpos, jmass = jnp.asarray(pos), jnp.asarray(mass)
    tpos, tmass = torch.from_numpy(pos.copy()), torch.from_numpy(mass.copy())
    kw = dict(tile=32, src_tile=64, vip_tiles=16, mac_tau=jtc.DEFAULT_MAC_TAU, eps2=EPS2,
              compensate=COMP)
    max_near = jtc.suggest_max_near(jpos, jmass, **kw)
    flat_cap = jtc.suggest_flat_cap(jpos, jmass, **kw)
    assert ttc._flat_static(n, 32, 64, 0.55, max_near, 16)[3] == 32
    assert int(ttc.open_counts(tpos, tmass, **kw).max()) > 32
    acc_kw = dict(eps2=EPS2, max_near=max_near, tile=32, src_tile=64, vip_tiles=16)
    want = np.asarray(jtc.treecode_acc_flat(
        jpos, jmass, jtc.build_tree_flat(jpos, jmass, max_near=max_near, flat_cap=flat_cap,
                                         **kw), interpret=True, **acc_kw))
    got = ttc.treecode_acc_flat(tpos, tmass, ttc.build_tree_flat(
        tpos, tmass, max_near=max_near, flat_cap=flat_cap, **kw), **acc_kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    exact = direct_acc(tpos, tmass, eps2=EPS2, compensate=COMP).numpy()
    assert np.percentile(_rel_err(got, exact), 99) > 1e-2


# -------------------------------------------------------------- Simulation
PINNED =dict(solver="treecode", tree_flat_cap=64 * 32 * 4, tree_vip_tiles=8,
              tree_rebuild_every=4)


def _unsorted(pos, perm):
    inv = np.empty(len(perm), int)
    inv[np.asarray(perm)] = np.arange(len(perm))
    return np.asarray(pos)[: len(perm)][inv]


@pytest.mark.parametrize("integrator", ["semi_implicit_euler", "leapfrog"])
def test_flat_simulation_matches_jax(integrator):
    """``tree_flat_cap`` pinned and ``tree_far_cap`` left at 0: both
    packages take the single-level flat path, on the CPU as on the card."""
    kw = dict(integrator=integrator, **PINNED)
    js = jnb.Simulation(jnb.SimConfig(donate=False, **kw), jnb.models.plummer(N, seed=11))
    ts = tnb.Simulation(tnb.SimConfig(**kw), tnb.models.plummer(N, seed=11), device="cpu")
    assert tree_path(ts.cfg) == "flat"
    for field in ("tree_tile", "tree_max_near", "tree_flat_cap", "tree_far_cap",
                  "tree_vip_tiles"):
        assert getattr(ts.cfg, field) == getattr(js.cfg, field), field
    assert ts.cfg.tree_tile == 32
    js.run(8)
    ts.run(8)
    # The last resort (step 4): the JAX package's order where the 30-bit
    # keys differ, inside a tie the port's fine key.
    at4 = tnb.Simulation(tnb.SimConfig(**kw), tnb.models.plummer(N, seed=11), device="cpu")
    at4.run(4)
    keys, order = morton_ties.last_resort(at4)
    morton_ties.assert_jax_order_but_ties(ts.sort_perm, js.sort_perm, keys)
    np.testing.assert_array_equal(ts.sort_perm, order)
    pt = _unsorted(ts.state.pos.numpy(), ts.sort_perm)
    assert np.isfinite(pt).all()
    # 1e-4: float32 force sums in another order, over 8 steps.
    np.testing.assert_allclose(pt, _unsorted(js.state.pos, js.sort_perm), rtol=0, atol=1e-4)
    assert len(ts.tree_lists) == 4 and int(ts.state.step) == 8
