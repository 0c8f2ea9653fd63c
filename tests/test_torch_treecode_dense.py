"""The port's dense treecode against the JAX package's.

The path the JAX package takes below 2,048 bodies, with ``tree_flat_cap=-1``
at any N, and off the TPU whenever ``tree_flat_cap`` is 0: fixed-size near
lists ``near_idx`` (K, M) at one 32-body tile size, whose tiles are gathered
into one panel a target tile (kernel 4) and swept exactly (kernel 5), plus
the single-level far field (kernel 3) when ``max_near < K`` and the VIP
sweep. Same Morton-sorted Plummer bodies (numpy, seeded) through both
packages; the JAX side runs its Pallas kernels in interpret mode, as
tests/test_treecode.py:59-71 runs them. Integer structures must be equal,
the gather exactly, forces within rtol=1e-4, atol=2e-6.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import jax.numpy as jnp
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
C2, GC3 = COMP * COMP, COMP ** 3
TOL = dict(rtol=1e-4, atol=2e-6)
N = 4096
KW = dict(tile=32, theta=0.5, max_near=48, vip_tiles=16)


def _sorted_plummer(n, seed):
    st = jmodels.plummer(n, seed=seed)
    pos = np.asarray(st.pos)
    perm = morton_argsort(pos)
    return pos[perm], np.asarray(st.mass)[perm]


def _rel_err(acc, exact):
    return (np.linalg.norm(acc - exact, axis=1)
            / np.maximum(np.linalg.norm(exact, axis=1), 1e-12))


def _both(n, seed):
    pos, mass = _sorted_plummer(n, seed)
    return (jnp.asarray(pos), jnp.asarray(mass),
            torch.from_numpy(pos.copy()), torch.from_numpy(mass.copy()))


@pytest.fixture(scope="module")
def case():
    jpos, jmass, tpos, tmass = _both(N, seed=3)
    jaux = tuple(np.asarray(a) for a in jtc.build_tree(jpos, jmass, **KW))
    taux = ttc.build_tree(tpos, tmass, **KW)
    return dict(jpos=jpos, jmass=jmass, tpos=tpos, tmass=tmass, jaux=jaux, taux=taux)


def _operands(case):
    aux = tuple(torch.from_numpy(a.copy()) for a in case["jaux"])
    ops = ttc.kernel_operands(case["tpos"], case["tmass"], aux[2], compensate=COMP,
                              src_tile=32, vip_src=16, plan=(N // 32,))
    return aux, ops


# ------------------------------------------------------- planners, lists
@pytest.mark.parametrize("n,tile,max_near,vip", [
    (1024, 32, 416, 16), (4096, 32, 45, 16), (20480, 32, 416, 128), (2048, 64, 7, 0)])
def test_static_args_equal_jax(n, tile, max_near, vip):
    assert (ttc._static_args(n, tile, 0.55, max_near, vip)
            == jtc._static_args(n, tile, 0.55, max_near, vip))


@pytest.mark.parametrize("n,mac_tau,max_near", [
    (1024, jtc.DEFAULT_MAC_TAU, 32), (4096, 0.0, 48), (4096, jtc.DEFAULT_MAC_TAU, 64)])
def test_build_tree_equals_jax(n, mac_tau, max_near):
    """``near_idx`` (ties ordered as ``lax.top_k`` orders them), the near
    mask (scattered from the lists, never a (K, M, K) comparison) and the
    VIP bodies."""
    jpos, jmass, tpos, tmass = _both(n, seed=n)
    kw = dict(tile=32, max_near=max_near, vip_tiles=16, mac_tau=mac_tau, eps2=EPS2,
              compensate=COMP)
    want = [np.asarray(a) for a in jtc.build_tree(jpos, jmass, **kw)]
    got = [a.numpy() for a in ttc.build_tree(tpos, tmass, **kw)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------- plain twins vs JAX kernels
def test_gather_plain_equals_jax_kernel(case):
    """Kernel 4's twin against ``_gather_kernel`` (through
    ``_gather_panels_pallas``, interpreted): a copy, so exactly equal. The
    port's (K, M T, 4) rows are the JAX (4, K, M T) panels permuted."""
    aux, ops = _operands(case)
    scaled = jnp.where(jnp.asarray(case["jaux"][2]), 0.0, case["jmass"]) * jnp.float32(GC3)
    want = np.asarray(jtc._gather_panels_pallas(
        case["jpos"], scaled, jnp.asarray(case["jaux"][0]), 32, True))
    got = ct.gather_panels_plain(ops["bodies"], aux[0], tile=32)
    assert got.shape == (N // 32, 48 * 32, 4)
    np.testing.assert_array_equal(got.permute(2, 0, 1).numpy(), want)
    np.testing.assert_array_equal(
        got.permute(2, 0, 1).numpy(),
        np.asarray(jtc._gather_panels(case["jpos"], scaled, jnp.asarray(case["jaux"][0]), 32)))


def test_near_panel_plain_matches_jax_kernel(case):
    """Kernel 5's twin against ``_near_kernel`` (through
    ``_near_field_pallas``, interpreted), within rtol 5e-4, atol 5e-5: the
    JAX package's own bound between its two near paths
    (tests/test_treecode.py:70-71)."""
    aux, ops = _operands(case)
    panels = ct.gather_panels_plain(ops["bodies"], aux[0], tile=32)
    want = np.asarray(jtc._near_field_pallas(
        case["jpos"], jnp.asarray(panels.permute(2, 0, 1).numpy()), eps2=EPS2, c2=C2,
        tile=32, interpret=True))
    got = ct.near_panel_plain(ops["bodies"], panels, tile=32, eps2=EPS2, c2=C2)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-5)


# ------------------------------------------------------------- whole force
@pytest.mark.parametrize("use_pallas", [False, True])
def test_treecode_acc_matches_jax(case, use_pallas):
    """Against the JAX package's CPU branch (XLA gather, two dense VIP
    sweeps) and its TPU branch (kernels 4, 5, 3 and the VIP kernel,
    interpreted)."""
    want = np.asarray(jtc.treecode_acc(
        case["jpos"], case["jmass"], tuple(jnp.asarray(a) for a in case["jaux"]),
        eps2=EPS2, use_pallas=use_pallas, interpret=True, **KW))
    got = ttc.treecode_acc(case["tpos"], case["tmass"],
                           tuple(torch.from_numpy(a.copy()) for a in case["jaux"]),
                           eps2=EPS2, **KW)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    built = ttc.treecode_acc(case["tpos"], case["tmass"], eps2=EPS2, **KW)
    torch.testing.assert_close(built, got, rtol=0, atol=0)


# -------------------------------------------- the JAX tests' envelopes
def test_error_envelope_theta_half():
    """tests/test_treecode.py:33-45 through the port."""
    _, _, pos, mass = _both(8192, seed=1)
    m = ttc.suggest_max_near(pos, mass, tile=32, theta=0.5, vip_tiles=32)
    got = ttc.treecode_acc(pos, mass, eps2=EPS2, tile=32, theta=0.5, max_near=m,
                           vip_tiles=32).numpy()
    err = _rel_err(got, direct_acc(pos, mass, eps2=EPS2).numpy())
    assert np.median(err) < 5e-4, np.median(err)
    assert np.percentile(err, 99) < 2e-3, np.percentile(err, 99)


def test_exact_when_capacity_covers_everything():
    """tests/test_treecode.py:48-56: max_near >= K is the direct sum."""
    _, _, pos, mass = _both(2048, seed=2)
    got = ttc.treecode_acc(pos, mass, eps2=EPS2, tile=32, theta=0.5, max_near=64,
                           vip_tiles=0)
    np.testing.assert_allclose(got.numpy(), direct_acc(pos, mass, eps2=EPS2).numpy(),
                               **TOL)


def test_vip_tiles_are_exact_both_ways():
    """tests/test_treecode.py:139-152: the largest-radius tiles' bodies get
    exact forces."""
    _, _, pos, mass = _both(2048, seed=6)
    want = direct_acc(pos, mass, eps2=EPS2).numpy()
    got = ttc.treecode_acc(pos, mass, eps2=EPS2, tile=32, theta=0.5, max_near=16,
                           vip_tiles=16).numpy()
    radius = ttc.tile_summaries_cols(*pos.unbind(1), mass, 32)[2].numpy()
    vip = np.argsort(-radius, kind="stable")[:16]
    rows = (vip[:, None] * 32 + np.arange(32)).reshape(-1)
    assert np.percentile(_rel_err(got[rows], want[rows]), 99) < 1e-4


def test_long_run_stability_with_device_resort():
    """tests/test_treecode.py:176-192: on the CPU the default treecode
    Simulation takes the dense path, as the JAX package's does; the device
    resort and rebuild keep 200 steps of a live Plummer core bounded."""
    cfg = tnb.SimConfig(solver="treecode", tree_vip_tiles=8, dt=0.008)
    sim = tnb.Simulation(cfg, tnb.models.plummer(2048, seed=31), device="cpu")
    assert tree_path(sim.cfg) == "dense"
    e0 = sim.diagnostics()["energy"]
    sim.run(200)
    d = sim.diagnostics()
    assert abs((d["energy"] - e0) / e0) < 0.01
    assert d["overspeed"] == 0
    assert sorted(sim.sort_perm.tolist()) == list(range(2048))


# -------------------------------------------------------------- Simulation
def _unsorted(pos, perm):
    inv = np.empty(len(perm), int)
    inv[np.asarray(perm)] = np.arange(len(perm))
    return np.asarray(pos)[: len(perm)][inv]


@pytest.mark.parametrize("integrator", ["semi_implicit_euler", "leapfrog"])
def test_dense_simulation_matches_jax(integrator):
    """The default treecode at 1,024 bodies: the dense path, whose planned
    capacity covers all K tiles (the exact near field, no far kernel)."""
    kw = dict(solver="treecode", integrator=integrator, tree_rebuild_every=4)
    js = jnb.Simulation(jnb.SimConfig(donate=False, **kw), jnb.models.plummer(1024, seed=11))
    ts = tnb.Simulation(tnb.SimConfig(**kw), tnb.models.plummer(1024, seed=11),
                        device="cpu")
    assert tree_path(ts.cfg) == "dense"
    for field in ("tree_tile", "tree_max_near", "tree_flat_cap", "tree_vip_tiles"):
        assert getattr(ts.cfg, field) == getattr(js.cfg, field), field
    assert (ts.cfg.tree_tile, ts.cfg.tree_max_near) == (32, 1024 // 32)
    js.run(8)
    ts.run(8)
    np.testing.assert_array_equal(ts.sort_perm, np.asarray(js.sort_perm))
    pt = _unsorted(ts.state.pos.numpy(), ts.sort_perm)
    assert np.isfinite(pt).all()
    np.testing.assert_allclose(pt, _unsorted(js.state.pos, js.sort_perm), rtol=0, atol=1e-4)
    near_idx, near_mask, is_vip = ts.tree_lists
    assert near_idx.shape == (32, 32) and near_mask.all() and int(ts.state.step) == 8
    assert ts.diagnostics()["time"] == pytest.approx(js.diagnostics()["time"], rel=1e-6)
