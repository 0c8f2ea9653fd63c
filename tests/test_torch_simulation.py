"""The port's Simulation against the JAX package's, on the same bodies."""

import numpy as np
import pytest
import torch

import n_body_problem_tpu as jnb
import n_body_problem_tpu_torch as tnb
from n_body_problem_tpu_torch import diagnostics as tdiag
from n_body_problem_tpu_torch.ops.registry import SYMMETRIC_RESIDENT_CAP, resolve_solver

TILES = dict(pallas_tile_i=64, pallas_tile_j=128, pallas_sym_tile=64)


@pytest.mark.parametrize("integrator", ["semi_implicit_euler", "leapfrog"])
@pytest.mark.parametrize("solver", ["direct", "pallas", "pallas_symmetric"])
def test_simulation_matches_jax(solver, integrator):
    cfg = dict(solver=solver, integrator=integrator, **TILES)
    js = jnb.Simulation(jnb.SimConfig(**cfg), jnb.models.plummer(200, seed=1))
    ts = tnb.Simulation(tnb.SimConfig(**cfg), tnb.models.plummer(200, seed=1))
    assert (ts.state.n, ts.state.n_real) == (js.state.n, js.state.n_real)
    js.run(10)
    ts.run(10)
    # rtol=1e-4, atol=1e-5: each force is a float32 sum taken in another
    # order than JAX's, and the difference grows over the 10 steps.
    np.testing.assert_allclose(ts.state.pos.numpy(), np.asarray(js.state.pos),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts.state.vel.numpy(), np.asarray(js.state.vel),
                               rtol=1e-4, atol=1e-5)
    dj, dt = js.diagnostics(), ts.diagnostics()
    for key in ("time", "step", "n_real", "n_padded", "overspeed"):
        assert dt[key] == pytest.approx(dj[key], rel=1e-6), key
    # rtol=1e-4 on energies: float32 sums of O(N^2) terms in another order.
    for key in ("kinetic", "potential", "energy"):
        assert dt[key] == pytest.approx(dj[key], rel=1e-4), key
    # Momenta are sums that cancel to ~1e-9; compare them absolutely.
    for key in ("momentum", "angular_momentum", "max_abs_xyzm"):
        np.testing.assert_allclose(dt[key], dj[key], rtol=1e-4, atol=1e-7, err_msg=key)


def test_auto_resolves_to_mxu_on_cpu():
    sim = tnb.Simulation(tnb.SimConfig(), tnb.models.plummer(100, seed=0))
    assert sim.solver == "mxu"
    assert sim.state.n == 256   # mxu pads to block_size, as JAX does


def test_auto_rule_on_cuda():
    assert resolve_solver("auto", "cuda", 65536) == "pallas_symmetric"
    assert resolve_solver("auto", "cuda", SYMMETRIC_RESIDENT_CAP) == "pallas_symmetric"
    assert resolve_solver("auto", "cuda", SYMMETRIC_RESIDENT_CAP + 1) == "pallas"
    assert resolve_solver("auto", "cuda") == "pallas_symmetric"
    assert resolve_solver("direct", "cuda", 10) == "direct"


@pytest.mark.parametrize("solver", ["treecode", "pair_matrix"])
def test_unported_solvers_name_the_roadmap(solver):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tnb.Simulation(tnb.SimConfig(solver=solver), tnb.models.plummer(64, seed=0))


def test_morton_sort_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tnb.Simulation(tnb.SimConfig(morton_sort=True), tnb.models.plummer(64, seed=0))


def test_pallas_runs_bitwise_equal():
    """The all-pairs path has a fixed summation order (the port's
    counterpart of tests/test_determinism.py:19-28)."""
    cfg = tnb.SimConfig(solver="pallas", **TILES)
    out = []
    for _ in range(2):
        sim = tnb.Simulation(cfg, tnb.models.plummer(128, seed=0))
        sim.run(25)
        out.append(sim.state.pos.clone())
    assert torch.equal(out[0], out[1])


def test_semi_implicit_euler_matches_reference_update():
    """One step is exactly v += a*dt; x += v*dt (kernel.cu:777-801)."""
    cfg = tnb.SimConfig(solver="direct", dt=0.008)
    state = tnb.models.plummer(32, seed=0)
    from n_body_problem_tpu_torch.ops.registry import make_force_fn

    a0 = make_force_fn(cfg)(state.pos, state.mass)
    out = tnb.make_step_fn(cfg)(state)
    v_want = state.vel + a0 * cfg.dt
    torch.testing.assert_close(out.vel, v_want, rtol=0, atol=0)
    torch.testing.assert_close(out.pos, state.pos + v_want * cfg.dt, rtol=0, atol=0)
    assert int(out.step) == 1 and out.step.dtype == torch.int32
    assert float(out.time) == pytest.approx(cfg.dt, rel=1e-6)


@pytest.mark.parametrize("integrator,tol", [("leapfrog", 1e-4), ("semi_implicit_euler", 5e-3)])
def test_energy_drift_plummer(integrator, tol):
    """tests/test_integrators.py:53-64 through the symmetric path."""
    cfg = tnb.SimConfig(solver="pallas_symmetric", integrator=integrator, dt=0.002,
                        pallas_sym_tile=128)
    sim = tnb.Simulation(cfg, tnb.models.plummer(256, seed=4))
    e0 = float(tdiag.total_energy(sim.state, cfg))
    sim.run(200)
    e1 = float(tdiag.total_energy(sim.state, cfg))
    assert abs((e1 - e0) / e0) < tol


def test_trajectory_and_movie_not_ported():
    sim = tnb.Simulation(tnb.SimConfig(solver="direct"), tnb.models.plummer(16, seed=0))
    with pytest.raises(NotImplementedError):
        sim.trajectory(4)
    with pytest.raises(NotImplementedError):
        sim.movie(4, 2, None)


def test_pairs_per_step_counts_real_bodies():
    sim = tnb.Simulation(tnb.SimConfig(solver="pallas", **TILES),
                         tnb.models.plummer(200, seed=0))
    assert sim.pairs_per_step() == 200 * 199
    assert sim.padded_pairs_per_step() == 256 * 256
