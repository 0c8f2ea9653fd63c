"""The port's Simulation against the JAX package's, on the same bodies."""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

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
    ts = tnb.Simulation(tnb.SimConfig(**cfg), tnb.models.plummer(200, seed=1), device="cpu")
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
    sim = tnb.Simulation(tnb.SimConfig(), tnb.models.plummer(100, seed=0), device="cpu")
    assert sim.solver == "mxu"
    assert sim.state.n == 256   # mxu pads to block_size, as JAX does


def test_auto_rule_on_cuda():
    assert resolve_solver("auto", "cuda", 65536) == "pallas_symmetric"
    assert resolve_solver("auto", "cuda", SYMMETRIC_RESIDENT_CAP) == "pallas_symmetric"
    assert resolve_solver("auto", "cuda", SYMMETRIC_RESIDENT_CAP + 1) == "pallas"
    assert resolve_solver("auto", "cuda") == "pallas_symmetric"
    assert resolve_solver("direct", "cuda", 10) == "direct"


@pytest.mark.parametrize("integrator", ["semi_implicit_euler", "leapfrog"])
@pytest.mark.parametrize("precision", ["bf16x3", "mixed"])
def test_fast_math_simulation_matches_jax(precision, integrator):
    """The symmetric solver's fast modes through Simulation, 448 bodies
    (odd K = 7 at tile 64), 4 steps. rtol=1e-4, atol=1e-5 as for the exact
    solvers: the forces differ from JAX's by float32 summation order."""
    cfg = dict(solver="pallas_symmetric", pallas_sym_tile=64, pallas_sym_precision=precision,
               integrator=integrator)
    js = jnb.Simulation(jnb.SimConfig(**cfg), jnb.models.plummer(448, seed=2))
    ts = tnb.Simulation(tnb.SimConfig(**cfg), tnb.models.plummer(448, seed=2), device="cpu")
    assert ts.state.n == js.state.n == 448
    js.run(4)
    ts.run(4)
    np.testing.assert_allclose(ts.state.pos.numpy(), np.asarray(js.state.pos),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts.state.vel.numpy(), np.asarray(js.state.vel),
                               rtol=1e-4, atol=1e-5)


def test_pair_matrix_simulation_matches_jax():
    """The Method A foil through Simulation: no padding, 10 steps, the same
    tolerances as the exact solvers."""
    js = jnb.Simulation(jnb.SimConfig(solver="pair_matrix"), jnb.models.plummer(300, seed=1))
    ts = tnb.Simulation(tnb.SimConfig(solver="pair_matrix"), tnb.models.plummer(300, seed=1),
                        device="cpu")
    assert ts.solver == "pair_matrix" and ts.state.n == js.state.n == 300
    js.run(10)
    ts.run(10)
    np.testing.assert_allclose(ts.state.pos.numpy(), np.asarray(js.state.pos),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts.state.vel.numpy(), np.asarray(js.state.vel),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("solver", [s for s in tnb.config.SOLVERS if s != "auto"])
def test_every_solver_runs(solver):
    """No solver of the JAX package's SimConfig is refused by the port."""
    sim = tnb.Simulation(tnb.SimConfig(solver=solver, tree_vip_tiles=0, **TILES),
                         tnb.models.plummer(60, seed=0), device="cpu")
    sim.run(1)
    assert sim.solver == solver
    assert bool(torch.isfinite(sim.state.pos).all())


def test_simulation_runs_on_the_gpu_unless_asked_for_the_cpu(monkeypatch):
    """No device given means cuda; without a GPU that raises and names the
    way to the CPU, and never falls back to it quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tnb.Simulation(tnb.SimConfig(), tnb.models.plummer(64, seed=0))
    sim = tnb.Simulation(tnb.SimConfig(), tnb.models.plummer(64, seed=0), device="cpu")
    assert sim.device.type == "cpu" and sim.state.pos.device.type == "cpu"


@pytest.mark.parametrize("n,cfg,path", [
    (4096, dict(), "dense"),                                   # tree_flat_cap 0 on the CPU
    (4096, dict(tree_hier=False, tree_flat_cap=8192), "flat"),  # single-level flat path
    (4096, dict(tree_flat_cap=8192), "flat"),                  # no far lists
    (4096, dict(tree_flat_cap=-1), "dense"),                   # flat path switched off
    (2000, dict(tree_flat_cap=2048, tree_far_cap=4096), "hier"),  # below the hierarchy
])
def test_treecode_config_takes_the_jax_path(n, cfg, path):
    """Each configuration takes the path the JAX package takes for it on the
    CPU, with the same resolved tile and capacities, and gives the JAX
    package's force on the sorted bodies. Far lists pinned below the
    hierarchy's 4,096 bodies are refused by both packages alike."""
    from n_body_problem_tpu.ops.registry import make_force_fn as jax_force_fn
    from n_body_problem_tpu_torch.ops.registry import make_force_fn, tree_path

    kw = dict(solver="treecode", tree_vip_tiles=8, **cfg)
    js = jnb.Simulation(jnb.SimConfig(donate=False, **kw), jnb.models.plummer(n, seed=0))
    ts = tnb.Simulation(tnb.SimConfig(**kw), tnb.models.plummer(n, seed=0), device="cpu")
    assert tree_path(ts.cfg) == path
    for field in ("tree_tile", "tree_max_near", "tree_flat_cap", "tree_far_cap"):
        assert getattr(ts.cfg, field) == getattr(js.cfg, field), field
    np.testing.assert_array_equal(ts.sort_perm, np.asarray(js.sort_perm))
    pos, mass = ts.state.pos, ts.state.mass
    jforce = jax_force_fn(js.cfg, None, js.state.n)
    force = make_force_fn(ts.cfg, "cpu", ts.state.n)
    if path == "hier":
        for fn, args in ((jforce, (js.state.pos, js.state.mass)), (force, (pos, mass))):
            with pytest.raises(ValueError, match="use the flat path"):
                fn(*args)
        return
    want = np.asarray(jforce(js.state.pos, js.state.mass))
    np.testing.assert_allclose(force(pos, mass).numpy(), want, rtol=1e-4, atol=2e-6)


def test_pallas_runs_bitwise_equal():
    """The all-pairs path has a fixed summation order (the port's
    counterpart of tests/test_determinism.py:19-28)."""
    cfg = tnb.SimConfig(solver="pallas", **TILES)
    out = []
    for _ in range(2):
        sim = tnb.Simulation(cfg, tnb.models.plummer(128, seed=0), device="cpu")
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
    sim = tnb.Simulation(cfg, tnb.models.plummer(256, seed=4), device="cpu")
    e0 = float(tdiag.total_energy(sim.state, cfg))
    sim.run(200)
    e1 = float(tdiag.total_energy(sim.state, cfg))
    assert abs((e1 - e0) / e0) < tol


def test_trajectory_and_movie_run():
    """Both run on the CPU and continue the state; the JAX comparison is
    tests/test_torch_movie.py."""
    from n_body_problem_tpu_torch.render import OrbitCamera

    sim = tnb.Simulation(tnb.SimConfig(solver="direct"), tnb.models.plummer(16, seed=0),
                         device="cpu")
    hist = sim.trajectory(4)
    assert hist.shape == (4, 16, 3) and int(sim.state.step) == 4
    torch.testing.assert_close(hist[-1], sim.state.pos, rtol=0, atol=0)
    frames = sim.movie(4, 2, OrbitCamera(distance=2.0), width=32, height=24)
    assert frames.shape == (2, 24, 32, 3) and int(sim.state.step) == 8
    assert bool(frames.isfinite().all()) and float(frames.max()) > 0


def test_pairs_per_step_counts_real_bodies():
    sim = tnb.Simulation(tnb.SimConfig(solver="pallas", **TILES),
                         tnb.models.plummer(200, seed=0), device="cpu")
    assert sim.pairs_per_step() == 200 * 199
    assert sim.padded_pairs_per_step() == 256 * 256


@pytest.mark.parametrize("solver", ["pallas", "pallas_symmetric", "treecode"])
@pytest.mark.parametrize("eps2", [0.0, 1e-39])
def test_card_softening_is_checked_once_at_construction(solver, eps2):
    """The pair kernels take the bare rsqrt instruction, which flushes a
    denormal argument: on "cuda" a solver that reaches a kernel refuses a
    softening below the smallest normal float32, naming the limit and the
    CPU; the CPU and the plain solvers take any."""
    from n_body_problem_tpu_torch.ops.cuda_build import MIN_EPS2
    from n_body_problem_tpu_torch.simulation import require_card_softening

    with pytest.raises(ValueError, match=r'1\.1754944e-38.*device="cpu"'):
        require_card_softening(solver, eps2, device_type="cuda")
    require_card_softening(solver, MIN_EPS2, device_type="cuda")
    require_card_softening(solver, eps2, device_type="cpu")
    require_card_softening("direct", eps2, device_type="cuda")
    # On the CPU the constructor takes such a config, as the JAX package does.
    if eps2 and solver != "treecode":
        cfg = tnb.SimConfig(solver=solver, eps2=eps2, pallas_tile_i=64, pallas_tile_j=64,
                            pallas_sym_tile=64)
        assert tnb.Simulation(cfg, tnb.models.plummer(64, seed=2), device="cpu").solver == solver


def test_potential_energy_blocks_are_bounded_by_pairs(monkeypatch):
    """Beyond 131,072 bodies a block of the O(N^2) energy takes fewer rows,
    so that its temporaries fit beside a run's graphs (at 2,125,000 bodies
    256 rows were 6 GiB); the energy is the same sum within float32's
    rounding of another block order."""
    state = tnb.models.plummer(1000, seed=1)
    cfg = tnb.SimConfig()
    want = tdiag.potential_energy(state, cfg)
    monkeypatch.setattr(tdiag, "_BLOCK_ELEMS", 7 * 1000)   # 7-row blocks
    torch.testing.assert_close(tdiag.potential_energy(state, cfg), want, rtol=1e-5, atol=0)
