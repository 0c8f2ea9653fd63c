"""The port's integrators and free run functions against the JAX package's
(tests/test_integrators.py), on the CPU.

The orbit, momentum, period and convergence cases are the JAX tests' own,
at their shapes and bounds, on the port's ``Simulation``.
``simulation.run_trajectory`` and ``run_with_frames`` are held to the JAX
functions at the shapes of tests/test_integrators.py:90-109 (positions
within rtol 1e-5 / atol 1e-5, frames within rtol 1e-5 / atol 1e-6 x the
frame's maximum, as tests/test_torch_movie.py holds them) and bitwise to
the port's eager frame loop (``simulation.eager_trajectory``,
``eager_movie``).
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import numpy as np
import pytest
import torch

import n_body_problem_tpu as jnb
import n_body_problem_tpu_torch as tnb
from n_body_problem_tpu import simulation as jsim
from n_body_problem_tpu.render import OrbitCamera as JaxCamera
from n_body_problem_tpu_torch import diagnostics as tdiag
from n_body_problem_tpu_torch import simulation as tsim
from n_body_problem_tpu_torch.models.solar_system import G_AU_YR_MSUN
from n_body_problem_tpu_torch.render import OrbitCamera

POS_TOL = dict(rtol=1e-5, atol=1e-5)
FRAME_RTOL, FRAME_ATOL = 1e-5, 1e-6   # atol x the frame's maximum
W, H = 64, 48


def _sim(cfg, state):
    return tnb.Simulation(cfg, state, device="cpu")


def test_two_body_circular_orbit_leapfrog():
    """An equal-mass binary on a circular orbit returns near its start after
    one period under leapfrog (tests/test_integrators.py:33)."""
    m, sep = 1.0, 1.0
    v = np.sqrt(m / (2 * sep))
    pos = np.array([[-0.5, 0, 0], [0.5, 0, 0]])
    vel = np.array([[0, -v, 0], [0, v, 0]])
    period = 2 * np.pi * 0.5 / v
    n_steps = 2000
    cfg = tnb.SimConfig(solver="direct", integrator="leapfrog", dt=period / n_steps,
                        eps2=1e-12, compensate=1.0)
    sim = _sim(cfg, tnb.make_state(pos, vel, np.array([m, m])))
    sim.run(n_steps)
    np.testing.assert_allclose(sim.state.pos.numpy(), pos, atol=2e-3)


def test_momentum_conserved_under_scan():
    """tests/test_integrators.py:67."""
    cfg = tnb.SimConfig(solver="direct", integrator="leapfrog", dt=0.005)
    sim = _sim(cfg, tnb.models.plummer(128, seed=5))
    p0 = tdiag.momentum(sim.state).numpy()
    sim.run(100)
    np.testing.assert_allclose(tdiag.momentum(sim.state).numpy(), p0, atol=1e-4)


def test_earth_period():
    """Earth completes one orbit in about a year (tests/test_integrators.py:77)."""
    cfg = tnb.SimConfig(solver="direct", integrator="leapfrog", dt=1.0 / 2000,
                        eps2=1e-12, compensate=1.0, G=G_AU_YR_MSUN)
    sim = _sim(cfg, tnb.models.solar_system(seed=0))
    start = sim.state.pos[3].numpy().copy()
    sim.run(2000)
    assert np.linalg.norm(sim.state.pos[3].numpy() - start) < 0.15


def test_leapfrog_second_order_convergence():
    """Halving dt cuts leapfrog's energy error about 4x, semi-implicit
    Euler's about 2x (tests/test_integrators.py:112)."""
    t_total = 0.64

    def drift(integrator, dt):
        cfg = tnb.SimConfig(solver="direct", integrator=integrator, dt=dt)
        sim = _sim(cfg, tnb.models.plummer(64, seed=12))
        e0 = float(tdiag.total_energy(sim.state, cfg))
        sim.run(int(round(t_total / dt)))
        return abs((float(tdiag.total_energy(sim.state, cfg)) - e0) / e0)

    assert drift("leapfrog", 0.008) / max(drift("leapfrog", 0.004), 1e-12) > 2.5
    eu = drift("semi_implicit_euler", 0.008) / max(drift("semi_implicit_euler", 0.004), 1e-12)
    assert eu > 1.4


def _pair(seed):
    """The JAX and the port's step function and a 64-body Plummer sphere of
    each (tests/test_integrators.py:90-109)."""
    jcfg = jnb.SimConfig(solver="direct", dt=0.01)
    tcfg = tnb.SimConfig(solver="direct", dt=0.01)
    return ((jnb.models.plummer(64, seed=seed), jsim.make_step_fn(jcfg)),
            (tnb.models.plummer(64, seed=seed), tnb.make_step_fn(tcfg)))


def test_run_trajectory_matches_jax():
    (js, jstep), (ts, tstep) = _pair(6)
    jstate, jhist = jsim.run_trajectory(js, jstep, 20, save_every=5)
    tstate, thist = tsim.run_trajectory(ts, tstep, 20, save_every=5)
    assert tuple(thist.shape) == (4, 64, 3) and int(tstate.step) == 20
    np.testing.assert_allclose(thist.numpy(), np.asarray(jhist), **POS_TOL)
    np.testing.assert_allclose(tstate.pos.numpy(), np.asarray(jstate.pos), **POS_TOL)
    torch.testing.assert_close(thist[-1], tstate.pos, rtol=0, atol=0)
    assert int(ts.step) == 0   # the input state is not changed


def test_run_with_frames_matches_jax():
    (js, jstep), (ts, tstep) = _pair(7)
    jcam, tcam = JaxCamera(distance=3.0), OrbitCamera(distance=3.0)
    scale = (1.0, 1.0, 1.0)
    jstate, want = jsim.run_with_frames(js, jstep, 20, 5, jcam.view_projection(),
                                        np.asarray(scale, np.float32), W, H)
    tstate, got = tsim.run_with_frames(ts, tstep, 20, 5, tcam.view_projection(), scale, W, H)
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape == (4, H, W, 3) and int(tstate.step) == 20
    assert want.max() > 0, "blank frames"
    np.testing.assert_allclose(got.numpy(), want, rtol=FRAME_RTOL, atol=FRAME_ATOL * want.max())
    np.testing.assert_allclose(tstate.pos.numpy(), np.asarray(jstate.pos), **POS_TOL)


@pytest.mark.parametrize("kind", ["trajectory", "movie"])
def test_free_functions_are_the_eager_loop_bitwise(kind):
    """The free functions' run (the programs of a ``StaticRun`` of their
    own, called directly on the CPU) against ``Simulation``'s eager frame
    loop with the same step function."""
    sim = _sim(tnb.SimConfig(solver="direct", dt=0.01), tnb.models.plummer(64, seed=6))
    cam, scale = OrbitCamera(distance=3.0), (0.5, 0.5, 0.5)
    if kind == "trajectory":
        want, want_state, _ = tsim.eager_trajectory(sim, 20, 5)
        state, got = tsim.run_trajectory(sim.state, sim.step_fn, 20, 5)
    else:
        want, want_state, _ = tsim.eager_movie(sim, 20, 5, cam, scale, width=W, height=H)
        state, got = tsim.run_with_frames(sim.state, sim.step_fn, 20, 5,
                                          torch.as_tensor(cam.view_projection()),
                                          torch.tensor(scale), W, H)
    assert torch.equal(got, want)
    for k in ("pos", "vel", "acc", "time", "step"):
        assert torch.equal(getattr(state, k), getattr(want_state, k)), k


@pytest.mark.parametrize("kind,name", [("trajectory", "save_every"), ("movie", "render_every")])
def test_free_functions_refuse_a_ragged_span(kind, name):
    """The JAX functions' ``ValueError``, word for word."""
    (js, jstep), (ts, tstep) = _pair(6)
    vp = OrbitCamera().view_projection()
    calls = {"trajectory": (lambda: jsim.run_trajectory(js, jstep, 21, 5),
                            lambda: tsim.run_trajectory(ts, tstep, 21, 5)),
             "movie": (lambda: jsim.run_with_frames(js, jstep, 21, 5, vp, np.zeros(3, np.float32),
                                                    W, H),
                       lambda: tsim.run_with_frames(ts, tstep, 21, 5, vp, (0, 0, 0), W, H))}
    for call in calls[kind]:
        with pytest.raises(ValueError, match=f"^n_steps must be a multiple of {name}$"):
            call()
