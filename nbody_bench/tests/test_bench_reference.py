"""The benchmark's plain reference and frozen copies against the program's
plain CPU twins, at a small N. The tests import both; the reference imports
nothing of the program."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from n_body_problem_tpu_torch import models
from n_body_problem_tpu_torch.ops import forces
from n_body_problem_tpu_torch.ops.integrators import (leapfrog_step, prime_leapfrog,
                                                     semi_implicit_euler_step)
from n_body_problem_tpu_torch.render import OrbitCamera, render_state
from n_body_problem_tpu_torch.state import make_state
from nbody_bench import judge
from nbody_bench.inputs import plummer
from nbody_bench.reference import gravity, splat

PHYS = gravity.Physics(dt=0.008, G=1.0, eps2=1e-6, compensate=0.1,
                       integrator="semi_implicit_euler")


@pytest.mark.parametrize("n,seed", [(512, 0), (1000, 2**31 + 5)])
def test_the_generator_is_the_programs_to_the_bit(n, seed):
    pos, vel, mass = plummer.generate(n, seed)
    s = models.plummer(n, seed=seed)
    assert np.array_equal(pos, s.pos.numpy()) and np.array_equal(vel, s.vel.numpy())
    assert np.array_equal(mass, s.mass.numpy()) and pos.dtype == np.float32


def test_the_force_agrees_with_the_direct_sum():
    pos, _, mass = plummer.generate(768, 3)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    want = forces.direct_acc(p.double(), m.double(), eps2=PHYS.eps2, compensate=PHYS.compensate)
    got = gravity.accel(p, p, m, PHYS)
    assert torch.allclose(got, want, rtol=1e-10, atol=1e-12)
    rows = gravity.accel(p[::7], p, m, PHYS)      # rows in blocks, any subset
    assert torch.allclose(rows, got[::7], rtol=1e-12, atol=0)


def test_the_jerk_is_the_forces_time_derivative():
    pos, vel, mass = plummer.generate(768, 4)
    p, v, m = (torch.from_numpy(a).double() for a in (pos, vel, mass))
    h = 1e-6
    want = (gravity.accel(p + h * v, p + h * v, m, PHYS)
            - gravity.accel(p - h * v, p - h * v, m, PHYS)) / (2 * h)
    got = gravity.jerk(p, v, p, v, m, PHYS)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))
    rows = gravity.jerk(p[::7], v[::7], p, v, m, PHYS)
    assert torch.allclose(rows, got[::7], rtol=1e-12, atol=0)


def test_the_euler_step_agrees_with_the_integrator(monkeypatch):
    monkeypatch.setattr(gravity, "BLOCK_ELEMS", 1 << 12)   # many blocks
    pos, vel, mass = plummer.generate(640, 4)
    p, v, m = (torch.from_numpy(a).double() for a in (pos, vel, mass))
    state = make_state(p, v, m, dtype=torch.float64)
    want = semi_implicit_euler_step(
        state, lambda x, mm: forces.direct_acc(x, mm, eps2=PHYS.eps2, compensate=PHYS.compensate),
        PHYS.dt)
    x, u, a = gravity.euler(p, v, m, PHYS, 1)
    for got, w in ((x, want.pos), (u, want.vel), (a, want.acc)):
        assert torch.allclose(got, w, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_the_leapfrog_agrees_with_the_integrator(n_steps):
    pos, vel, mass = plummer.generate(640, 6)
    p, v, m = (torch.from_numpy(a).double() for a in (pos, vel, mass))

    def force(x, mm):
        return forces.direct_acc(x, mm, eps2=PHYS.eps2, compensate=PHYS.compensate)

    want = prime_leapfrog(make_state(p, v, m, dtype=torch.float64), force)
    for _ in range(n_steps):
        want = leapfrog_step(want, force, PHYS.dt)
    x, u, a = gravity.leapfrog(p, v, m, PHYS, n_steps)
    for got, w in ((x, want.pos), (u, want.vel), (a, want.acc)):
        assert torch.allclose(got, w, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("integrator", sorted(gravity.INTEGRATORS))
@pytest.mark.parametrize("n", [1, 2, 5, 10, 50])
def test_dx_ref_is_the_integrators_sum_under_a_linear_force(integrator, n):
    """An integrator's ``dx_ref`` against a scalar loop of it whose force
    runs linear from ``a_first`` to ``a_last``: over the ``n`` step starts
    (Euler, whose last force is at ``x - v dt``) or over the ``n + 1``
    positions (leapfrog, whose last force is at ``x``)."""
    dt, v0, a_first, a_last = 0.008, 0.7, -1.3, 2.9
    x, v = 0.0, v0
    if integrator == "leapfrog":
        def force(k):
            return a_first + (a_last - a_first) * k / n
        acc = force(0)
        for k in range(1, n + 1):
            v += acc * dt / 2
            x += v * dt
            acc = force(k)
            v += acc * dt / 2
    else:
        for k in range(n):
            v += (a_first + (a_last - a_first) * k / max(n - 1, 1)) * dt
            x += v * dt
    if integrator != "leapfrog" and n == 1:
        a_last = a_first                  # as the judge takes it: one force a call
    rule = gravity.INTEGRATORS[integrator]
    assert rule.dx_ref(n, dt, v0, a_first, a_last) == pytest.approx(x, rel=1e-12)


@pytest.mark.parametrize("n", [1, 2, 5, 10, 50])
def test_dv_ref_is_the_leapfrogs_kicks_under_a_cubic_force(n):
    """The leapfrog's ``dv_ref`` against a scalar loop of its kicks whose
    force is a cubic in time, given with its derivative at the two ends."""
    dt = 0.008

    def force(t):
        return -1.3 + 2.1 * t - 40.0 * t * t + 310.0 * t ** 3

    def jerk(t):
        return 2.1 - 80.0 * t + 930.0 * t * t

    v = 0.0
    for k in range(n):
        v += (force(k * dt) + force((k + 1) * dt)) * dt / 2
    got = gravity.INTEGRATORS["leapfrog"].dv_ref(n, dt, force(0.0), force(n * dt), jerk(0.0),
                                                 jerk(n * dt))
    assert got == pytest.approx(v, rel=1e-12, abs=1e-15)
    assert gravity.INTEGRATORS["semi_implicit_euler"].dv_ref is None


def test_a_snapshot_is_judged_only_on_its_real_bodies():
    from nbody_bench.snapshot import Snapshot

    x = torch.zeros(6, 3)
    ok = np.array([3, 0, 5, 1, 4, 2])
    assert judge.is_real(Snapshot(x, x, x), 6) and judge.is_real(Snapshot(x, x, x, ok), 6)
    for ids in ([3, 0, 5, 1, 4, 4], [3, 0, 6, 1, 4, 2], [3, 0, 5, 1, 4], [3, 0, -1, 1, 4, 2]):
        assert not judge.is_real(Snapshot(x, x, x, np.array(ids)), 6), ids
    assert not judge.is_real(Snapshot(x, x, x), 5)               # padding handed back
    assert not judge.is_real(Snapshot(x, x, x[:5], ok), 6)
    nums = judge.judge_call(Snapshot(x, x, x), Snapshot(x, x, x, step=2), 2, np.ones(5), PHYS,
                            np.arange(5))
    assert np.isnan(nums["force_p99"]) and nums["steps_gap"] == 0
    assert judge.verdict([nums], {"force_p99": 1.0, "steps_gap": 0})[1] == 1


def test_the_splat_agrees_with_the_renderer():
    pos, _, mass = plummer.generate(3000, 5)
    mass[::50] = 0.05                                # some bodies take the large sprite
    state = make_state(pos, np.zeros_like(pos), mass)
    cam = OrbitCamera(theta_deg=30.0, phi_deg=20.0, distance=3.0, aspect=320 / 240)
    want = render_state(state, cam, width=320, height=240).double()
    vp = splat.view_projection(30.0, 20.0, 3.0, 320 / 240)
    assert np.allclose(vp, cam.view_projection(), rtol=1e-6, atol=1e-6)
    got = splat.frame(torch.from_numpy(pos), torch.from_numpy(mass), vp, width=320, height=240)
    assert float(want.norm()) > 0
    assert float((got - want).norm() / want.norm()) < 1e-5
