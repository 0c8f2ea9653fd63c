"""The benchmark's plain reference and frozen copies against the program's
plain CPU twins, at a small N. The tests import both; the reference imports
nothing of the program."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from n_body_problem_tpu_torch import models
from n_body_problem_tpu_torch.ops import forces
from n_body_problem_tpu_torch.ops.integrators import semi_implicit_euler_step
from n_body_problem_tpu_torch.render import OrbitCamera, render_state
from n_body_problem_tpu_torch.state import make_state
from nbody_bench.inputs import plummer
from nbody_bench.reference import gravity, splat

PHYS = gravity.Physics(dt=0.008, G=1.0, eps2=1e-6, compensate=0.1)


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
