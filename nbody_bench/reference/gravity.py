"""The plain reference of the physics: the exact softened direct sum, its
time derivative, the semi-implicit Euler step and the KDK leapfrog, in plain
PyTorch, on any device and in any dtype.

It imports nothing of the program. The pair function is the one the
configuration files state (the reference's ``kernel.cu:665-692``):

    a_i = G sum_j m_j c^3 (x_j - x_i) / (c^2 |x_j - x_i|^2 + eps2)^(3/2)

with the separation pre-scale ``c`` (``compensate``), and the update the
configuration's ``physics.integrator`` names: ``semi_implicit_euler``,
``v += a dt; x += v dt`` with ``a`` taken at the step's start
(``kernel.cu:777-801``), or ``leapfrog``, kick-drift-kick in the
stored-acceleration form (``v += a dt / 2; x += v dt; a = a(x);
v += a dt / 2``, one force a step, primed with the force at the start). The
judge runs it in float64; the control runs the same code in bfloat16, the
precision below the float32 the configurations state.

``INTEGRATORS`` is the one table of the updates a configuration may state:
each name's stepper, and what the judge needs of it (where the state's
``acc`` was taken, and the move and velocity change of ``n`` steps from the
forces at a call's two ends).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

# Elements of one (rows, sources) block: 2^25 float64 values are 256 MiB.
BLOCK_ELEMS = 1 << 25


@dataclasses.dataclass(frozen=True)
class Physics:
    dt: float
    G: float
    eps2: float
    compensate: float
    integrator: str

    @classmethod
    def of(cls, config: dict) -> "Physics":
        p = config["physics"]
        return cls(dt=p["dt"], G=p["G"], eps2=p["eps2"], compensate=p["compensate"],
                   integrator=p["integrator"])


def accel(targets: torch.Tensor, sources: torch.Tensor, mass: torch.Tensor, phys: Physics,
          dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(T, 3) accelerations of ``targets`` (T, 3) from every body of
    ``sources`` (N, 3) with masses ``mass`` (N,), computed in ``dtype`` in
    blocks of target rows. A target that is also a source adds nothing for
    itself: its separation is zero."""
    t = targets.to(dtype)
    sx, sy, sz = sources.to(dtype).unbind(1)
    m = mass.to(dtype)[None, :]
    c2 = phys.compensate * phys.compensate
    gc3 = phys.G * c2 * phys.compensate
    rows = max(1, BLOCK_ELEMS // sources.shape[0])
    out = []
    for a in range(0, t.shape[0], rows):
        blk = t[a:a + rows]
        dx = sx[None, :] - blk[:, 0:1]
        dy = sy[None, :] - blk[:, 1:2]
        dz = sz[None, :] - blk[:, 2:3]
        w = (m * gc3) * (c2 * (dx * dx + dy * dy + dz * dz) + phys.eps2) ** -1.5
        out.append(torch.stack([(w * dx).sum(1), (w * dy).sum(1), (w * dz).sum(1)], 1))
    return torch.cat(out)


def jerk(targets: torch.Tensor, target_vel: torch.Tensor, sources: torch.Tensor,
         source_vel: torch.Tensor, mass: torch.Tensor, phys: Physics,
         dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(T, 3) time derivatives of ``accel`` at ``targets`` moving at
    ``target_vel``, the ``sources`` moving at ``source_vel``, in blocks of
    target rows: the sum over ``j`` of ``G m_j c^3 (u / s^3 - 3 c^2 (d . u)
    d / s^5)``, ``d`` and ``u`` the separation and relative velocity,
    ``s^2 = c^2 |d|^2 + eps2``."""
    t, tv = targets.to(dtype), target_vel.to(dtype)
    sx, sy, sz = sources.to(dtype).unbind(1)
    ux_, uy_, uz_ = source_vel.to(dtype).unbind(1)
    m = mass.to(dtype)[None, :]
    c2 = phys.compensate * phys.compensate
    gc3 = phys.G * c2 * phys.compensate
    rows = max(1, BLOCK_ELEMS // sources.shape[0])
    out = []
    for a in range(0, t.shape[0], rows):
        blk, bv = t[a:a + rows], tv[a:a + rows]
        dx, dy, dz = sx[None, :] - blk[:, 0:1], sy[None, :] - blk[:, 1:2], sz[None, :] - blk[:, 2:3]
        ux, uy, uz = ux_[None, :] - bv[:, 0:1], uy_[None, :] - bv[:, 1:2], uz_[None, :] - bv[:, 2:3]
        s2 = c2 * (dx * dx + dy * dy + dz * dz) + phys.eps2
        w = (m * gc3) * s2 ** -1.5
        q = (3.0 * c2) * w * (dx * ux + dy * uy + dz * uz) / s2
        out.append(torch.stack([(w * ux - q * dx).sum(1), (w * uy - q * dy).sum(1),
                                (w * uz - q * dz).sum(1)], 1))
    return torch.cat(out)


def euler(pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor, phys: Physics,
          n_steps: int, acc: torch.Tensor | None = None
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n_steps`` semi-implicit Euler steps of every body, in the dtype of
    ``pos``: ``(pos, vel, acc)``, ``acc`` the force of the last step (the
    ``acc`` given is not needed: each step takes its own force)."""
    acc = torch.zeros_like(pos)
    for _ in range(n_steps):
        acc = accel(pos, pos, mass, phys, pos.dtype)
        vel = vel + acc * phys.dt
        pos = pos + vel * phys.dt
    return pos, vel, acc


def leapfrog(pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor, phys: Physics,
             n_steps: int, acc: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n_steps`` KDK leapfrog steps of every body, in the dtype of ``pos``:
    ``(pos, vel, acc)``, ``acc`` the force at the returned positions. ``acc``
    is the force at ``pos``, worked out here (one force evaluation) where it
    is not given."""
    if acc is None:
        acc = accel(pos, pos, mass, phys, pos.dtype)
    half = 0.5 * phys.dt
    for _ in range(n_steps):
        vel = vel + acc * half
        pos = pos + vel * phys.dt
        acc = accel(pos, pos, mass, phys, pos.dtype)
        vel = vel + acc * half
    return pos, vel, acc


@dataclasses.dataclass(frozen=True)
class Integrator:
    """An update a configuration may state. ``steps(pos, vel, mass, phys,
    n_steps, acc)`` is its plain stepper. The state's ``acc`` is the force
    at ``x - v dt`` where ``acc_lags`` (the last step's start), else at
    ``x``. ``dx_ref(n, dt, v0, a_first, a_last)`` is the move of ``n``
    steps from velocity ``v0`` with the force linear from ``a_first`` (at
    the call's start) to ``a_last`` (where the state's ``acc`` is taken);
    ``dv_ref(n, dt, a_first, a_last, j_first, j_last)``, where not None, the
    velocity change from the forces and their time derivatives at the
    call's two ends (under Euler the velocity is held already: ``x - v dt``
    is where its ``acc`` must be)."""
    steps: Callable
    acc_lags: bool
    dx_ref: Callable
    dv_ref: Callable | None


def _euler_dx(n, dt, v0, a_first, a_last):
    """``n dt v0 + dt^2 n (n + 1) (a_first / 3 + a_last / 6)``."""
    return n * dt * v0 + dt * dt * n * (n + 1) * (a_first / 3.0 + a_last / 6.0)


def _leapfrog_dx(n, dt, v0, a_first, a_last):
    """``n dt v0 + dt^2 ((2 n^2 + 1) a_first + (n^2 - 1) a_last) / 6``, from
    ``v_{k+1/2} = v0 + dt (a_0 / 2 + sum_{j=1..k} a_j)``; exact for
    ``n = 1``."""
    return n * dt * v0 + dt * dt * ((2 * n * n + 1) * a_first + (n * n - 1) * a_last) / 6.0


def _leapfrog_dv(n, dt, a_first, a_last, j_first, j_last):
    """``dt (a_0 / 2 + a_1 + ... + a_{n-1} + a_n / 2)``, the trapezoid sum
    of the ``n + 1`` forces, as ``n dt (a_first + a_last) / 2 - (n^2 - 1)
    dt^2 (j_last - j_first) / 12``: the Euler-Maclaurin end correction of
    the integral over the call less that of the steps' sum, so exact for a
    force cubic in time and for ``n = 1``."""
    return (n * dt * (a_first + a_last) / 2.0
            - (n * n - 1) * dt * dt * (j_last - j_first) / 12.0)


INTEGRATORS = {
    "semi_implicit_euler": Integrator(euler, True, _euler_dx, None),
    "leapfrog": Integrator(leapfrog, False, _leapfrog_dx, _leapfrog_dv),
}
