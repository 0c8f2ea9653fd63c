"""Time integrators.

Counterpart of ``n_body_problem_tpu.ops.integrators``, with the same update
order:

- ``semi_implicit_euler``: the reference's shipped integrator
  (``use_acc_update_position``, ``kernel.cu:777-801``):
  ``v += a*dt`` then ``x += v*dt`` with ``a`` evaluated at the step's start.
- ``leapfrog`` (kick-drift-kick) in the stored-acceleration form, so each
  step costs one force evaluation: the carried ``state.acc`` is the force at
  the current position.

Both are ``state -> state`` functions that build a new state and leave the
old one untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from n_body_problem_tpu_torch.state import SimState

ForceFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (pos, mass) -> acc


def _advanced(state: SimState, dt: float, **fields) -> SimState:
    return dataclasses.replace(state, time=state.time + dt, step=state.step + 1, **fields)


def semi_implicit_euler_step(state: SimState, force_fn: ForceFn, dt: float) -> SimState:
    acc = force_fn(state.pos, state.mass)
    vel = state.vel + acc * dt
    pos = state.pos + vel * dt
    return _advanced(state, dt, pos=pos, vel=vel, acc=acc)


def leapfrog_step(state: SimState, force_fn: ForceFn, dt: float) -> SimState:
    """KDK leapfrog. Requires ``state.acc`` = force at ``state.pos``
    (:func:`prime_leapfrog`); a zero initial acc only degrades the first
    half-kick to first order."""
    half = 0.5 * dt
    v_half = state.vel + state.acc * half
    pos = state.pos + v_half * dt
    acc = force_fn(pos, state.mass)
    vel = v_half + acc * half
    return _advanced(state, dt, pos=pos, vel=vel, acc=acc)


def prime_leapfrog(state: SimState, force_fn: ForceFn) -> SimState:
    """Fill ``state.acc`` with the force at the current position."""
    return dataclasses.replace(state, acc=force_fn(state.pos, state.mass))


_INTEGRATORS = {
    "semi_implicit_euler": semi_implicit_euler_step,
    "leapfrog": leapfrog_step,
}


def make_integrator(name: str, force_fn: ForceFn, dt: float) -> Callable[[SimState], SimState]:
    try:
        fn = _INTEGRATORS[name]
    except KeyError:
        raise ValueError(f"unknown integrator {name!r}; expected {sorted(_INTEGRATORS)}")

    def step(state: SimState) -> SimState:
        return fn(state, force_fn, dt)

    return step
