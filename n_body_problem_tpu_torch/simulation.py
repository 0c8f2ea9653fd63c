"""Step loop: build a step function and run it on a device.

Counterpart of ``n_body_problem_tpu.simulation`` for the exact solvers. A
Python loop takes the place of ``lax.scan``: PyTorch runs eagerly, each
step enqueues its kernels on the device's stream, and only the end of
:meth:`Simulation.run` waits for the device.
"""

from __future__ import annotations

import time as _time
from typing import Callable

import torch

from n_body_problem_tpu_torch.config import SimConfig
from n_body_problem_tpu_torch.ops.forces import required_padding
from n_body_problem_tpu_torch.ops.integrators import make_integrator, prime_leapfrog
from n_body_problem_tpu_torch.ops.registry import make_force_fn, resolve_solver
from n_body_problem_tpu_torch.state import SimState, pad_state_to

StepFn = Callable[[SimState], SimState]


def make_step_fn(cfg: SimConfig, device_type: str = "cpu",
                 n: int | None = None) -> StepFn:
    """One simulation step ``state -> state`` (force + integrate)."""
    force_fn = make_force_fn(cfg, device_type, n)
    return make_integrator(cfg.integrator, force_fn, cfg.dt)


def run_steps(state: SimState, step_fn: StepFn, n_steps: int) -> SimState:
    """Advance ``n_steps`` steps."""
    for _ in range(n_steps):
        state = step_fn(state)
    return state


class Simulation:
    """Stateful convenience wrapper.

    >>> sim = Simulation(SimConfig(), models.plummer(1024, seed=0), device="cuda")
    >>> sim.run(100)
    >>> sim.state.pos

    ``device`` defaults to the device the state is on. The state is padded
    with zero-mass bodies to the solver's multiple, exactly as the JAX
    package pads it, and leapfrog runs are primed with one force
    evaluation.
    """

    def __init__(self, cfg: SimConfig, state: SimState,
                 device: str | torch.device | None = None):
        if cfg.morton_sort or cfg.resort_every:
            raise NotImplementedError(
                "morton_sort/resort_every are not ported yet "
                "(ROADMAP §1 item 3: Morton sort)")
        self.device = torch.device(device) if device is not None else state.device
        state = state.to(self.device)
        solver = resolve_solver(cfg.solver, self.device.type, state.n)
        if cfg.tree_tile == 0:
            cfg = cfg.replace(tree_tile=32)
        need = required_padding(
            solver, state.n, cfg.block_size, cfg.pallas_tile_i,
            cfg.pallas_tile_j, cfg.pallas_sym_tile, cfg.tree_tile,
            cfg.tree_src_tile,
        )
        if state.n < need:
            state = pad_state_to(state, need)
        self.cfg = cfg
        self.solver = solver
        if cfg.integrator == "leapfrog":
            state = prime_leapfrog(state, make_force_fn(cfg, self.device.type, state.n))
        self.state = state
        self._step_fn = make_step_fn(cfg, self.device.type, state.n)
        self.wall_seconds = 0.0

    @property
    def step_fn(self) -> StepFn:
        return self._step_fn

    def run(self, n_steps: int) -> SimState:
        """Advance ``n_steps``; returns when the device has finished them."""
        t0 = _time.perf_counter()
        self.state = run_steps(self.state, self._step_fn, n_steps)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall_seconds += _time.perf_counter() - t0
        return self.state

    def trajectory(self, n_steps: int, save_every: int = 1):
        raise NotImplementedError(
            "Simulation.trajectory is not ported yet (ROADMAP §1 item 6)")

    def movie(self, *args, **kwargs):
        raise NotImplementedError(
            "Simulation.movie is not ported yet (ROADMAP §1 item 6: rendering)")

    # ------------------------------------------------------------ metrics
    def pairs_per_step(self) -> int:
        """Physical directed pair interactions per step: n_real*(n_real-1)."""
        k = self.state.n_real
        return k * (k - 1)

    def padded_pairs_per_step(self) -> int:
        """Directed pair evaluations of an all-pairs step (padded N^2)."""
        return self.state.n * self.state.n

    def diagnostics(self) -> dict:
        from n_body_problem_tpu_torch import diagnostics as diag

        return diag.summary(self.state, self.cfg)
