"""The control: the plain reference put in the program's place, computed in
a lower precision than the configurations state (bfloat16 for their
float32), with the integrator the configuration states (a leapfrog primed
with one force evaluation, as the program primes it). It has the same
``run`` and ``frame`` as ``nbody_bench.port.Port``, so the harness drives
and judges it as it does the program, and a sound comparison has to call it
not correct. It imports nothing of the program."""

from __future__ import annotations

import numpy as np
import torch

from nbody_bench.reference import splat
from nbody_bench.reference.gravity import INTEGRATORS, Physics
from nbody_bench.snapshot import Snapshot


class Control:
    def __init__(self, config: dict, traffic: dict, pos: np.ndarray, vel: np.ndarray,
                 mass: np.ndarray, device: str, dtype: torch.dtype = torch.bfloat16):
        self.phys = Physics.of(config)
        self.dtype = dtype
        as_t = lambda a: torch.as_tensor(a, device=device).to(dtype)  # noqa: E731
        self.pos, self.vel, self.mass = as_t(pos), as_t(vel), as_t(mass)
        self.acc = None
        self.step = 0

    def run(self, n_steps: int) -> Snapshot:
        self.pos, self.vel, self.acc = INTEGRATORS[self.phys.integrator].steps(
            self.pos, self.vel, self.mass, self.phys, n_steps, self.acc)
        self.step += n_steps
        return Snapshot(self.pos.float(), self.vel.float(), self.acc.float(), None, self.step)

    def frame(self, view: dict) -> torch.Tensor:
        vp = splat.view_projection(view["theta_deg"], view["phi_deg"], view["distance"],
                                   view["width"] / view["height"])
        return splat.frame(self.pos, self.mass, vp, view["scale"], width=view["width"],
                           height=view["height"], dtype=self.dtype).float()
