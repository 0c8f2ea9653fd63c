"""The system under test: ``n_body_problem_tpu_torch``, reached only through
its public entry points (``SimConfig``, ``Simulation``, ``state.make_state``,
``render.OrbitCamera``, ``render.splat.render_state``; the per-layer readers
add ``ops.registry.tree_fns``)."""

from __future__ import annotations

import numpy as np
import torch

from nbody_bench.snapshot import Snapshot


class Port:
    """A ``Simulation`` of the configuration's physics and the mix's solver,
    made from the benchmark's input arrays on ``device``."""

    def __init__(self, config: dict, traffic: dict, pos: np.ndarray, vel: np.ndarray,
                 mass: np.ndarray, device: str):
        from n_body_problem_tpu_torch import SimConfig, Simulation
        from n_body_problem_tpu_torch.state import make_state

        p = config["physics"]
        cfg = SimConfig(dt=p["dt"], G=p["G"], eps2=p["eps2"], compensate=p["compensate"],
                        integrator=p["integrator"], solver=traffic["solver"],
                        **traffic.get("settings", {}))
        self.sim = Simulation(cfg, make_state(pos, vel, mass, device=device), device=device)
        self.camera = None

    def run(self, n_steps: int) -> Snapshot:
        """The state after ``n_steps`` steps, its real bodies only: the
        program pads with zero-mass bodies to its solver's multiple and keeps
        the padding last, and ``sort_perm`` names the real slots alone."""
        s = self.sim.run(n_steps)
        k = s.n_real
        return Snapshot(s.pos[:k], s.vel[:k], s.acc[:k], self.sim.sort_perm, s.step)

    def frame(self, view: dict) -> torch.Tensor:
        """The frame of the current state, (H, W, 3) on the device."""
        from n_body_problem_tpu_torch.render import OrbitCamera
        from n_body_problem_tpu_torch.render.splat import render_state

        if self.camera is None:
            self.camera = OrbitCamera(theta_deg=view["theta_deg"], phi_deg=view["phi_deg"],
                                      distance=view["distance"],
                                      aspect=view["width"] / view["height"])
        return render_state(self.sim.state, self.camera, tuple(view["scale"]),
                            width=view["width"], height=view["height"])
