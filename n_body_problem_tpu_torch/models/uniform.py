"""Simple procedural clouds: uniform cube and cold collapsing sphere.

The cold sphere plays the role of the reference's ``stars.dat`` "star
cluster explosion" dataset (``kernel.cu:996-1000``): a near-cold cloud that
collapses and rebounds.
"""

from __future__ import annotations

import numpy as np

from n_body_problem_tpu_torch.state import SimState, make_state


def uniform_cube(
    n: int,
    *,
    seed: int = 0,
    half_extent: float = 1.0,
    total_mass: float = 1.0,
    velocity_scale: float = 0.0,
    dtype=np.float32,
) -> SimState:
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-half_extent, half_extent, (n, 3))
    vel = velocity_scale * rng.standard_normal((n, 3))
    mass = np.full(n, total_mass / n)
    return make_state(pos.astype(dtype), vel.astype(dtype), mass.astype(dtype))


def cold_sphere(
    n: int,
    *,
    seed: int = 0,
    radius: float = 1.0,
    total_mass: float = 1.0,
    virial_ratio: float = 0.05,
    G: float = 1.0,
    dtype=np.float32,
) -> SimState:
    """Uniform-density sphere with a small isotropic velocity dispersion.

    ``virial_ratio`` = 2T/|W|; 0.5 is equilibrium, << 0.5 collapses.
    """
    rng = np.random.default_rng(seed)
    # Uniform in the ball: r ~ u^(1/3).
    u = rng.uniform(0.0, 1.0, n)
    z = rng.uniform(-1.0, 1.0, n)
    phi = rng.uniform(0.0, 2 * np.pi, n)
    s = np.sqrt(np.maximum(0.0, 1 - z * z))
    dirs = np.stack([s * np.cos(phi), s * np.sin(phi), z], axis=-1)
    pos = radius * u[:, None] ** (1.0 / 3.0) * dirs

    # |W| = (3/5) G M^2 / R for a uniform sphere; sigma from the virial ratio.
    w = 0.6 * G * total_mass * total_mass / radius
    sigma = np.sqrt(max(virial_ratio, 0.0) * w / total_mass / 3.0)
    vel = sigma * rng.standard_normal((n, 3))
    mass = np.full(n, total_mass / n)
    pos -= pos.mean(axis=0)
    vel -= vel.mean(axis=0)
    return make_state(pos.astype(dtype), vel.astype(dtype), mass.astype(dtype))
