"""Plummer-sphere initial conditions (BASELINE.json config 1).

Standard Aarseth/Henon/Wielen sampling in N-body units (G = M = 1,
virial radius ~ 1): radius from the inverse CDF of the Plummer cumulative
mass profile, speed from rejection sampling of q^2 (1 - q^2)^(7/2) against
the local escape speed. The reference ships galaxy snapshots as files; this
is the equivalent self-consistent generator for procedural workloads.
"""

from __future__ import annotations

import numpy as np

from n_body_problem_tpu_torch.state import SimState, make_state


def _random_directions(rng: np.random.Generator, n: int) -> np.ndarray:
    z = rng.uniform(-1.0, 1.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    s = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([s * np.cos(phi), s * np.sin(phi), z], axis=-1)


def plummer(
    n: int,
    *,
    seed: int = 0,
    total_mass: float = 1.0,
    scale_radius: float = 1.0,
    G: float = 1.0,
    dtype=np.float32,
) -> SimState:
    rng = np.random.default_rng(seed)

    # Radii: M(r)/M = r^3 / (r^2 + a^2)^(3/2)  =>  r = a (u^(-2/3) - 1)^(-1/2).
    # Resample the far tail (the raw inverse CDF has unbounded support and
    # occasionally yields 1e5-radius outliers that wreck fp32 conditioning).
    r_max = 20.0 * scale_radius
    u_max = (1.0 + (scale_radius / r_max) ** 2) ** -1.5
    u = rng.uniform(0.0, u_max, n)
    u = np.clip(u, 1e-10, u_max)
    r = scale_radius / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    pos = r[:, None] * _random_directions(rng, n)

    # Speeds: v = q * v_esc(r), q ~ q^2 (1-q^2)^(7/2) by rejection.
    q = np.empty(n)
    need = np.ones(n, dtype=bool)
    while need.any():
        k = int(need.sum())
        x = rng.uniform(0.0, 1.0, k)
        y = rng.uniform(0.0, 0.1, k)
        ok = y < x * x * (1.0 - x * x) ** 3.5
        idx = np.flatnonzero(need)[ok]
        q[idx] = x[ok]
        need[idx] = False
    v_esc = np.sqrt(2.0 * G * total_mass) * (r * r + scale_radius * scale_radius) ** -0.25
    vel = (q * v_esc)[:, None] * _random_directions(rng, n)

    # Centre the realization (zero net momentum & centroid).
    mass = np.full(n, total_mass / n)
    pos -= np.average(pos, axis=0, weights=mass)
    vel -= np.average(vel, axis=0, weights=mass)

    return make_state(pos.astype(dtype), vel.astype(dtype), mass.astype(dtype))
