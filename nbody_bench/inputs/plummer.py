"""Plummer-sphere initial conditions, the benchmark's own generator.

A frozen copy of the arithmetic of ``n_body_problem_tpu_torch/models/plummer.py``
at commit c8a9ef2832dd3ca6223213d0b57046ed74f6d186, so that a later change to
the program's generator cannot change the benchmark's inputs.

Aarseth, Henon & Wielen (1974) sampling in N-body units (G = M = 1): radius
from the inverse of the cumulative mass profile, cut at 20 scale radii, speed
from rejection sampling of q^2 (1 - q^2)^(7/2) against the local escape
speed, then the centre of mass and its velocity moved to zero. Everything is
drawn from ``numpy.random.default_rng(seed)`` in float64 and returned as
float32 arrays, which the program and the reference are both given.
"""

from __future__ import annotations

import numpy as np


def _random_directions(rng: np.random.Generator, n: int) -> np.ndarray:
    z = rng.uniform(-1.0, 1.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    s = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([s * np.cos(phi), s * np.sin(phi), z], axis=-1)


def plummer(n: int, seed: int, *, total_mass: float = 1.0, scale_radius: float = 1.0,
            G: float = 1.0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(pos (n, 3), vel (n, 3), mass (n,))`` float32 arrays of one
    realisation, a function of ``n`` and ``seed`` alone."""
    rng = np.random.default_rng(seed)
    r_max = 20.0 * scale_radius
    u_max = (1.0 + (scale_radius / r_max) ** 2) ** -1.5
    u = np.clip(rng.uniform(0.0, u_max, n), 1e-10, u_max)
    r = scale_radius / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    pos = r[:, None] * _random_directions(rng, n)

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

    mass = np.full(n, total_mass / n)
    pos -= np.average(pos, axis=0, weights=mass)
    vel -= np.average(vel, axis=0, weights=mass)
    return pos.astype(np.float32), vel.astype(np.float32), mass.astype(np.float32)


# The harness finds a configuration's generator by its module name.
generate = plummer
