"""Tiny analytic fixture: Sun + 8 planets on circular orbits.

The reference's earliest prototype was a 9-body solar system on the CPU
(``unused_files/freeglut_version_backup.txt:8-114``). We keep the same role —
a small system with known behavior for unit tests — but construct it from
public orbital elements with exactly circular velocities, so period error is
purely integrator error (Earth must return to its start after ~1 orbit).

Units: AU, years, solar masses; G = 4*pi^2 (so a 1 AU circular orbit has a
1-year period).
"""

from __future__ import annotations

import numpy as np

from n_body_problem_tpu_torch.state import SimState, make_state

G_AU_YR_MSUN = 4.0 * np.pi ** 2

# (name, semi-major axis [AU], mass [M_sun])  — public ephemeris values.
_PLANETS = [
    ("mercury", 0.387, 1.660e-7),
    ("venus", 0.723, 2.447e-6),
    ("earth", 1.000, 3.003e-6),
    ("mars", 1.524, 3.227e-7),
    ("jupiter", 5.203, 9.545e-4),
    ("saturn", 9.537, 2.858e-4),
    ("uranus", 19.19, 4.366e-5),
    ("neptune", 30.07, 5.151e-5),
]


def solar_system(*, seed: int = 0, dtype=np.float32) -> SimState:
    rng = np.random.default_rng(seed)
    n = 1 + len(_PLANETS)
    pos = np.zeros((n, 3))
    vel = np.zeros((n, 3))
    mass = np.zeros(n)
    mass[0] = 1.0

    for i, (_, a, m) in enumerate(_PLANETS, start=1):
        theta = rng.uniform(0, 2 * np.pi)
        mass[i] = m
        v_circ = np.sqrt(G_AU_YR_MSUN * (mass[0] + m) / a)
        pos[i] = [a * np.cos(theta), a * np.sin(theta), 0.0]
        vel[i] = [-v_circ * np.sin(theta), v_circ * np.cos(theta), 0.0]

    # Zero total momentum so the barycentre stays put.
    vel -= np.average(vel, axis=0, weights=mass)
    return make_state(pos.astype(dtype), vel.astype(dtype), mass.astype(dtype))
