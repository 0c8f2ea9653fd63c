"""A test generator of a disk galaxy with two particle masses, written into
a copy of the benchmark as ``inputs/three_component.py`` to show that such a
deployment is added by files alone.

Three components, G = 1 and total mass 1: a Plummer halo of heavy bodies (a
quarter of the count, each 10 times the mass of the others), an exponential
disk (half) and a Plummer bulge (the rest) of light bodies. Disk bodies
orbit at the circular speed of the mass inside their radius, halo and bulge
bodies move isotropically at a fraction of it. Everything is drawn from
``numpy.random.default_rng(seed)`` and returned as float32 arrays.
"""

from __future__ import annotations

import numpy as np

HEAVY = 10.0


def _directions(rng: np.random.Generator, n: int) -> np.ndarray:
    z = rng.uniform(-1.0, 1.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    s = np.sqrt(1.0 - z * z)
    return np.stack([s * np.cos(phi), s * np.sin(phi), z], axis=-1)


def _plummer(rng: np.random.Generator, n: int, a: float) -> np.ndarray:
    u = rng.uniform(1e-6, 0.99, n)             # cumulative mass, cut at 99 %
    return (a / np.sqrt(u ** (-2.0 / 3.0) - 1.0))[:, None] * _directions(rng, n)


def generate(n: int, seed: int, *, halo_scale: float = 1.0, disk_scale: float = 0.5,
             disk_height: float = 0.1, bulge_scale: float = 0.3
             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    n_halo, n_disk = n // 4, n // 2
    n_bulge = n - n_halo - n_disk
    weight = np.concatenate([np.full(n_halo, HEAVY), np.ones(n_disk + n_bulge)])
    mass = weight / weight.sum()

    radius = rng.gamma(2.0, disk_scale, n_disk)  # surface density exp(-R / scale)
    phi = rng.uniform(0.0, 2.0 * np.pi, n_disk)
    disk = np.stack([radius * np.cos(phi), radius * np.sin(phi),
                     rng.laplace(0.0, disk_height, n_disk)], axis=-1)
    pos = np.concatenate([_plummer(rng, n_halo, halo_scale), disk,
                          _plummer(rng, n_bulge, bulge_scale)])

    r = np.linalg.norm(pos, axis=1)
    order = np.argsort(r)
    enclosed = np.empty(n)
    enclosed[order] = np.cumsum(mass[order])
    v_circ = np.sqrt(enclosed / np.maximum(r, 1e-3))
    vel = (v_circ * rng.uniform(0.3, 0.7, n))[:, None] * _directions(rng, n)
    tangent = np.stack([-np.sin(phi), np.cos(phi), np.zeros(n_disk)], axis=-1)
    vel[n_halo:n_halo + n_disk] = v_circ[n_halo:n_halo + n_disk, None] * tangent

    pos -= np.average(pos, axis=0, weights=mass)
    vel -= np.average(vel, axis=0, weights=mass)
    return pos.astype(np.float32), vel.astype(np.float32), mass.astype(np.float32)
