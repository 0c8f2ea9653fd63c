"""Disk-galaxy and galaxy-collision generators.

The reference's default dataset (id 1) is ``dubinski.tab`` — the classic
Dubinski two-galaxy collision — which is absent from the mounted reference
copy (``.MISSING_LARGE_BLOBS``). These generators provide equivalent
workloads procedurally: an exponential disk with a central point-mass bulge
on near-circular orbits, and two such disks on an approach trajectory.
"""

from __future__ import annotations

import numpy as np

from n_body_problem_tpu_torch.state import SimState, make_state


def _disk(
    rng: np.random.Generator,
    n: int,
    *,
    disk_mass: float,
    bulge_mass: float,
    scale_length: float,
    thickness: float,
    G: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    # Exponential surface density: R from the inverse CDF via rejection-free
    # sampling of Gamma(2) (sum of two exponentials).
    r = scale_length * (rng.standard_gamma(2.0, n))
    theta = rng.uniform(0, 2 * np.pi, n)
    z = thickness * rng.standard_normal(n)
    pos = np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=-1)

    # Circular speed from the enclosed mass (bulge + crude disk interior).
    m_star = disk_mass / n
    frac_inside = 1.0 - (1.0 + r / scale_length) * np.exp(-r / scale_length)
    m_enc = bulge_mass + disk_mass * frac_inside
    v_circ = np.sqrt(G * m_enc / np.maximum(r, 1e-6))
    vel = np.stack([-v_circ * np.sin(theta), v_circ * np.cos(theta), np.zeros(n)], axis=-1)
    # Small dispersion for stability.
    vel += 0.05 * v_circ[:, None] * rng.standard_normal((n, 3))
    mass = np.full(n, m_star)

    # Central bulge as one heavy particle at rest.
    pos = np.concatenate([np.zeros((1, 3)), pos])
    vel = np.concatenate([np.zeros((1, 3)), vel])
    mass = np.concatenate([[bulge_mass], mass])
    return pos, vel, mass


def disk_galaxy(
    n: int,
    *,
    seed: int = 0,
    disk_mass: float = 0.5,
    bulge_mass: float = 0.5,
    scale_length: float = 1.0,
    thickness: float = 0.05,
    G: float = 1.0,
    dtype=np.float32,
) -> SimState:
    """One rotating disk of ``n`` stars + 1 central bulge particle."""
    rng = np.random.default_rng(seed)
    pos, vel, mass = _disk(
        rng, n, disk_mass=disk_mass, bulge_mass=bulge_mass,
        scale_length=scale_length, thickness=thickness, G=G,
    )
    return make_state(pos.astype(dtype), vel.astype(dtype), mass.astype(dtype))


def galaxy_collision(
    n: int,
    *,
    seed: int = 0,
    separation: float = 6.0,
    impact_parameter: float = 1.5,
    approach_speed: float = 0.4,
    inclination_deg: float = 30.0,
    G: float = 1.0,
    dtype=np.float32,
) -> SimState:
    """Two disk galaxies on a collision course (dubinski.tab workload role).

    ``n`` is the total star count (split evenly); 2 extra bulge particles.
    """
    rng = np.random.default_rng(seed)
    half = n // 2
    p1, v1, m1 = _disk(rng, half, disk_mass=0.5, bulge_mass=0.5,
                       scale_length=1.0, thickness=0.05, G=G)
    p2, v2, m2 = _disk(rng, n - half, disk_mass=0.5, bulge_mass=0.5,
                       scale_length=1.0, thickness=0.05, G=G)

    # Incline the second disk.
    a = np.deg2rad(inclination_deg)
    rot = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    p2 = p2 @ rot.T
    v2 = v2 @ rot.T

    off = np.array([separation / 2, impact_parameter / 2, 0.0])
    kick = np.array([approach_speed / 2, 0.0, 0.0])
    pos = np.concatenate([p1 - off, p2 + off])
    vel = np.concatenate([v1 + kick, v2 - kick])
    mass = np.concatenate([m1, m2])
    pos -= np.average(pos, axis=0, weights=mass)
    vel -= np.average(vel, axis=0, weights=mass)
    return make_state(pos.astype(dtype), vel.astype(dtype), mass.astype(dtype))
