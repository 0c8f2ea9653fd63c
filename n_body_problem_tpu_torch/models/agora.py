"""The AGORA isolated disk galaxy: its collisionless part at the published
counts.

Kim et al. 2016, ApJ 833, 202 ("The AGORA High-resolution Galaxy Simulations
Comparison Project. II. Isolated disk test"), section 2, medium resolution:

- a dark-matter halo, NFW with M200 = 1.074e12 Msun, c = 10, R200 = 205.5
  kpc (v200 = 150 km/s), sampled out to the radius that holds 1.254e12 Msun
  (about 13.4 r_s), 1,000,000 bodies;
- a stellar disk, exponential in R (r_d = 3.432 kpc) and sech^2(z / z_d) in
  z (z_d = 0.1 r_d), 3.437e10 Msun, 1,000,000 bodies;
- a Hernquist bulge (a_b = 0.1 r_d), 4.297e9 Msun, 125,000 bodies, cut at
  the halo's outer radius.

The gas disk is left out, and the halo does not rotate. Units are GADGET's:
kpc, km/s and 1e10 Msun, so G = 43,007.1 and the time unit is 0.9778 Gyr.

Velocities follow the moment method of Hernquist (1993), as MakeDisk does.
Halo and bulge bodies move isotropically, each Cartesian component Gaussian
with the dispersion of the spherical Jeans equation in the total mass (the
disk's taken spherically), a speed above 0.95 of the local escape speed
drawn again. Disk bodies have sigma_z^2 = pi G Sigma(R) z_d and sigma_R =
sigma_z; sigma_phi^2 = sigma_R^2 kappa^2 / (4 Omega^2), with kappa and Omega
from the midplane's circular speed (the disk's own part in Freeman's Bessel
form); and the mean streaming speed of the asymmetric drift,
v_phi^2 = v_c^2 + sigma_R^2 (1 - kappa^2 / (4 Omega^2) - 2 R / r_d),
floored at 0.

A count ``n`` other than the published 2,125,000 keeps the published
fractions (and so the particle masses' 36.5:1 ratio). Everything is drawn
from ``numpy.random.default_rng(seed)`` in float64; the bodies come out in
the order halo, disk, bulge, with the centre of mass and its velocity moved
to zero, as float32.
"""

from __future__ import annotations

import numpy as np

from n_body_problem_tpu_torch.state import SimState, make_state

G_GADGET = 43007.1          # kpc (km/s)^2 / 1e10 Msun
# Table points of the radial profiles, on a logarithmic grid in kpc.
_GRID = 4096
_R_MIN = 1e-3
# Halo and bulge speeds at or above this share of the escape speed are drawn again.
_V_ESC_SHARE = 0.95


def split(n: int, counts=(1_000_000, 1_000_000, 125_000)) -> tuple[int, int, int]:
    """``(halo, disk, bulge)`` bodies of ``n`` in the proportions of
    ``counts``: ``counts`` themselves at their sum."""
    total = sum(counts)
    disk = round(n * counts[1] / total)
    bulge = round(n * counts[2] / total)
    if min(n - disk - bulge, disk, bulge) < 1:
        raise ValueError(f"{n} bodies leave a component empty: give at least 9")
    return n - disk - bulge, disk, bulge


def _nfw_m(x):
    """NFW mass within ``x`` scale radii, in units of 4 pi rho_0 r_s^3."""
    return np.log1p(x) - x / (1.0 + x)


def _nfw_x(target, x0):
    """The ``x`` at which ``_nfw_m(x) = target`` (Newton from ``x0``)."""
    x = np.asarray(x0, dtype=np.float64).copy()
    for _ in range(50):
        step = (_nfw_m(x) - target) * (1.0 + x) ** 2 / x
        x = np.maximum(x - step, 0.5 * x)
        if np.all(np.abs(step) <= 1e-14 * x):
            break
    return x


def _directions(rng: np.random.Generator, n: int) -> np.ndarray:
    z = rng.uniform(-1.0, 1.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    s = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([s * np.cos(phi), s * np.sin(phi), z], axis=-1)


def _outward(f: np.ndarray, r: np.ndarray) -> np.ndarray:
    """``integral_r^{r[-1]} f dr`` at every grid point (trapezoids)."""
    seg = 0.5 * (f[1:] + f[:-1]) * np.diff(r)
    return np.concatenate([np.cumsum(seg[::-1])[::-1], [0.0]])


class Profile:
    """The deployment's mass model on a radial grid: the enclosed masses, the
    spherical potential, the Jeans dispersions of halo and bulge, and the
    midplane's circular speed and epicyclic ratio kappa^2 / (4 Omega^2)."""

    def __init__(self, *, halo_m200, halo_concentration, halo_r200, halo_mass, disk_mass,
                 disk_scale_length, disk_scale_height, bulge_mass, bulge_scale_length, G):
        self.G = G
        self.r_s = halo_r200 / halo_concentration
        m_c = _nfw_m(halo_concentration)
        self.halo_norm = halo_m200 / m_c          # 4 pi rho_0 r_s^3
        self.x_max = float(_nfw_x(halo_mass / self.halo_norm, halo_concentration))
        self.r_max = self.r_s * self.x_max
        self.halo_mass, self.disk_mass, self.bulge_mass = halo_mass, disk_mass, bulge_mass
        self.r_d, self.z_d, self.a_b = disk_scale_length, disk_scale_height, bulge_scale_length
        # Hernquist, cut at r_max: the mass within r_max is bulge_mass.
        self.bulge_inf = bulge_mass * ((self.r_max + self.a_b) / self.r_max) ** 2

        r = np.geomspace(_R_MIN, self.r_max, _GRID)
        self.r = r
        m_tot = self.halo_enclosed(r) + self.bulge_enclosed(r) + self.disk_enclosed(r)
        g = G * m_tot / (r * r)                    # the spherical field
        self.phi = -G * m_tot[-1] / self.r_max - _outward(g, r)
        rho_h = 1.0 / ((r / self.r_s) * (1.0 + r / self.r_s) ** 2)
        rho_b = 1.0 / (r * (r + self.a_b) ** 3)
        self.sigma2_halo = _outward(rho_h * g, r) / rho_h
        self.sigma2_bulge = _outward(rho_b * g, r) / rho_b

        v2 = G * (self.halo_enclosed(r) + self.bulge_enclosed(r)) / r + self.disk_vc2(r)
        kappa2 = np.gradient(v2, r) / r + 2.0 * v2 / (r * r)
        self.vc2 = v2
        self.epicycle = kappa2 / (4.0 * v2 / (r * r))

    def halo_enclosed(self, r):
        return self.halo_norm * _nfw_m(np.minimum(r, self.r_max) / self.r_s)

    def bulge_enclosed(self, r):
        r = np.minimum(r, self.r_max)
        return self.bulge_inf * (r / (r + self.a_b)) ** 2

    def disk_enclosed(self, r):
        """The disk's mass within cylindrical radius ``r``, taken as the
        mass within the sphere of that radius."""
        y = r / self.r_d
        return self.disk_mass * (1.0 - (1.0 + y) * np.exp(-y))

    def disk_vc2(self, R):
        """The disk's own circular speed squared in its midplane (Freeman
        1970): 2 G M_d / r_d y^2 (I0 K0 - I1 K1)(y), y = R / (2 r_d)."""
        from scipy import special

        y = R / (2.0 * self.r_d)
        bessel = special.i0e(y) * special.k0e(y) - special.i1e(y) * special.k1e(y)
        return 2.0 * self.G * self.disk_mass / self.r_d * y * y * bessel

    def surface_density(self, R):
        return self.disk_mass / (2.0 * np.pi * self.r_d ** 2) * np.exp(-R / self.r_d)

    def at(self, table, r):
        return np.interp(r, self.r, table)

    def disk_moments(self, R):
        """``(mean v_phi, sigma_R, sigma_phi, sigma_z)`` of disk bodies at
        cylindrical radius ``R``."""
        sigma2_z = np.pi * self.G * self.surface_density(R) * self.z_d
        ratio = self.at(self.epicycle, R)
        vc2 = self.at(self.vc2, R)
        mean2 = vc2 + sigma2_z * (1.0 - ratio - 2.0 * R / self.r_d)
        sigma_z = np.sqrt(sigma2_z)
        return np.sqrt(np.maximum(mean2, 0.0)), sigma_z, np.sqrt(sigma2_z * ratio), sigma_z


def _isotropic(rng: np.random.Generator, sigma2: np.ndarray, phi: np.ndarray) -> np.ndarray:
    """Gaussian velocities of dispersion ``sigma2`` a component, a speed at
    or above ``_V_ESC_SHARE`` of the escape speed from ``phi`` drawn again."""
    sigma = np.sqrt(np.maximum(sigma2, 0.0))
    limit2 = _V_ESC_SHARE ** 2 * 2.0 * np.abs(phi)
    vel = np.empty((sigma.shape[0], 3))
    need = np.arange(sigma.shape[0])
    while need.size:
        v = sigma[need, None] * rng.standard_normal((need.size, 3))
        ok = (v * v).sum(1) < limit2[need]
        vel[need[ok]] = v[ok]
        need = need[~ok]
    return vel


def draw(n: int, seed: int, *, halo_m200: float = 107.4, halo_concentration: float = 10.0,
         halo_r200: float = 205.5, halo_mass: float = 125.4, disk_mass: float = 3.437,
         disk_scale_length: float = 3.432, disk_scale_height: float = 0.3432,
         bulge_mass: float = 0.4297, bulge_scale_length: float = 0.3432,
         counts=(1_000_000, 1_000_000, 125_000), G: float = G_GADGET):
    """``(profile, [(pos, vel, mass) of halo, disk, bulge])``: float64 arrays
    about the origin, before the centre of mass is moved there."""
    prof = Profile(halo_m200=halo_m200, halo_concentration=halo_concentration,
                   halo_r200=halo_r200, halo_mass=halo_mass, disk_mass=disk_mass,
                   disk_scale_length=disk_scale_length, disk_scale_height=disk_scale_height,
                   bulge_mass=bulge_mass, bulge_scale_length=bulge_scale_length, G=G)
    rng = np.random.default_rng(seed)
    n_h, n_d, n_b = split(n, counts)

    # Halo: the inverse cumulative mass, out to x_max.
    u = rng.uniform(0.0, 1.0, n_h) * _nfw_m(prof.x_max)
    r_h = prof.r_s * _nfw_x(u, np.full(n_h, 1.0))
    halo_pos = r_h[:, None] * _directions(rng, n_h)

    # Disk: R / r_d ~ Gamma(2) (surface density exp(-R / r_d)), redrawn
    # beyond r_max; z from the sech^2 profile's inverse cumulative mass.
    R = rng.gamma(2.0, prof.r_d, n_d)
    while (far := R > prof.r_max).any():
        R[far] = rng.gamma(2.0, prof.r_d, int(far.sum()))
    az = rng.uniform(0.0, 2.0 * np.pi, n_d)
    z = prof.z_d * np.arctanh(np.clip(rng.uniform(-1.0, 1.0, n_d), -1 + 1e-15, 1 - 1e-15))
    c, s = np.cos(az), np.sin(az)
    disk_pos = np.stack([R * c, R * s, z], axis=-1)

    # Bulge: Hernquist's inverse cumulative mass, M(r) / M = r^2 / (r + a)^2.
    q = np.sqrt(rng.uniform(0.0, 1.0, n_b) * (prof.r_max / (prof.r_max + prof.a_b)) ** 2)
    r_b = prof.a_b * q / (1.0 - q)
    bulge_pos = r_b[:, None] * _directions(rng, n_b)

    halo_vel = _isotropic(rng, prof.at(prof.sigma2_halo, r_h), prof.at(prof.phi, r_h))
    v_phi, sigma_R, sigma_phi, sigma_z = prof.disk_moments(R)
    v_R = sigma_R * rng.standard_normal(n_d)
    v_phi = v_phi + sigma_phi * rng.standard_normal(n_d)
    v_z = sigma_z * rng.standard_normal(n_d)
    disk_vel = np.stack([v_R * c - v_phi * s, v_R * s + v_phi * c, v_z], axis=-1)
    bulge_vel = _isotropic(rng, prof.at(prof.sigma2_bulge, r_b), prof.at(prof.phi, r_b))

    parts = [(halo_pos, halo_vel, np.full(n_h, halo_mass / n_h)),
             (disk_pos, disk_vel, np.full(n_d, disk_mass / n_d)),
             (bulge_pos, bulge_vel, np.full(n_b, bulge_mass / n_b))]
    return prof, parts


def agora_arrays(n: int = 2_125_000, seed: int = 0, **params
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(pos (n, 3), vel (n, 3), mass (n,))`` float32 arrays of one
    realisation (halo, disk, bulge in that order), a function of ``n``,
    ``seed`` and the parameters of :func:`draw` alone."""
    _, parts = draw(n, seed, **params)
    pos, vel, mass = (np.concatenate(a) for a in zip(*parts))
    pos -= np.average(pos, axis=0, weights=mass)
    vel -= np.average(vel, axis=0, weights=mass)
    return pos.astype(np.float32), vel.astype(np.float32), mass.astype(np.float32)


def agora_disk(n: int = 2_125_000, *, seed: int = 0, **params) -> SimState:
    """The AGORA isolated disk as a state (see the module's docstring); run
    it with ``G = 43,007.1``, ``compensate = 1`` and ``eps2 = 0.0064``
    ((80 pc)^2), and a step of 0.1 Myr (``dt = 1.0227e-4``)."""
    return make_state(*agora_arrays(n, seed, **params))
