"""The AGORA isolated disk (``models/agora.py``): its counts, masses and
profiles, its velocity moments, its frozen copy in the benchmark, and the
port's treecode and leapfrog on it against the benchmark's plain float64
reference (``nbody_bench/reference/gravity.py``: plain PyTorch, nothing of
the program).

This file imports no JAX.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import json
import pathlib

import numpy as np
import pytest
import torch
from scipy import special

import n_body_problem_tpu_torch as tnb
from n_body_problem_tpu_torch.models import agora
from n_body_problem_tpu_torch.ops import treecode
from n_body_problem_tpu_torch.ops.registry import tree_path
from n_body_problem_tpu_torch.utils.morton import morton_argsort
from nbody_bench.reference.gravity import Physics, accel, leapfrog

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "nbody_bench/configs/agora_disk.json").read_text())
PARAMS = CONFIG["generator_params"]
PHYS = Physics.of(CONFIG)
G = PARAMS["G"]


def test_published_counts_masses_and_order():
    assert agora.split(2_125_000) == (1_000_000, 1_000_000, 125_000)
    pos, vel, mass = agora.agora_arrays(2_125_000, seed=1)
    assert pos.shape == vel.shape == (2_125_000, 3) and mass.shape == (2_125_000,)
    assert pos.dtype == vel.dtype == mass.dtype == np.float32
    halo, disk, bulge = mass[:1_000_000], mass[1_000_000:2_000_000], mass[2_000_000:]
    assert (halo == np.float32(125.4 / 1e6)).all()             # 1.254e6 Msun a body
    assert (disk == np.float32(3.437 / 1e6)).all()             # 3.437e4 Msun
    assert (bulge == np.float32(0.4297 / 125_000)).all()       # 3.4376e4 Msun
    assert halo[0] / disk[0] == pytest.approx(36.5, abs=0.05)
    # The centre of mass and its velocity at zero (float32's rounding of a
    # 276 kpc box and of speeds of hundreds of km/s).
    m = mass.astype(np.float64)
    assert np.abs(np.average(pos, axis=0, weights=m)).max() < 1e-3
    assert np.abs(np.average(vel, axis=0, weights=m)).max() < 1e-3


@pytest.mark.parametrize("n", [2048, 4096, 20_000])
def test_another_count_keeps_the_fractions(n):
    h, d, b = agora.split(n)
    assert h + d + b == n and abs(d - h) <= 1
    assert b == round(n * 125 / 2125)
    mass = agora.agora_arrays(n, seed=2)[2]
    assert mass[0] / mass[h] == pytest.approx((125.4 / h) / (3.437 / d), rel=1e-6)
    assert mass.sum() == pytest.approx(125.4 + 3.437 + 0.4297, rel=1e-5)


def test_a_count_that_leaves_a_component_empty_is_refused():
    assert agora.split(9) == (4, 4, 1)
    with pytest.raises(ValueError, match="empty"):
        agora.agora_disk(8)


@pytest.mark.parametrize("seed", [3, 2**40 + 7])
def test_the_benchmarks_copy_is_bitwise_the_programs(seed):
    from nbody_bench.inputs import agora_disk as frozen

    want = frozen.generate(20_000, seed, **PARAMS)
    got = agora.agora_arrays(20_000, seed, **PARAMS)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    state = agora.agora_disk(20_000, seed=seed, **PARAMS)
    np.testing.assert_array_equal(state.pos.numpy(), want[0])


def _ks(sample: np.ndarray, cdf) -> float:
    x = np.sort(sample)
    f = cdf(x)
    k = np.arange(1, x.size + 1) / x.size
    return float(max(np.abs(k - f).max(), np.abs(k - 1.0 / x.size - f).max()))


@pytest.fixture(scope="module")
def drawn():
    return agora.draw(200_000, 5, **PARAMS)


def test_each_component_follows_its_profile(drawn):
    """Kolmogorov-Smirnov distances of each component's cumulative mass
    against its profile, under the 1 % critical value 1.63 / sqrt(n)."""
    prof, ((hp, _, _), (dp, _, _), (bp, _, _)) = drawn
    r_s = PARAMS["halo_r200"] / PARAMS["halo_concentration"]
    nfw = lambda x: np.log1p(x) - x / (1 + x)      # noqa: E731
    r_max = prof.r_max
    assert nfw(r_max / r_s) * PARAMS["halo_m200"] / nfw(10.0) == pytest.approx(125.4)
    a_b, r_d, z_d = PARAMS["bulge_scale_length"], PARAMS["disk_scale_length"], \
        PARAMS["disk_scale_height"]
    cases = [
        (np.linalg.norm(hp, axis=1), lambda r: nfw(r / r_s) / nfw(r_max / r_s)),
        (np.hypot(dp[:, 0], dp[:, 1]), lambda R: 1 - (1 + R / r_d) * np.exp(-R / r_d)),
        (dp[:, 2], lambda z: 0.5 * (1 + np.tanh(z / z_d))),
        (np.linalg.norm(bp, axis=1),
         lambda r: (r / (r + a_b)) ** 2 / (r_max / (r_max + a_b)) ** 2),
    ]
    for sample, cdf in cases:
        assert _ks(sample, cdf) < 1.63 / np.sqrt(sample.size)
    assert np.linalg.norm(hp, axis=1).max() <= r_max and np.linalg.norm(bp, axis=1).max() <= r_max


def _midplane(R):
    """``(v_c^2, kappa^2 / (4 Omega^2))`` of the midplane, written here from
    the profiles: NFW and Hernquist enclosed masses, Freeman's disk."""
    prof = agora.Profile(**{k: v for k, v in PARAMS.items() if k != "counts"})
    r_s = PARAMS["halo_r200"] / PARAMS["halo_concentration"]
    nfw = lambda x: np.log1p(x) - x / (1 + x)      # noqa: E731
    a_b, r_d = PARAMS["bulge_scale_length"], PARAMS["disk_scale_length"]

    def vc2(R):
        m_h = PARAMS["halo_m200"] * nfw(R / r_s) / nfw(10.0)
        m_b = PARAMS["bulge_mass"] * (R / (R + a_b)) ** 2 * ((prof.r_max + a_b) / prof.r_max) ** 2
        y = R / (2 * r_d)
        disk = (2 * G * PARAMS["disk_mass"] / r_d * y * y
                * (special.i0(y) * special.k0(y) - special.i1(y) * special.k1(y)))
        return G * (m_h + m_b) / R + disk

    h = 1e-4 * R
    v2 = vc2(R)
    kappa2 = (vc2(R + h) - vc2(R - h)) / (2 * h) / R + 2 * v2 / (R * R)
    return v2, kappa2 / (4 * v2 / (R * R))


def test_the_disk_follows_the_moment_equations(drawn):
    """In 1 kpc rings from 1 to 10 kpc: v_z / sigma_z and v_R / sigma_R of
    unit variance, sigma_z^2 = pi G Sigma(R) z_d; the mean v_phi that of the
    asymmetric drift, v_c^2 + sigma_R^2 (1 - kappa^2 / 4 Omega^2 - 2 R /
    r_d); its spread sigma_R^2 kappa^2 / 4 Omega^2. Each within four of its
    sampling errors."""
    _, (_, (pos, vel, _), _) = drawn
    r_d, z_d = PARAMS["disk_scale_length"], PARAMS["disk_scale_height"]
    R = np.hypot(pos[:, 0], pos[:, 1])
    cos, sin = pos[:, 0] / R, pos[:, 1] / R
    v_R = vel[:, 0] * cos + vel[:, 1] * sin
    v_phi = -vel[:, 0] * sin + vel[:, 1] * cos
    sigma2 = np.pi * G * PARAMS["disk_mass"] / (2 * np.pi * r_d ** 2) * np.exp(-R / r_d) * z_d
    vc2, ratio = _midplane(R)
    mean = np.sqrt(np.maximum(vc2 + sigma2 * (1 - ratio - 2 * R / r_d), 0.0))
    for lo in range(1, 10):
        ring = (R >= lo) & (R < lo + 1)
        k = int(ring.sum())
        assert k > 1000
        for u in (vel[ring, 2] ** 2 / sigma2[ring], v_R[ring] ** 2 / sigma2[ring],
                  (v_phi[ring] - mean[ring]) ** 2 / (sigma2[ring] * ratio[ring])):
            assert abs(u.mean() - 1) < 4 * np.sqrt(2 / k), (lo, u.mean())
        drift = (v_phi[ring] - mean[ring]) / np.sqrt(sigma2[ring] * ratio[ring])
        assert abs(drift.mean()) < 4 / np.sqrt(k), (lo, drift.mean())


def test_the_realisation_is_near_virial_equilibrium():
    """2T / |W| within 0.9 to 1.1 at 20,000 bodies, W the virial sum of
    m x . a with the float64 reference's softened force (which holds 2T + W
    = 0 for a softened system in equilibrium). The halo's speeds are cut at
    0.95 of the escape speed, which keeps it a little under 1."""
    pos, vel, mass = agora.agora_arrays(20_000, seed=7, **PARAMS)
    p = torch.from_numpy(pos)
    acc = accel(p, p, torch.from_numpy(mass), PHYS).numpy()
    m = mass.astype(np.float64)
    kinetic = 0.5 * (m * (vel.astype(np.float64) ** 2).sum(1)).sum()
    virial = (m * (pos.astype(np.float64) * acc).sum(1)).sum()
    assert 0.9 < 2 * kinetic / abs(virial) < 1.1, 2 * kinetic / abs(virial)


# ------------------------------------------------- the port on the deployment
N = 4096


def _sim(path: str, pos, vel, mass) -> tnb.Simulation:
    """The port's treecode on ``path``, its capacities planned as the card
    plans them (``registry.plan_tree`` with ``tree_flat_cap`` 0) on
    the Morton-sorted bodies; the configuration's physics."""
    order = morton_argsort(pos)
    p, m = torch.from_numpy(pos[order]), torch.from_numpy(mass[order])
    tile = 128 if path == "hier" else 32
    sel = dict(tile=tile, theta=0.55, vip_tiles=8, eps2=PHYS.eps2, compensate=PHYS.compensate)
    if path == "hier":
        caps = treecode.suggest_hier(p, m, src_tile=64, slack=8, mac_tau=0.01, mac_tau0=2e-4,
                                     union_coarse=True, **sel)
        kw = dict(tree_max_near=caps["max_near"], tree_flat_cap=caps["flat_cap"],
                  tree_far_max=caps["far_max"], tree_far_cap=caps["far_cap"])
    else:
        kw = dict(tree_hier=False,
                  tree_max_near=treecode.suggest_max_near(p, m, src_tile=64, mac_tau=2e-4, **sel),
                  tree_flat_cap=treecode.suggest_flat_cap(p, m, src_tile=64, slack=8,
                                                          mac_tau=2e-4, **sel))
    cfg = tnb.SimConfig(solver="treecode", dt=PHYS.dt, G=G, eps2=PHYS.eps2,
                        compensate=PHYS.compensate, integrator="leapfrog", tree_tile=tile,
                        tree_vip_tiles=8, tree_rebuild_every=4, **kw)
    sim = tnb.Simulation(cfg, tnb.state.make_state(pos, vel, mass), device="cpu")
    assert tree_path(sim.cfg) == path
    return sim


@pytest.fixture(scope="module")
def bodies():
    """4,096 bodies in the published fractions: the 36.5:1 mass ratio."""
    return agora.agora_arrays(N, seed=5, **PARAMS)


@pytest.mark.parametrize("path,p99", [("hier", 2.5e-3), ("flat", 2e-3)])
def test_treecode_forces_hold_to_the_reference(bodies, path, p99):
    """The primed force of the port's treecode against the reference's
    float64 sum: the treecode tests' envelopes (tests/test_torch_treecode.py,
    tests/test_torch_treecode_flat.py), p99 and median relative error."""
    sim = _sim(path, *bodies)
    s = sim.state
    exact = accel(s.pos, s.pos, s.mass, PHYS).numpy()
    err = np.linalg.norm(s.acc.numpy() - exact, axis=1) / np.linalg.norm(exact, axis=1)
    assert np.isfinite(err).all()
    assert np.percentile(err, 99) < p99, np.percentile(err, 99)
    assert np.median(err) < 5e-4, np.median(err)


@pytest.mark.parametrize("path", ["hier", "flat"])
def test_ten_leapfrog_steps_hold_to_the_reference(bodies, path):
    """10 KDK steps (two resorts and builds) against the reference's float64
    leapfrog from the same bodies, in input order: positions within the
    integrator tests' rtol 1e-5 / atol 1e-5 (tests/test_torch_integrators.py:
    float32 rounding and the tree's force error over 10 steps); velocities,
    in km/s up to hundreds, within rtol 1e-5 and 1e-5 of the largest speed,
    the same tolerance in the configuration's velocity unit."""
    pos, vel, mass = bodies
    sim = _sim(path, pos, vel, mass)
    sim.run(10)
    ref_pos, ref_vel, _ = leapfrog(*(torch.from_numpy(a).double() for a in (pos, vel, mass)),
                                   PHYS, 10)
    inv = np.empty(N, int)
    inv[sim.sort_perm] = np.arange(N)
    got_pos, got_vel = sim.state.pos.numpy()[:N][inv], sim.state.vel.numpy()[:N][inv]
    ref_pos, ref_vel = ref_pos.numpy(), ref_vel.numpy()
    np.testing.assert_allclose(got_pos, ref_pos, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_vel, ref_vel, rtol=1e-5, atol=1e-5 * np.abs(ref_vel).max())
    assert int(sim.state.step) == 10
