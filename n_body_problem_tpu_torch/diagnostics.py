"""Physics diagnostics & validation probes.

Counterpart of ``n_body_problem_tpu.diagnostics``: kinetic / potential /
total energy, linear & angular momentum, centre of mass, the reference's
max-|x|,|y|,|z|,|m| scan (``findMaxAbsValues``, ``kernel.cu:938-965``), the
overspeed guard (``project_develop_code.cu:1089-1091``) and a first-bodies
dump (``printFirstDataPoint``, ``kernel.cu:930-936``).

All functions mask padding bodies via ``state.n_real``.
"""

from __future__ import annotations

import torch

from n_body_problem_tpu_torch.config import SimConfig
from n_body_problem_tpu_torch.state import SimState


def _mask(state: SimState) -> torch.Tensor:
    return state.real_mask().to(state.pos.dtype)


def kinetic_energy(state: SimState) -> torch.Tensor:
    m = _mask(state) * state.mass
    return 0.5 * torch.sum(m * torch.sum(state.vel * state.vel, dim=-1))


# Pairs of one block of ``potential_energy``: its (rows, n, 3) float32
# separations are 384 MiB.
_BLOCK_ELEMS = 1 << 25


def potential_energy(state: SimState, cfg: SimConfig, block_size: int = 256) -> torch.Tensor:
    """Softened pairwise potential, consistent with the force law.

    The compensated force is the exact gradient of
    ``phi_ij = -G m_i m_j * c * (c^2 r^2 + eps2)^(-1/2)``, so energy computed
    here is conserved (up to integrator error) under any of the solvers.
    O(N^2), evaluated in row blocks to bound memory: ``block_size`` rows,
    fewer where a block would pass ``_BLOCK_ELEMS`` pairs (beyond 131,072
    bodies), so that a block's temporaries fit beside a run's graphs
    (2,125,000 bodies: 15 rows).
    """
    c = cfg.compensate
    c2 = c * c
    pos = state.pos
    m = _mask(state) * state.mass
    n = pos.shape[0]
    block_size = max(1, min(block_size, _BLOCK_ELEMS // n))
    total = torch.zeros((), dtype=pos.dtype, device=pos.device)
    for r in range(0, n, block_size):
        pos_i, m_i = pos[r:r + block_size], m[r:r + block_size]
        d = pos[None, :, :] - pos_i[:, None, :]
        r2 = torch.sum(d * d, dim=-1)
        inv = torch.rsqrt(c2 * r2 + cfg.eps2)
        phi = (cfg.G * c) * (m_i[:, None] * m[None, :]) * inv
        rows = torch.arange(pos_i.shape[0], device=pos.device)
        phi[rows, rows + r] = 0.0   # no self-pair
        total = total + (-0.5 * torch.sum(phi))
    return total


def total_energy(state: SimState, cfg: SimConfig) -> torch.Tensor:
    return kinetic_energy(state) + potential_energy(state, cfg)


def momentum(state: SimState) -> torch.Tensor:
    m = (_mask(state) * state.mass)[:, None]
    return torch.sum(m * state.vel, dim=0)


def angular_momentum(state: SimState) -> torch.Tensor:
    m = (_mask(state) * state.mass)[:, None]
    return torch.sum(m * torch.linalg.cross(state.pos, state.vel), dim=0)


def center_of_mass(state: SimState) -> torch.Tensor:
    m = (_mask(state) * state.mass)[:, None]
    total = torch.sum(m)
    return torch.sum(m * state.pos, dim=0) / torch.clamp(total, min=1e-30)


def max_abs(state: SimState, count: int | None = None) -> torch.Tensor:
    """max |x|, |y|, |z|, |mass| over real bodies.

    ``count`` scans exactly the first ``count`` bodies regardless of
    ``n_real`` (the reference hardcodes 20225 at ``kernel.cu:1130``), clamped
    to N."""
    if count is not None:
        k = min(count, state.n)
        pm = torch.abs(state.pos[:k])
        mm = torch.abs(state.mass[:k])
    else:
        w = _mask(state)
        pm = torch.abs(state.pos) * w[:, None]
        mm = torch.abs(state.mass) * w
    return torch.cat([torch.amax(pm, dim=0), torch.amax(mm)[None]])


def overspeed_count(state: SimState, vmax: float = 10.0) -> torch.Tensor:
    """Bodies exceeding |v| >= vmax (dev guard D4, SPEED_MAX=10)."""
    speed2 = torch.sum(state.vel * state.vel, dim=-1)
    return torch.sum((speed2 >= vmax * vmax) & state.real_mask())


def first_bodies(state: SimState, k: int = 5) -> str:
    """Text dump of the first k bodies (``printFirstDataPoint`` role)."""
    pos = state.pos[:k].cpu().numpy()
    mass = state.mass[:k].cpu().numpy()
    lines = [
        f"No.{i} data point: x={pos[i,0]:f}, y={pos[i,1]:f}, z={pos[i,2]:f}, w={mass[i]:f}"
        for i in range(min(k, state.n))
    ]
    return "\n".join(lines)


def summary(state: SimState, cfg: SimConfig) -> dict:
    """Host-side dict of all diagnostics (fetches from the device)."""
    ke = kinetic_energy(state)
    pe = potential_energy(state, cfg)
    p = momentum(state)
    L = angular_momentum(state)
    ma = max_abs(state)
    vmax = cfg.vmax_guard if cfg.vmax_guard > 0 else 10.0
    over = overspeed_count(state, vmax)
    return {
        "time": float(state.time),
        "step": int(state.step),
        "n_real": state.n_real,
        "n_padded": state.n,
        "kinetic": float(ke),
        "potential": float(pe),
        "energy": float(ke + pe),
        "momentum": [float(x) for x in p],
        "angular_momentum": [float(x) for x in L],
        "max_abs_xyzm": [float(x) for x in ma],
        "overspeed": int(over),
    }
