"""The plain reference of the physics: the exact softened direct sum and the
semi-implicit Euler step, in plain PyTorch, on any device and in any dtype.

It imports nothing of the program. The pair function is the one the
configuration files state (the reference's ``kernel.cu:665-692``):

    a_i = G sum_j m_j c^3 (x_j - x_i) / (c^2 |x_j - x_i|^2 + eps2)^(3/2)

with the separation pre-scale ``c`` (``compensate``), and the update
``v += a dt; x += v dt`` with ``a`` taken at the step's start
(``kernel.cu:777-801``). The judge runs it in float64; the control runs the
same code in bfloat16, the precision below the float32 the configurations
state.
"""

from __future__ import annotations

import dataclasses

import torch

# Elements of one (rows, sources) block: 2^25 float64 values are 256 MiB.
BLOCK_ELEMS = 1 << 25


@dataclasses.dataclass(frozen=True)
class Physics:
    dt: float
    G: float
    eps2: float
    compensate: float

    @classmethod
    def of(cls, config: dict) -> "Physics":
        p = config["physics"]
        return cls(dt=p["dt"], G=p["G"], eps2=p["eps2"], compensate=p["compensate"])


def accel(targets: torch.Tensor, sources: torch.Tensor, mass: torch.Tensor, phys: Physics,
          dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(T, 3) accelerations of ``targets`` (T, 3) from every body of
    ``sources`` (N, 3) with masses ``mass`` (N,), computed in ``dtype`` in
    blocks of target rows. A target that is also a source adds nothing for
    itself: its separation is zero."""
    t = targets.to(dtype)
    sx, sy, sz = sources.to(dtype).unbind(1)
    m = mass.to(dtype)[None, :]
    c2 = phys.compensate * phys.compensate
    gc3 = phys.G * c2 * phys.compensate
    rows = max(1, BLOCK_ELEMS // sources.shape[0])
    out = []
    for a in range(0, t.shape[0], rows):
        blk = t[a:a + rows]
        dx = sx[None, :] - blk[:, 0:1]
        dy = sy[None, :] - blk[:, 1:2]
        dz = sz[None, :] - blk[:, 2:3]
        w = (m * gc3) * (c2 * (dx * dx + dy * dy + dz * dz) + phys.eps2) ** -1.5
        out.append(torch.stack([(w * dx).sum(1), (w * dy).sum(1), (w * dz).sum(1)], 1))
    return torch.cat(out)


def euler(pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor, phys: Physics,
          n_steps: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n_steps`` semi-implicit Euler steps of every body, in the dtype of
    ``pos``: ``(pos, vel, acc)``, ``acc`` the force of the last step."""
    acc = torch.zeros_like(pos)
    for _ in range(n_steps):
        acc = accel(pos, pos, mass, phys, pos.dtype)
        vel = vel + acc * phys.dt
        pos = pos + vel * phys.dt
    return pos, vel, acc
