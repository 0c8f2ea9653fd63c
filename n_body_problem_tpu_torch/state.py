"""SimState — the simulation state as torch tensors on one device.

Counterpart of ``n_body_problem_tpu.state``. The layout is the same SoA
form: ``pos[N,3]``, ``vel[N,3]``, ``mass[N]``, the per-body ``eps`` slot the
file formats carry (unused by the force, as in the reference), the carried
acceleration ``acc[N,3]`` that lets leapfrog spend one force evaluation per
step, a 0-d float32 ``time`` and a 0-d int32 ``step``.

``n_real`` is plain metadata: bodies ``n_real..N-1`` are zero-mass padding
at the origin, added so N fits the force kernel's tiling.

This system has no weights, so the state is what moves between the two
packages: :func:`to_numpy` gives the same dict as the JAX package's
``to_numpy`` and :func:`from_numpy` takes either one back.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from n_body_problem_tpu_torch.utils.padding import round_up

_BODY_ARRAYS = ("pos", "vel", "mass", "eps", "acc")   # one row per body
_ARRAYS = _BODY_ARRAYS + ("time", "step")


@dataclasses.dataclass
class SimState:
    pos: torch.Tensor   # (N, 3) positions
    vel: torch.Tensor   # (N, 3) velocities
    mass: torch.Tensor  # (N,)   masses (zero for padding bodies)
    eps: torch.Tensor   # (N,)   per-body softening carried from file formats (unused by force)
    acc: torch.Tensor   # (N, 3) last force evaluation (zeros until first step)
    time: torch.Tensor  # ()     float32 simulation time
    step: torch.Tensor  # ()     int32 step counter
    n_real: int = 0

    @property
    def n(self) -> int:
        """Total (padded) body count."""
        return int(self.pos.shape[0])

    @property
    def n_padding(self) -> int:
        return self.n - self.n_real

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def real_mask(self) -> torch.Tensor:
        """(N,) bool mask selecting real (non-padding) bodies."""
        return torch.arange(self.n, device=self.device) < self.n_real

    def to(self, device: str | torch.device) -> "SimState":
        """The same state with every tensor on ``device``."""
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in _ARRAYS})


def make_state(
    pos: Any,
    vel: Any,
    mass: Any,
    eps: Any | None = None,
    *,
    acc: Any | None = None,
    n_real: int | None = None,
    time: float = 0.0,
    step: int = 0,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> SimState:
    """Build a SimState from array-likes, validating shapes.

    ``acc`` (optional) restores a carried acceleration (checkpoint resume);
    defaults to zeros, which the leapfrog primer refreshes.
    """
    def as_t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    pos, vel, mass = as_t(pos), as_t(vel), as_t(mass)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"pos must be (N, 3), got {tuple(pos.shape)}")
    if vel.shape != pos.shape:
        raise ValueError(f"vel shape {tuple(vel.shape)} != pos shape {tuple(pos.shape)}")
    n = pos.shape[0]
    if mass.shape != (n,):
        raise ValueError(f"mass must be ({n},), got {tuple(mass.shape)}")
    if eps is None:
        eps = torch.zeros((n,), dtype=dtype, device=pos.device)
    else:
        eps = as_t(eps)
        if eps.shape != (n,):
            raise ValueError(f"eps must be ({n},), got {tuple(eps.shape)}")
    if acc is None:
        acc = torch.zeros_like(pos)
    else:
        acc = as_t(acc)
        if acc.shape != pos.shape:
            raise ValueError(f"acc shape {tuple(acc.shape)} != pos shape {tuple(pos.shape)}")
    return SimState(
        pos=pos,
        vel=vel,
        mass=mass,
        eps=eps,
        acc=acc,
        time=torch.tensor(time, dtype=dtype, device=pos.device),
        step=torch.tensor(step, dtype=torch.int32, device=pos.device),
        n_real=int(n if n_real is None else n_real),
    )


def pad_state(state: SimState, multiple: int = 256, extra: int = 0) -> SimState:
    """Pad to a multiple of ``multiple`` (+``extra``) with zero-mass bodies.

    The reference pads to ``ceil(N/256)*256 + 1`` (``kernel.cu:260-278``);
    ``extra=1`` reproduces that count. Self-pairs contribute exactly zero
    force, so the kernels need no ``+1``.
    """
    n = state.n
    target = round_up(max(n, 1), multiple) + extra
    if target == n:
        return state
    if target < n:
        raise ValueError(f"cannot pad {n} bodies down to {target}")
    p = target - n

    def pad(x):
        return torch.cat([x, x.new_zeros((p,) + tuple(x.shape[1:]))])

    return dataclasses.replace(state, **{k: pad(getattr(state, k)) for k in _BODY_ARRAYS})


def pad_state_to(state: SimState, n_total: int) -> SimState:
    """Pad to an absolute body count (zero-mass bodies at the origin)."""
    if n_total < state.n:
        raise ValueError(f"cannot pad {state.n} bodies down to {n_total}")
    return pad_state(state, multiple=1, extra=n_total - state.n)


def unpad_state(state: SimState) -> SimState:
    """Drop padding bodies, returning a state with N == n_real."""
    k = state.n_real
    return dataclasses.replace(state, **{f: getattr(state, f)[:k] for f in _BODY_ARRAYS})


def to_numpy(state: SimState) -> dict:
    """Host-side dict of numpy arrays, key for key and dtype for dtype the
    dict the JAX package's ``to_numpy`` returns."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in _ARRAYS}
    out["n_real"] = np.asarray(state.n_real)
    return out


def from_numpy(d: dict, device: str | torch.device | None = None) -> SimState:
    """The state that :func:`to_numpy` (of either package) gave as ``d``.

    The arrays are copied: the state never shares memory with ``d``, whose
    arrays may be read-only views of another framework's buffers."""
    return make_state(
        np.array(d["pos"]), np.array(d["vel"]), np.array(d["mass"]),
        np.array(d["eps"]),
        acc=np.array(d["acc"]),
        n_real=int(d["n_real"]),
        time=float(d["time"]),
        step=int(d["step"]),
        device=device,
    )
