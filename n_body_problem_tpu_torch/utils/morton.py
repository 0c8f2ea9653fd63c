"""Morton (Z-order) spatial sorting.

Counterpart of ``n_body_problem_tpu.utils.morton``. Sorting bodies along a
space-filling curve makes consecutive tiles spatially compact, which the
treecode's acceptance relies on; the force physics is permutation-invariant.

- Host side (numpy): :func:`morton_keys` (21 bits a dimension),
  :func:`morton_argsort` and :func:`apply_permutation`, behind
  ``SimConfig.morton_sort`` and ``resort_every``.
- Device side (torch): :func:`morton_keys_cols` (int32 keys, 10 bits a
  dimension, the JAX package's; :func:`morton_keys_device` on (N, 3)
  positions), :func:`morton_keys_wide` (int64 keys of 63 bits: the 30-bit
  key, then the body's place inside its key cell at 11 bits a dimension),
  :func:`resort_cols` and :func:`device_resort`, which the treecode run
  loop calls every ``tree_rebuild_every`` steps. One stable
  ``torch.sort`` of the wide keys gives the permutation and a gather
  applies it to each column; the TPU's multi-operand sort network is not
  needed on a GPU, where a gather is cheap. The order across 30-bit cells
  is the JAX package's; inside a crowded cell (a galaxy's centre holds
  thousands of bodies in one) the wide key orders the bodies anew, where
  the 30-bit key alone would keep the last sort's order among them, so
  that consecutive tiles stay compact as bodies move.

Padding bodies (slots ``>= n_real``) get the largest key, so a stable sort
keeps them at the end, where every kernel expects them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from n_body_problem_tpu_torch.utils import profiling


def _spread_bits_21(v: np.ndarray) -> np.ndarray:
    """Interleave 21-bit integers with two zero bits (uint64)."""
    x = v.astype(np.uint64)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton_keys(pos: np.ndarray, bits: int = 21) -> np.ndarray:
    """(N,) uint64 Z-order keys from (N, 3) positions (host-side)."""
    pos = np.asarray(pos, dtype=np.float64)
    lo = pos.min(axis=0)
    span = pos.max(axis=0) - lo
    span = np.where(span > 0, span, 1.0)
    scale = (2**bits - 1) / span
    q = np.clip((pos - lo) * scale, 0, 2**bits - 1).astype(np.uint64)
    return (
        _spread_bits_21(q[:, 0])
        | (_spread_bits_21(q[:, 1]) << np.uint64(1))
        | (_spread_bits_21(q[:, 2]) << np.uint64(2))
    )


def morton_argsort(pos) -> np.ndarray:
    """Permutation putting bodies in Z-order (host-side; ``pos`` may be a
    tensor on any device)."""
    if isinstance(pos, torch.Tensor):
        pos = pos.detach().cpu().numpy()
    return np.argsort(morton_keys(pos), kind="stable")


def apply_permutation(state, perm):
    """Reorder a SimState's bodies (a new state; padding must be re-applied
    afterwards if ``perm`` covers only the real bodies)."""
    idx = torch.as_tensor(np.asarray(perm), dtype=torch.int64, device=state.device)
    return dataclasses.replace(
        state, pos=state.pos[idx], vel=state.vel[idx], mass=state.mass[idx],
        eps=state.eps[idx], acc=state.acc[idx])


# ------------------------------------------------------------ device-side
def _spread_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Interleave 10-bit integers with two zero bits (int32)."""
    x = v.to(torch.int32)
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _spread_bits_11(v: torch.Tensor) -> torch.Tensor:
    """Interleave 11-bit integers with two zero bits (int64, 33-bit codes)."""
    x = v.to(torch.int64)
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def _cells(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, n_real: int):
    """``(mask, [t_x, t_y, t_z])``: the real bodies' mask and each axis's
    position in key cells over the real bodies' box, clamped to [0, 1023]."""
    n = x.shape[0]
    mask = torch.arange(n, device=x.device) < n_real
    out = []
    for c in (x, y, z):
        c = c.to(torch.float32)
        lo = torch.where(mask, c, torch.inf).min()
        hi = torch.where(mask, c, -torch.inf).max()
        span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
        # A true division: torch's ``1023.0 / span`` multiplies by the
        # reciprocal instead, which can move a key by one bit. (full_like
        # fills on the device; new_tensor would copy from the host.)
        scale = torch.div(torch.full_like(span, 1023.0), span)
        out.append(torch.clamp((c - lo) * scale, 0.0, 1023.0))
    return mask, out


def morton_keys_cols(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                     n_real: int) -> torch.Tensor:
    """(N,) int32 Z-order keys from (N,) coordinate columns, on their device.

    10 bits a dimension (30-bit codes), the JAX package's keys. The bounding
    box spans the real bodies only; padding gets ``0x7FFFFFFF``.
    """
    mask, t = _cells(x, y, z, n_real)
    return _coarse(mask, t)


def _coarse(mask: torch.Tensor, t) -> torch.Tensor:
    """The 30-bit keys of ``_cells``' output."""
    q = [_spread_bits_10(c.to(torch.int32)) for c in t]
    key = q[0] | (q[1] << 1) | (q[2] << 2)
    return torch.where(mask, key, torch.full_like(key, 0x7FFFFFFF))


def morton_keys_wide(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                     n_real: int) -> torch.Tensor:
    """(N,) int64 keys of 63 bits, the device order: the 30-bit key of
    :func:`morton_keys_cols` on top, and below it a 33-bit Z-order code (11
    bits a dimension) of the body's place inside that key's cell, from the
    same box and division. Bodies of distinct 30-bit keys keep their order;
    those that share one (a crowded cell) are ordered inside it. Padding
    gets every bit set."""
    mask, t = _cells(x, y, z, n_real)
    fine = []
    for c in t:
        frac = c - c.to(torch.int32).to(torch.float32)        # in [0, 1)
        fine.append(_spread_bits_11(torch.clamp(frac * 2048.0, 0.0, 2047.0).to(torch.int32)))
    low = fine[0] | (fine[1] << 1) | (fine[2] << 2)
    key = (_coarse(mask, t).to(torch.int64) << 33) | low
    return torch.where(mask, key, torch.full_like(key, 0x7FFFFFFFFFFFFFFF))


def morton_keys_device(pos: torch.Tensor, n_real: int) -> torch.Tensor:
    """(N,) int32 Z-order keys from (N, 3) positions, on their device (see
    :func:`morton_keys_cols`; 10 bits a dimension, 30-bit codes, where the
    host path keeps 21 bits)."""
    return morton_keys_cols(pos[:, 0], pos[:, 1], pos[:, 2], n_real)


def morton_order(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                 n_real: int) -> torch.Tensor:
    """(N,) int64 permutation: one stable sort of :func:`morton_keys_wide`,
    inside the device phase ``resort.order`` (``utils.profiling``), which
    closes with the ``tied_bodies`` counter (:func:`tied_bodies`) where it
    records."""
    stamp = profiling.stamper(x.device)
    stamp.begin("resort.order")
    key, perm = torch.sort(morton_keys_wide(x, y, z, n_real), stable=True)
    stamp.end("resort.order", tied_bodies(key, n_real) if stamp.live else None)
    return perm


def tied_bodies(key: torch.Tensor, n_real: int) -> torch.Tensor:
    """(1,) int64: the real bodies whose 30-bit key equals their
    predecessor's in the order of the sorted wide keys ``key``, the part of
    the order that the fine key decides."""
    coarse = key[:n_real] >> 33
    return (coarse[1:] == coarse[:-1]).sum(dtype=torch.int64).reshape(1)


def resort_cols(cols, n_real: int) -> tuple[torch.Tensor, ...]:
    """Z-order any number of (N,) body columns; ``cols[0:3]`` must be x, y, z."""
    perm = morton_order(cols[0], cols[1], cols[2], n_real)
    return tuple(c[perm] for c in cols)


def device_resort(state, ids: torch.Tensor):
    """Z-order a SimState on its device: ``(state, ids)``, where ``ids[i]``
    is the input slot of the body now at slot i. Padding stays at the end."""
    perm = morton_order(state.pos[:, 0], state.pos[:, 1], state.pos[:, 2],
                        state.n_real)
    return dataclasses.replace(
        state, pos=state.pos[perm], vel=state.vel[perm], acc=state.acc[perm],
        mass=state.mass[perm], eps=state.eps[perm]), ids[perm]
