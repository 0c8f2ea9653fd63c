"""Morton (Z-order) spatial sorting.

Counterpart of ``n_body_problem_tpu.utils.morton``. Sorting bodies along a
space-filling curve makes consecutive tiles spatially compact, which the
treecode's acceptance relies on; the force physics is permutation-invariant.

- Host side (numpy): :func:`morton_keys` (21 bits a dimension),
  :func:`morton_argsort` and :func:`apply_permutation`, behind
  ``SimConfig.morton_sort`` and ``resort_every``.
- Device side (torch): :func:`morton_keys_cols` (int32 keys, 10 bits a
  dimension; :func:`morton_keys_device` on (N, 3) positions),
  :func:`resort_cols` and :func:`device_resort`, which the treecode run
  loop calls every ``tree_rebuild_every`` steps. One stable
  ``torch.sort`` of the keys gives the permutation and a gather applies it
  to each column; the TPU's multi-operand sort network is not needed on a
  GPU, where a gather is cheap.

Padding bodies (slots ``>= n_real``) get the largest key, so a stable sort
keeps them at the end, where every kernel expects them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def morton_keys_cols(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                     n_real: int) -> torch.Tensor:
    """(N,) int32 Z-order keys from (N,) coordinate columns, on their device.

    10 bits a dimension (30-bit codes): plenty to order tiles. The bounding
    box spans the real bodies only; padding gets ``0x7FFFFFFF``.
    """
    n = x.shape[0]
    mask = torch.arange(n, device=x.device) < n_real
    spread = []
    for c in (x, y, z):
        c = c.to(torch.float32)
        lo = torch.where(mask, c, torch.inf).min()
        hi = torch.where(mask, c, -torch.inf).max()
        span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
        # A true division: torch's ``1023.0 / span`` multiplies by the
        # reciprocal instead, which can move a key by one bit. (full_like
        # fills on the device; new_tensor would copy from the host.)
        scale = torch.div(torch.full_like(span, 1023.0), span)
        q = torch.clamp((c - lo) * scale, 0.0, 1023.0).to(torch.int32)
        spread.append(_spread_bits_10(q))
    key = spread[0] | (spread[1] << 1) | (spread[2] << 2)
    return torch.where(mask, key, torch.full_like(key, 0x7FFFFFFF))


def morton_keys_device(pos: torch.Tensor, n_real: int) -> torch.Tensor:
    """(N,) int32 Z-order keys from (N, 3) positions, on their device (see
    :func:`morton_keys_cols`; 10 bits a dimension, 30-bit codes, where the
    host path keeps 21 bits)."""
    return morton_keys_cols(pos[:, 0], pos[:, 1], pos[:, 2], n_real)


def morton_order(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                 n_real: int) -> torch.Tensor:
    """(N,) int64 permutation: one stable sort of the device keys."""
    key = morton_keys_cols(x, y, z, n_real)
    return torch.sort(key, stable=True).indices


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
