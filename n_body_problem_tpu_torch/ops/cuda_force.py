"""Blocked all-pairs force: the hand-written CUDA kernel and its plain twin.

Counterpart of ``n_body_problem_tpu.ops.pallas_force``:
:func:`block_acc` stands where ``pallas_block_acc`` stands and
:func:`allpairs_acc` where ``pallas_acc`` does. On a CUDA tensor the
wrapper launches ``allpairs_acc_kernel`` (``csrc/allpairs.cu``); on a CPU
tensor it runs :func:`block_acc_plain`, the same function in plain PyTorch,
which is also what the kernel is checked against on the card. There is no
other path: a failed build or launch raises.

The kernel's loop order is fixed and it uses no atomics, so its result is
bitwise the same from run to run.
"""

from __future__ import annotations

import torch

from n_body_problem_tpu_torch.ops import cuda_build
from n_body_problem_tpu_torch.ops.forces import pair_accel_tile

DEFAULT_TILE_I = 256
DEFAULT_TILE_J = 1024
# Largest (rows x columns) pair block the plain version materialises at once.
_PLAIN_PAIRS = 1 << 24


def block_acc_plain(
    pos_i: torch.Tensor,
    pos_j: torch.Tensor,
    mass_j: torch.Tensor,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
) -> torch.Tensor:
    """acc (Ni, 3) of the row bodies due to every column body, as a
    broadcast over row blocks small enough that N=65,536 fits in memory."""
    rows = max(1, _PLAIN_PAIRS // max(pos_j.shape[0], 1))
    return torch.cat([
        pair_accel_tile(pos_i[r:r + rows], pos_j, mass_j, eps2=eps2,
                        compensate=compensate, G=G)
        for r in range(0, pos_i.shape[0], rows)
    ])


def _launch(pos_i, pos_j, mass_j, *, eps2, compensate, G) -> torch.Tensor:
    dev = pos_i.device
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    for name, t, shape in (("pos_i", pos_i, (ni, 3)), ("pos_j", pos_j, (nj, 3)),
                           ("mass_j", mass_j, (nj,))):
        cuda_build.require_f32(name, t, shape, dev)
    if max(ni, nj) > cuda_build.MAX_BODIES:
        raise ValueError(f"block_acc: at most {cuda_build.MAX_BODIES} bodies per side")
    c2 = compensate * compensate
    cols = torch.cat([pos_j, (mass_j * (G * c2 * compensate))[:, None]], dim=1)
    out = torch.empty((ni, 3), dtype=torch.float32, device=dev)
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nbody_allpairs_acc(pos_i.data_ptr(), ni, cols.data_ptr(), nj,
                                    out.data_ptr(), c2, eps2, stream)
        block_acc.launches += 1
    cuda_build.check(rc, "allpairs_acc_kernel")
    return out


def block_acc(
    pos_i: torch.Tensor,
    pos_j: torch.Tensor,
    mass_j: torch.Tensor,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    tile_i: int = DEFAULT_TILE_I,
    tile_j: int = DEFAULT_TILE_J,
) -> torch.Tensor:
    """acc (Ni, 3) of the row-block bodies due to every column-block body.

    ``pos_i`` and ``pos_j`` may be the same array (the all-pairs solve,
    :func:`allpairs_acc`) or different blocks, as the multi-device ring
    needs. Ni must divide by ``tile_i`` and Nj by ``tile_j``, the padding
    contract of the JAX package's kernel; the CUDA kernel itself takes any
    Ni and Nj.

    ``block_acc.launches`` counts the kernel's launches.
    """
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    if ni % tile_i or nj % tile_j:
        raise ValueError(
            f"block_acc: Ni={ni} must divide tile_i={tile_i} and "
            f"Nj={nj} tile_j={tile_j}; pad the state first"
        )
    kw = dict(eps2=eps2, compensate=compensate, G=G)
    if pos_i.device.type == "cuda":
        return _launch(pos_i, pos_j, mass_j, **kw)
    if pos_i.device.type == "cpu":
        return block_acc_plain(pos_i, pos_j, mass_j, **kw)
    raise ValueError(f"block_acc: no kernel for device {pos_i.device}")


block_acc.launches = 0


def allpairs_acc(pos: torch.Tensor, mass: torch.Tensor, **kw) -> torch.Tensor:
    """acc (N, 3) from pos (N, 3) and mass (N,) — all-pairs block solve."""
    return block_acc(pos, pos, mass, **kw)
