"""Softened pairwise gravity — plain PyTorch solver backends.

Counterpart of ``n_body_problem_tpu.ops.forces``. All solvers compute the
reference's pair function (``cal_single_acclerate_without_mass_new``,
``kernel.cu:665-692``):

    d      = c * (p_j - p_i)                 # compensate pre-scale, c = 0.1
    r2     = |d|^2 + eps2                    # EPSILON = 1e-6 (kernel.cu:66)
    acc_i += sum_j  m_j * d * rsqrt(r2)^3 * c^2

evaluated as ``w_ij = G m_j c^3 rsqrt(c^2 |p_j - p_i|^2 + eps2)^3``,
``acc_i = sum_j w_ij (p_j - p_i)``: subtract first, scale the squared
distance after. Self-pairs contribute exactly zero and zero-mass padding
bodies contribute nothing, so no solver masks the diagonal.

- :func:`direct_acc`  — one-shot broadcast, the ground-truth oracle.
- :func:`blocked_acc` — the same broadcast over row blocks, O(B*N) memory.
- :func:`mxu_acc`     — the matmul formulation: ``acc_i = S_i[:3] - p_i S_i[3]``
  with ``S = W @ [P, 1]``. The package never enables TF32, so the product
  runs in full float32 (the JAX package pins ``Precision.HIGHEST`` for the
  same reason: the two S terms cancel).
"""

from __future__ import annotations

import math

import torch

from n_body_problem_tpu_torch.utils.padding import round_up

__all__ = ["direct_acc", "blocked_acc", "mxu_acc", "pair_accel_tile",
           "pair_accel_tile_symmetric", "required_padding"]


def _coef(mass_j: torch.Tensor, r2: torch.Tensor, eps2: float, c2: float,
          Gc3: float) -> torch.Tensor:
    """Per-pair scalar weight w_ij = G * m_j * c^3 * rsqrt(c^2 r2 + eps2)^3."""
    inv = torch.rsqrt(c2 * r2 + eps2)
    return (Gc3 * mass_j) * (inv * inv * inv)


def pair_accel_tile(
    pos_i: torch.Tensor,   # (I, 3)
    pos_j: torch.Tensor,   # (J, 3)
    mass_j: torch.Tensor,  # (J,)
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
) -> torch.Tensor:
    """Acceleration of each body in tile I due to every body in tile J."""
    c2 = compensate * compensate
    Gc3 = G * c2 * compensate
    d = pos_j[None, :, :] - pos_i[:, None, :]          # (I, J, 3)
    r2 = torch.sum(d * d, dim=-1)                      # (I, J)
    w = _coef(mass_j[None, :], r2, eps2, c2, Gc3)      # (I, J)
    return torch.sum(w[:, :, None] * d, dim=1)


def pair_accel_tile_symmetric(
    pos_i: torch.Tensor,   # (I, 3)
    mass_i: torch.Tensor,  # (I,)
    pos_j: torch.Tensor,   # (J, 3)
    mass_j: torch.Tensor,  # (J,)
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Both halves of a block-pair interaction from one pair evaluation:
    ``(acc_i, acc_j)``, the action of tile J on tile I and the reaction of
    tile I on tile J (``kernel.cu:748-761``)."""
    c2 = compensate * compensate
    Gc3 = G * c2 * compensate
    d = pos_j[None, :, :] - pos_i[:, None, :]          # (I, J, 3)
    r2 = torch.sum(d * d, dim=-1)
    inv = torch.rsqrt(c2 * r2 + eps2)
    u = Gc3 * (inv * inv * inv)                        # (I, J) mass-free
    acc_i = torch.sum((u * mass_j[None, :])[:, :, None] * d, dim=1)
    acc_j = -torch.sum((u * mass_i[:, None])[:, :, None] * d, dim=0)
    return acc_i, acc_j


def direct_acc(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
) -> torch.Tensor:
    """One-shot O(N^2) broadcast direct sum (the validation oracle)."""
    return pair_accel_tile(pos, pos, mass, eps2=eps2, compensate=compensate, G=G)


def _check_blocks(name: str, n: int, block_size: int) -> None:
    if n % block_size:
        raise ValueError(
            f"{name}: N={n} not a multiple of block_size={block_size}; pad the state"
        )


def blocked_acc(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    block_size: int = 256,
) -> torch.Tensor:
    """Row-blocked direct sum: each chunk of ``block_size`` row bodies
    sweeps the full body list (the reference's VERSION 1 tiling,
    ``kernel.cu:828-884``). N must be a multiple of ``block_size``."""
    n = pos.shape[0]
    _check_blocks("blocked_acc", n, block_size)
    return torch.cat([
        pair_accel_tile(pos[r:r + block_size], pos, mass, eps2=eps2,
                        compensate=compensate, G=G)
        for r in range(0, n, block_size)
    ])


def mxu_acc(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    block_size: int = 1024,
) -> torch.Tensor:
    """Matmul-assisted direct sum over row blocks.

    Per row block: ``dx, dy, dz`` and ``r2`` by broadcasting (no Gram-matrix
    cancellation), the weights ``w_ij``, then ``S = W @ [P, 1]`` and
    ``acc_i = S_i[:3] - p_i S_i[3]``. Self and coincident pairs are zeroed,
    because their huge ``w`` would cancel only analytically between the two
    S terms.
    """
    n = pos.shape[0]
    _check_blocks("mxu_acc", n, block_size)
    c2 = compensate * compensate
    Gc3 = G * c2 * compensate
    p_ext = torch.cat([pos, pos.new_ones((n, 1))], dim=-1)   # (N, 4)
    idx = torch.arange(n, device=pos.device)
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    out = []
    for r in range(0, n, block_size):
        pos_i = pos[r:r + block_size]
        dx = x[None, :] - pos_i[:, 0:1]                       # (B, N)
        dy = y[None, :] - pos_i[:, 1:2]
        dz = z[None, :] - pos_i[:, 2:3]
        r2 = dx * dx + dy * dy + dz * dz
        w = _coef(mass[None, :], r2, eps2, c2, Gc3)
        same = (idx[r:r + block_size, None] == idx[None, :]) | (r2 == 0.0)
        w = torch.where(same, torch.zeros_like(w), w)
        s = w @ p_ext                                         # (B, 4)
        out.append(s[:, :3] - pos_i * s[:, 3:4])
    return torch.cat(out)


def required_padding(
    solver: str,
    n: int,
    block_size: int,
    tile_i: int = 256,
    tile_j: int = 1024,
    sym_tile: int = 512,
    tree_tile: int = 32,
    tree_src_tile: int = 64,
) -> int:
    """Padded body count a solver needs for N bodies.

    Identical to the JAX package's rule, so both packages run the same N
    and their states compare body for body.
    """
    if solver in ("blocked", "mxu"):
        return round_up(n, block_size)
    if solver in ("pallas", "auto"):
        return round_up(n, math.lcm(tile_i, tile_j))
    if solver == "pallas_symmetric":
        return round_up(n, sym_tile)
    if solver == "treecode":
        return round_up(n, math.lcm(tree_tile, tree_src_tile, 256))
    return n
