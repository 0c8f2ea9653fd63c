"""Symmetric half-pair force: the hand-written CUDA kernel and its plain twin.

Counterpart of ``n_body_problem_tpu.ops.pallas_symmetric``:
:func:`symmetric_acc` evaluates every unordered pair once and applies
Newton's third law (the reference's VERSION 3 method, ``kernel.cu:703-774``).
On a CUDA tensor it launches ``symmetric_acc_kernel``
(``csrc/symmetric.cu``); on a CPU tensor it runs
:func:`symmetric_acc_plain`, the same coverage in plain PyTorch, which is
also what the kernel is checked against on the card.

Coverage (both versions): bodies are cut into K tiles and row tile ``i``
meets column tile ``(i + s) mod K`` for ``s = 0 .. K // 2``. ``s = 0`` is
the in-tile strict upper triangle; for even K the last diagonal ``s = K/2``
pairs every tile twice, so only rows ``i < K/2`` take it. Every unordered
pair is evaluated exactly once (``pallas_symmetric.py:13-18``).

Only the ``"f32"`` precision is ported. The TPU's ``"bf16x3"`` and
``"mixed"`` modes are MXU fast-math and wait on the ROADMAP.

The kernel adds reactions with atomics, so the order of its sums, and its
last bits, change from run to run: compare it by tolerance, never bitwise.
"""

from __future__ import annotations

import torch

from n_body_problem_tpu_torch.ops import cuda_build

DEFAULT_TILE = 512
KERNEL_TILE = 128   # bodies per tile in csrc/symmetric.cu; divides DEFAULT_TILE
PRECISIONS = ("f32", "bf16x3", "mixed")


def symmetric_acc_plain(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    tile: int = DEFAULT_TILE,
) -> torch.Tensor:
    """acc (N, 3) from N (N - 1) / 2 pair evaluations in the staggered
    coverage, one diagonal ``s`` at a time, batched over row tiles."""
    n = pos.shape[0]
    k = n // tile
    c2 = compensate * compensate
    p = pos.reshape(k, tile, 3)
    m = (mass * (G * c2 * compensate)).reshape(k, tile)
    acc = torch.zeros((k, tile, 3), dtype=pos.dtype, device=pos.device)
    even_k = k % 2 == 0
    s_max = k // 2
    rid = torch.arange(tile, device=pos.device)
    upper = (rid[None, :] > rid[:, None]).to(pos.dtype)   # (row, col) strict upper
    for s in range(s_max + 1):
        rows = k // 2 if (even_k and s == s_max) else k
        i = torch.arange(rows, device=pos.device)
        j = (i + s) % k
        d = p[j][:, None, :, :] - p[i][:, :, None, :]     # (A, row, col, 3)
        r2 = torch.sum(d * d, dim=-1)
        inv = torch.rsqrt(r2 * c2 + eps2)
        u = inv * inv * inv
        if s == 0:
            u = u * upper
        action = torch.sum((m[j][:, None, :] * u)[..., None] * d, dim=2)
        reaction = -torch.sum((m[i][:, :, None] * u)[..., None] * d, dim=1)
        acc.index_add_(0, i, action)
        acc.index_add_(0, j, reaction)
    return acc.reshape(n, 3)


def _launch(pos, mass, *, eps2, compensate, G) -> torch.Tensor:
    dev = pos.device
    n = pos.shape[0]
    cuda_build.require_f32("pos", pos, (n, 3), dev)
    cuda_build.require_f32("mass", mass, (n,), dev)
    if n % KERNEL_TILE:
        raise ValueError(
            f"symmetric_acc: N={n} must be a multiple of the CUDA kernel's "
            f"tile {KERNEL_TILE} (use a pallas_sym_tile that is a multiple of it)")
    if n > cuda_build.MAX_BODIES:
        raise ValueError(f"symmetric_acc: at most {cuda_build.MAX_BODIES} bodies")
    c2 = compensate * compensate
    body = torch.cat([pos, (mass * (G * c2 * compensate))[:, None]], dim=1)
    out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nbody_symmetric_acc(body.data_ptr(), n, out.data_ptr(),
                                     c2, eps2, stream)
        symmetric_acc.launches += 1
    cuda_build.check(rc, "symmetric_acc_kernel")
    return out


def symmetric_acc(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    tile: int = DEFAULT_TILE,
    precision: str = "f32",
) -> torch.Tensor:
    """acc (N, 3): every unordered pair evaluated once (Newton's 3rd law).

    N must be a multiple of ``tile`` (the padding contract shared with the
    JAX package). The CPU version tiles by ``tile``; the CUDA kernel tiles
    by :data:`KERNEL_TILE`, so on the card N must also divide by that.

    ``symmetric_acc.launches`` counts the kernel's launches.
    """
    n = pos.shape[0]
    if n % tile:
        raise ValueError(f"symmetric_acc: N={n} must be a multiple of tile={tile}")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if precision != "f32":
        raise NotImplementedError(
            f"symmetric_acc precision {precision!r} is not ported yet "
            "(ROADMAP §2: bf16x3/mixed modes of the symmetric kernel)")
    kw = dict(eps2=eps2, compensate=compensate, G=G)
    if pos.device.type == "cuda":
        return _launch(pos, mass, **kw)
    if pos.device.type == "cpu":
        return symmetric_acc_plain(pos, mass, tile=tile, **kw)
    raise ValueError(f"symmetric_acc: no kernel for device {pos.device}")


symmetric_acc.launches = 0
