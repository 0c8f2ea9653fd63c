"""Symmetric half-pair force: the hand-written CUDA kernels and their plain twin.

Counterpart of ``n_body_problem_tpu.ops.pallas_symmetric``:
:func:`symmetric_acc` evaluates every unordered pair once and applies
Newton's third law (the reference's VERSION 3 method, ``kernel.cu:703-774``),
in each of the JAX package's three precisions. On a CUDA tensor it launches
``symmetric_acc_kernel`` (``csrc/symmetric.cu``) for ``"f32"`` and
``symmetric_bf16x3_kernel`` (``csrc/symmetric_bf16x3.cu``, through
:func:`symmetric_acc_bf16x3`) for ``"bf16x3"`` and ``"mixed"``; on a CPU
tensor it runs :func:`symmetric_acc_plain`, the same function in plain
PyTorch, which is also what the kernels are checked against on the card.

Coverage: bodies are cut into K tiles and row tile ``i`` meets column tile
``(i + s) mod K`` for ``s = 0 .. K // 2``. ``s = 0`` is the in-tile strict
upper triangle; for even K the last diagonal ``s = K/2`` pairs every tile
twice, so only rows ``i < K/2`` take it. Every unordered pair is evaluated
exactly once (``pallas_symmetric.py:13-18``).

The fast modes follow the TPU kernel's arithmetic (``pallas_symmetric.py:
163-194``): the action on row bodies is exact f32; the reaction on column
bodies is contracted against the row tile's panel ``[x - c, y - c, z - c,
1]``, centred on the row tile's mean position, and on the diagonals
``s > near_s`` that contraction runs as three bf16 products (hi*hi + hi*lo +
lo*hi) summed in f32. ``"bf16x3"`` has ``near_s = -1``, ``"mixed"``
``min(1, K // 2)``; with K <= 3 tiles ``"mixed"`` is the f32 mode.

The f32 kernel tiles by :data:`KERNEL_TILE` bodies whatever ``tile`` the
caller names (the f32 sum does not depend on the tiling beyond rounding):
a block takes one row tile on one diagonal, and :func:`symmetric_blocks`
and :func:`block_tiles` say which, in the kernel's integer arithmetic.

The output in a fixed order: no kernel adds with atomics. Each block
stores its sums into slots, (K, N, 3) scratch in which slot ``u`` of tile
``t`` holds the force on tile ``t``'s bodies from tile ``u``'s
(:func:`symmetric_slots`), and a second kernel adds each body's K slots in
slot order. So every launch gives the same bits, and the twins fill the same
slots and sum them in the same order (:func:`sum_slots`). The scratch is
:func:`slot_bytes`: 24 K N bytes, written once and read once.
"""

from __future__ import annotations

import torch

from n_body_problem_tpu_torch.ops import cuda_build

DEFAULT_TILE = 512
# Bodies a tile in csrc/symmetric.cu: 128 threads of four row bodies each.
# The wrapper pads N to it.
KERNEL_TILE = 512
PRECISIONS = ("f32", "bf16x3", "mixed")
# csrc/symmetric_bf16x3.cu: warps of 16-body row chunks that walk the column
# tile's 16-body strips; 16 bytes of shared memory a body of the tile for the
# column tile and 16 more for each warp's column sums.
FAST_TILE_MULTIPLE = 64
FAST_MAX_TILE = 2048
FAST_MAX_SHARED = 227 * 1024   # a block's shared memory on an H100
# (warps a block, column strips a step) the kernel is launched with, and the
# other shapes it takes.
FAST_SHAPE = (4, 2)
FAST_SHAPES = ((4, 1), (4, 2), (4, 4), (8, 1), (8, 2), (8, 4), (2, 2))
# Kernels a wrapper launches a call: the pair kernel and the slots' sum.
LAUNCHES_A_CALL = 2


def near_diagonals(k: int, precision: str) -> int:
    """``near_s``: the last diagonal whose reaction is exact f32
    (``pallas_symmetric.py:271``)."""
    s_max = k // 2
    return {"f32": s_max, "bf16x3": -1, "mixed": min(1, s_max)}[precision]


def tile_centers(pos: torch.Tensor, tile: int) -> torch.Tensor:
    """(K, 3): each tile's mean position, padding bodies included
    (``pallas_symmetric.py:284``)."""
    return pos.reshape(-1, tile, 3).mean(dim=1)


def split_bf16(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """hi/lo bf16 split (``_split_bf16``), returned in ``a``'s dtype:
    hi = bf16(a) and lo = bf16(a - hi), both rounded to nearest even.
    Products of two such values are exact in float32, as under JAX's
    ``preferred_element_type=f32``."""
    hi = a.to(torch.bfloat16).to(a.dtype)
    return hi, (a - hi).to(torch.bfloat16).to(a.dtype)


def _put_slots(slots, i, j, s, action, reaction) -> None:
    """Block (i, s)'s stores: the action into slot ``j`` of tile ``i``, the
    reaction into slot ``i`` of tile ``j``; on ``s = 0`` one slot, action +
    reaction (:func:`symmetric_slots`)."""
    if s == 0:
        slots[i, i] = action + reaction
    else:
        slots[i, j] = action
        slots[j, i] = reaction


def sum_slots(slots: torch.Tensor) -> torch.Tensor:
    """(K * T, 3): each body's K slots (``slots`` is (K, K, T, 3), slot ``u``
    of tile ``t`` at ``[t, u]``) added in slot order, as
    ``symmetric_sum_kernel`` adds them."""
    acc = slots[:, 0].clone()
    for u in range(1, slots.shape[1]):
        acc += slots[:, u]
    return acc.reshape(-1, 3)


def _panel_acc_plain(pos, mass, *, eps2, compensate, G, tile, precision):
    """The fast modes' arithmetic, one diagonal at a time, batched over row
    tiles: exact action, panel reaction (bf16x3 on ``s > near_s``), into the
    kernel's slots."""
    n = pos.shape[0]
    k = n // tile
    c2 = compensate * compensate
    p = pos.reshape(k, tile, 3)
    m = (mass * (G * c2 * compensate)).reshape(k, tile)
    centers = tile_centers(pos, tile)
    rows1 = torch.cat([p - centers[:, None, :], torch.ones_like(p[..., :1])], dim=-1)
    rows1_t = rows1.transpose(1, 2)                        # (K, 4, T)
    rows1_hi, rows1_lo = split_bf16(rows1_t)
    near_s = near_diagonals(k, precision)
    slots = pos.new_empty((k, k, tile, 3))
    s_max = k // 2
    rid = torch.arange(tile, device=pos.device)
    upper = (rid[None, :] > rid[:, None]).to(pos.dtype)   # (row, col) strict upper
    for s in range(s_max + 1):
        rows = k // 2 if (k % 2 == 0 and s == s_max) else k
        i = torch.arange(rows, device=pos.device)
        j = (i + s) % k
        d = p[j][:, None, :, :] - p[i][:, :, None, :]     # (A, row, col, 3)
        # The kernel's order of operations, so both round alike.
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        inv = torch.rsqrt(r2 * c2 + eps2)
        u = inv * inv * inv
        if s == 0:
            u = u * upper
        action = torch.sum((m[j][:, None, :] * u)[..., None] * d, dim=2)
        b_w = m[i][:, :, None] * u                        # (A, row, col)
        if s > near_s:
            b_hi, b_lo = split_bf16(b_w)
            r_hi, r_lo = rows1_hi[i], rows1_lo[i]
            s_col = r_hi @ b_hi + r_hi @ b_lo + r_lo @ b_hi   # (A, 4, col)
        else:
            s_col = rows1_t[i] @ b_w
        s_col = s_col.transpose(1, 2)                     # (A, col, 4)
        reaction = s_col[..., :3] - (p[j] - centers[i][:, None, :]) * s_col[..., 3:]
        _put_slots(slots, i, j, s, action, reaction)
    return sum_slots(slots)


def symmetric_acc_plain(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    tile: int = DEFAULT_TILE,
    precision: str = "f32",
) -> torch.Tensor:
    """acc (N, 3) from N (N - 1) / 2 pair evaluations in the staggered
    coverage, one diagonal ``s`` at a time, batched over row tiles, stored
    into the kernels' slots and summed in slot order.

    ``"f32"`` sums the reaction directly (``-sum m_i' u d``), as
    ``csrc/symmetric.cu`` does; ``"bf16x3"`` and ``"mixed"`` follow the TPU
    kernel's panel form (:func:`_panel_acc_plain`)."""
    if precision != "f32":
        return _panel_acc_plain(pos, mass, eps2=eps2, compensate=compensate, G=G,
                                tile=tile, precision=precision)
    n = pos.shape[0]
    k = n // tile
    c2 = compensate * compensate
    p = pos.reshape(k, tile, 3)
    m = (mass * (G * c2 * compensate)).reshape(k, tile)
    slots = pos.new_empty((k, k, tile, 3))
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
        _put_slots(slots, i, j, s, action, reaction)
    return sum_slots(slots)


def symmetric_blocks(k: int) -> int:
    """Blocks of the f32 kernel's grid when N is ``k`` tiles: one for each
    row tile on each of the ``k // 2 + 1`` diagonals."""
    if k <= 0:
        raise ValueError(f"symmetric_blocks: k={k} must be positive")
    return k * (k // 2 + 1)


def block_tiles(k: int, b: int) -> tuple[int, int, int] | None:
    """``(i, s, j)``: the row tile, the diagonal and the column tile
    ``j = (i + s) mod k`` of block ``b``; the kernel's integer arithmetic.
    ``s = 0`` is the tile's strict upper triangle. For even ``k`` only the
    rows ``i < k / 2`` take the last diagonal: the other blocks of that
    diagonal do nothing (``None``)."""
    i, s = b % k, b // k
    if k % 2 == 0 and s == k // 2 and i >= s:
        return None
    return i, s, (i + s) % k


def symmetric_slots(k: int, b: int) -> tuple[tuple[int, int], tuple[int, int]] | None:
    """``((i, j), (j, i))``: the (tile, slot) block ``b`` stores its action
    into and the (tile, slot) it stores its reaction into, when N is ``k``
    tiles; the kernels' integer arithmetic. Slot ``u`` of tile ``t`` holds
    the force on tile ``t``'s bodies from tile ``u``'s, so each of the K^2
    slots has exactly one writer; on ``s = 0`` (``i == j``) the block stores
    action + reaction into the one slot. ``None`` for a block that does
    nothing (:func:`block_tiles`): it leaves no slot empty."""
    tiles = block_tiles(k, b)
    if tiles is None:
        return None
    i, _, j = tiles
    return (i, j), (j, i)


def slot_bytes(n: int, tile: int) -> int:
    """Bytes of a call's slots: (N / tile, N, 3) float32 (N as the kernel
    sees it, padded to its tile)."""
    return (n // tile) * n * 12


def _bodies(pos, mass, *, compensate, G) -> torch.Tensor:
    """(N, 4) rows (x, y, z, G c^3 m), what both kernels read."""
    c2 = compensate * compensate
    return torch.cat([pos, (mass * (G * c2 * compensate))[:, None]], dim=1)


def kernel_bodies(pos, mass, *, compensate, G) -> torch.Tensor:
    """(N_pad, 4) rows the f32 kernel reads: :func:`_bodies` with N padded
    to :data:`KERNEL_TILE` by zero-mass bodies at the origin, which add
    exactly zero to every real body's force."""
    body = _bodies(pos, mass, compensate=compensate, G=G)
    pad = -body.shape[0] % KERNEL_TILE
    return torch.cat([body, body.new_zeros((pad, 4))]) if pad else body


def _launch(pos, mass, *, eps2, compensate, G) -> torch.Tensor:
    dev = pos.device
    n = pos.shape[0]
    cuda_build.require_f32("pos", pos, (n, 3), dev)
    cuda_build.require_f32("mass", mass, (n,), dev)
    cuda_build.require_normal_eps2("symmetric_acc", eps2)
    if n == 0:
        return pos.new_zeros((0, 3))
    body = kernel_bodies(pos, mass, compensate=compensate, G=G)
    n_pad = body.shape[0]
    if n_pad > cuda_build.MAX_BODIES:
        raise ValueError(f"symmetric_acc: at most {cuda_build.MAX_BODIES} bodies")
    slots = torch.empty((n_pad // KERNEL_TILE, n_pad, 3), dtype=torch.float32, device=dev)
    out = torch.empty((n_pad, 3), dtype=torch.float32, device=dev)
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nbody_symmetric_acc(body.data_ptr(), n_pad, slots.data_ptr(), out.data_ptr(),
                                     compensate * compensate, eps2, stream)
        symmetric_acc.launches += LAUNCHES_A_CALL
    cuda_build.check(rc, "symmetric_acc_kernel")
    return out[:n]


def _launch_bf16x3(pos, mass, *, eps2, compensate, G, tile, precision) -> torch.Tensor:
    dev = pos.device
    n = pos.shape[0]
    cuda_build.require_f32("pos", pos, (n, 3), dev)
    cuda_build.require_f32("mass", mass, (n,), dev)
    if tile % FAST_TILE_MULTIPLE or not 0 < tile <= FAST_MAX_TILE:
        raise ValueError(
            f"symmetric_acc_bf16x3: tile={tile} must be a multiple of "
            f"{FAST_TILE_MULTIPLE} up to {FAST_MAX_TILE} on the card")
    if n > cuda_build.MAX_BODIES:
        raise ValueError(f"symmetric_acc_bf16x3: at most {cuda_build.MAX_BODIES} bodies")
    cuda_build.require_normal_eps2("symmetric_acc_bf16x3", eps2)
    k = n // tile
    warps, step = FAST_SHAPE
    body = _bodies(pos, mass, compensate=compensate, G=G)
    centers = torch.cat([tile_centers(pos, tile), pos.new_zeros((k, 1))], dim=1)
    slots = torch.empty((k, n, 3), dtype=torch.float32, device=dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nbody_symmetric_bf16x3(body.data_ptr(), n, tile, centers.data_ptr(),
                                        near_diagonals(k, precision), warps, step,
                                        slots.data_ptr(), out.data_ptr(),
                                        compensate * compensate, eps2, stream)
        symmetric_acc_bf16x3.launches += LAUNCHES_A_CALL
    cuda_build.check(rc, "symmetric_bf16x3_kernel")
    return out


def _check_args(name: str, n: int, tile: int, precision: str, allowed) -> None:
    if n % tile:
        raise ValueError(f"{name}: N={n} must be a multiple of tile={tile}")
    if precision not in allowed:
        raise ValueError(f"unknown precision {precision!r}")


def symmetric_acc_bf16x3(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
    tile: int = DEFAULT_TILE,
    precision: str = "bf16x3",
) -> torch.Tensor:
    """acc (N, 3) in the ``"bf16x3"`` or ``"mixed"`` mode: on a CUDA tensor
    ``symmetric_bf16x3_kernel``, whose reaction runs on the tensor cores
    (``tile`` a multiple of 64 up to 2,048, ``eps2`` a normal float32); on a
    CPU tensor the plain twin.

    ``symmetric_acc_bf16x3.launches`` counts the kernel's launches and the
    slots' sum's (:data:`LAUNCHES_A_CALL` a call).
    """
    _check_args("symmetric_acc_bf16x3", pos.shape[0], tile, precision, PRECISIONS[1:])
    kw = dict(eps2=eps2, compensate=compensate, G=G, tile=tile, precision=precision)
    if pos.device.type == "cuda":
        return _launch_bf16x3(pos, mass, **kw)
    if pos.device.type == "cpu":
        return symmetric_acc_plain(pos, mass, **kw)
    raise ValueError(f"symmetric_acc_bf16x3: no kernel for device {pos.device}")


symmetric_acc_bf16x3.launches = 0


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
    JAX package). ``"f32"`` on the card runs the f32 kernel, which tiles by
    :data:`KERNEL_TILE` and pads to it; the fast modes go to
    :func:`symmetric_acc_bf16x3`.

    ``symmetric_acc.launches`` counts the f32 kernel's launches and the
    slots' sum's (:data:`LAUNCHES_A_CALL` a call).
    """
    _check_args("symmetric_acc", pos.shape[0], tile, precision, PRECISIONS)
    kw = dict(eps2=eps2, compensate=compensate, G=G)
    if precision != "f32":
        return symmetric_acc_bf16x3(pos, mass, tile=tile, precision=precision, **kw)
    if pos.device.type == "cuda":
        return _launch(pos, mass, **kw)
    if pos.device.type == "cpu":
        return symmetric_acc_plain(pos, mass, tile=tile, **kw)
    raise ValueError(f"symmetric_acc: no kernel for device {pos.device}")


symmetric_acc.launches = 0

# The wrappers whose ``.launches`` a captured CUDA graph adds to on every
# replay (``graphs.Program``).
COUNTED = (symmetric_acc, symmetric_acc_bf16x3)
