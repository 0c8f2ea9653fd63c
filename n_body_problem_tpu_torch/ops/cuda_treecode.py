"""Treecode kernels: near fields, far fields, panel gather, VIP sweep.

Each function here has two forms. On a CUDA tensor the wrapper launches a
hand-written kernel (``csrc/near.cu``, ``csrc/far_hier.cu``,
``csrc/far_single.cu``, ``csrc/gather.cu``, ``csrc/near_panel.cu``,
``csrc/vip.cu``); on a CPU tensor it runs the ``*_plain`` function beside
it, the same computation in plain PyTorch, which is also what the kernel is
checked against on the card. A failed build or launch raises. Each wrapper
counts its launches in ``.launches``.

Layouts (the GPU's, not the TPU's lane-padded ones):

- ``bodies`` (N + S, 4) float32 rows [x y z m'], with m' = G c^3 m_tree
  (VIP bodies massless) and a zero sentinel tile of S = ``src_tile`` rows
  last. The near kernel reads source tile j as rows [j S, (j+1) S); the
  other kernels read target row t as the xyz of rows [t T, (t+1) T),
  T = ``tile``.
- ``flat_src`` (flat_cap,) / ``chunk_tgt`` (flat_cap / E,) int32: near
  chunk p holds source tiles ``flat_src[p E:(p+1) E]`` for target row
  ``chunk_tgt[p]``; ``chunk_tgt`` is non-decreasing, sentinel K_t last.
- ``summ`` (K_total + 1, 12) float32 node rows
  [cx cy cz m qxx qyy qzz qxy qxz qyz tr 0], zero sentinel row last;
  ``far_src`` / ``far_tgt`` as the near lists with ``FAR_ENTRIES`` nodes a
  chunk. The single-level far field takes the level-0 rows and a
  (K_t, K_s) bool or uint8 ``near_mask`` instead of lists.
- ``near_idx`` (K, M) int32 and ``panels`` (K, M T, 4) float32: the dense
  path's near lists and the body rows they gather, tile by tile.
- ``rows`` (N, 4) and ``panel`` (W, 4) float32 [x y z G c^3 m] for the VIP
  sweep.
"""

from __future__ import annotations

import math

import torch

from n_body_problem_tpu_torch.ops import cuda_build

FAR_ENTRIES = 64        # far-list node entries per chunk (csrc/far_hier.cu)
# The far kernel's compiled limits (kSlots, kMaxThreads in csrc/far_hier.cu),
# not settings: far_split keeps within them and the launch check enforces
# them. A thread stages at most FAR_SLOTS node quads a stage; a block has at
# most FAR_MAX_THREADS threads.
FAR_SLOTS = 2
FAR_MAX_THREADS = 512
NEAR_CHUNK_BODIES = 2048  # most source bodies a near chunk holds (csrc/near.cu)
# The near kernel's block: at most NEAR_TARGETS bodies of a target row times
# as many parts as bring it to NEAR_BLOCK threads; it stages about
# NEAR_PIECE_BODIES source bodies at a time, twice (near_split). The largest
# block and a whole chunk a stage were the fastest on an NVIDIA H100 80GB
# HBM3 at 700.00 W: at 65,536 bodies and whole 128-body rows 1.48 / 0.98 /
# 0.87 ms for blocks of 128 / 256 / 512 threads and stages of 512 bodies,
# 0.81 ms for 512 threads and 2,048 bodies, 0.77 for 1,024 and 2,048. Rows
# cut into blocks of 64 targets balance better where rows are few: 0.69 ms
# there and 0.121 against 0.139 on the tuned 20,480 lists. At 524,288, where
# rows are many and each chunk is then staged twice, they gain nothing: 6.18
# ms either way, 6.05 at blocks of 128 targets (``kernel_compare --sweep``).
NEAR_BLOCK = 1024
NEAR_PIECE_BODIES = 2048
NEAR_TARGETS = 64
# The far kernel's block: at most FAR_TARGETS bodies of a target row, two a
# thread, times FAR_PARTS parts (or as many as it takes to stage a chunk);
# it stages FAR_STAGE_CHUNKS chunks at a time (far_split).
FAR_TARGETS = 128
FAR_PARTS = 4
FAR_STAGE_CHUNKS = 2
# The VIP sweep's block: 128 threads of four row bodies; its grid is cut
# along the panel too, into pieces of whole 32-VIP sub-panels of at most
# VIP_MAX_PIECE VIPs, and further until it has about VIP_BLOCKS blocks
# (vip_split).
VIP_ROWS = 512
VIP_BLOCKS = 2048
VIP_MAX_PIECE = 512
# The single-level far kernel's block: one target row, two targets a thread,
# times as many parts as bring it to about SINGLE_THREADS threads; each
# thread reads SINGLE_ENTRIES mask entries a stage (single_split). Its
# compiled limits (csrc/far_single.cu): at most SINGLE_MAX_THREADS threads
# and SINGLE_MAX_ENTRIES entries a thread. On an NVIDIA H100 80GB HBM3 at
# 700.00 W, at 65,536 flat bodies: 0.097 ms at 256 threads and two
# entries, 0.100 at 128, 0.104 at 512, 0.103 at one entry a thread
# (kernel_compare --sweep).
SINGLE_THREADS = 256
SINGLE_ENTRIES = 2
SINGLE_MAX_THREADS = 512
SINGLE_MAX_ENTRIES = 2
# The near-panel kernel's block: one target tile, PANEL_ROWS targets a
# thread, times as many parts as bring it to about PANEL_THREADS threads; it
# stages PANEL_STAGE panel rows at a time, twice (panel_split). PANEL_ROWS
# and PANEL_MAX_THREADS are compiled into csrc/near_panel.cu. On an NVIDIA
# H100 80GB HBM3 at 700.00 W 512 threads took 0.0056 ms at 1,024 dense
# bodies against 0.0065 for 256, and the same 0.189-0.191 ms at 20,480; 128
# threads 0.20, stages of 512 rows 0.20 (kernel_compare --sweep).
PANEL_ROWS = 4
PANEL_MAX_THREADS = 512
PANEL_THREADS = 512
PANEL_STAGE = 1024
# Largest pair block a plain version materialises at once.
_PLAIN_PAIRS = 1 << 22


def _live_chunks(tgt: torch.Tensor, k_t: int) -> int:
    """Chunks before the sentinel tail (the tags are non-decreasing)."""
    return int((tgt < k_t).sum())


def _check_block(tile: int) -> None:
    if tile % 32 or not 32 <= tile <= 1024:
        raise ValueError(f"tile={tile}: the kernels run one thread a body (the near "
                         "kernel several), so the target row must be a multiple of "
                         "32 up to 1024")


def _require_i32(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.int32 or t.dim() != 1 \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D int32 tensor on {device}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# -------------------------------------------------------------- near field
def near_field_plain(bodies, flat_src, chunk_tgt, *, n: int, tile: int,
                     src_tile: int, entries: int, eps2: float,
                     c2: float) -> torch.Tensor:
    """Exact near field (N, 3): for each live chunk, the target row's bodies
    against every body of the chunk's source tiles, summed into the row."""
    k_t, k_s = n // tile, n // src_tile
    live = _live_chunks(chunk_tgt, k_t)
    src = flat_src[:live * entries].long().reshape(live, entries)
    tgt = chunk_tgt[:live].long()
    tiles = bodies.reshape(k_s + 1, src_tile, 4)
    targets = bodies[:n, :3].reshape(k_t, tile, 3)
    acc = bodies.new_zeros((k_t, tile, 3))
    batch = max(1, _PLAIN_PAIRS // (tile * entries * src_tile))
    for b in range(0, live, batch):
        s = tiles[src[b:b + batch]].reshape(-1, entries * src_tile, 4)
        p = targets[tgt[b:b + batch]]
        d = s[:, None, :, :3] - p[:, :, None, :]                 # (B, T, L, 3)
        r2 = (d * d).sum(-1)
        inv = torch.rsqrt(r2 * c2 + eps2)
        w = s[:, None, :, 3] * (inv * inv * inv)
        acc.index_add_(0, tgt[b:b + batch], (w[..., None] * d).sum(2))
    return acc.reshape(n, 3)


def near_split(tile: int, entries: int, src_tile: int | None = None) -> tuple[int, int, int]:
    """``(sub, parts, piece)`` of the near kernel's block for target rows of
    ``tile`` bodies and chunks of ``entries`` source tiles of ``src_tile``
    bodies (a full chunk's when not given).

    A block takes ``sub`` consecutive targets of one row (the largest
    multiple of 32 that divides ``tile``, up to :data:`NEAR_TARGETS`, or up
    to what fills the block where the entries are too few to) and is
    ``sub * parts`` threads. A row's source entries, chunk after chunk, are
    staged ``piece`` at a time; part ``p`` sums the entries ``p, p + parts,
    ...`` of each piece for all ``sub`` targets. ``piece`` is a multiple of
    ``parts`` and at most ``entries`` (a piece never exceeds a chunk's
    bodies), about :data:`NEAR_PIECE_BODIES` bodies."""
    if src_tile is None:
        src_tile = NEAR_CHUNK_BODIES // entries
    most = max(32, NEAR_TARGETS, NEAR_BLOCK // entries)
    sub = max(s for s in range(32, most + 1, 32) if tile % s == 0)
    parts = max(1, min(NEAR_BLOCK // sub, entries))
    piece = parts * max(1, min(NEAR_PIECE_BODIES // (src_tile * parts), entries // parts))
    return sub, parts, piece


def near_parts(n_entries: int, parts: int, piece: int) -> list[list[int]]:
    """The near kernel's split of a row's ``n_entries`` source entries (its
    chunks' entries in order): for each part, the entries it sums, in its
    order. Every entry lies in exactly one part. The near-panel kernel
    splits a panel's rows the same way, ``piece`` rows a stage
    (:func:`panel_split`)."""
    out: list[list[int]] = [[] for _ in range(parts)]
    for e0 in range(0, n_entries, piece):
        for p in range(parts):
            out[p].extend(range(e0 + p, min(e0 + piece, n_entries), parts))
    return out


def near_field(bodies, flat_src, chunk_tgt, *, n: int, tile: int,
               src_tile: int, entries: int, eps2: float,
               c2: float) -> torch.Tensor:
    """Exact near field (N, 3) over the compacted near lists.

    ``near_field.launches`` counts the kernel's launches.
    """
    kw = dict(n=n, tile=tile, src_tile=src_tile, entries=entries, eps2=eps2, c2=c2)
    if bodies.device.type == "cpu":
        return near_field_plain(bodies, flat_src, chunk_tgt, **kw)
    if bodies.device.type != "cuda":
        raise ValueError(f"near_field: no kernel for device {bodies.device}")
    dev = bodies.device
    _check_block(tile)
    if entries * src_tile > NEAR_CHUNK_BODIES:
        raise ValueError(f"near_field: a chunk of {entries} x {src_tile} bodies "
                         f"exceeds {NEAR_CHUNK_BODIES}")
    cuda_build.require_f32("bodies", bodies, (n + src_tile, 4), dev)
    cuda_build.require_normal_eps2("near_field", eps2)
    _require_i32("flat_src", flat_src, dev)
    _require_i32("chunk_tgt", chunk_tgt, dev)
    n_chunks = chunk_tgt.shape[0]
    if flat_src.shape[0] < n_chunks * entries:
        raise ValueError("near_field: flat_src shorter than its chunks")
    if n > cuda_build.MAX_BODIES or n % tile or n % src_tile:
        raise ValueError(f"near_field: N={n} must divide tile and src_tile")
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    sub, parts, piece = near_split(tile, entries, src_tile)
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        rc = lib.nbody_near_field(bodies.data_ptr(), n, tile, sub, src_tile, entries,
                                  parts, piece, flat_src.data_ptr(), chunk_tgt.data_ptr(),
                                  n_chunks, out.data_ptr(), c2, eps2, _stream(dev))
        near_field.launches += 1
    cuda_build.check(rc, "near_field_kernel")
    return out


near_field.launches = 0


# --------------------------------------------------------------- far field
def _far_terms(s, px, py, pz, *, eps2: float, c2: float, G: float):
    """Per (body, node) softened monopole + quadrupole pull, components
    (x, y, z), of summary rows ``s`` (..., 12) on bodies ``p*`` that
    broadcast against them."""
    dx = s[..., 0] - px
    dy = s[..., 1] - py
    dz = s[..., 2] - pz
    r2 = dx * dx + dy * dy + dz * dz
    u2 = 1.0 / (c2 * r2 + eps2)
    u = torch.sqrt(u2)
    u3 = u2 * u
    u5 = u3 * u2
    u7 = u5 * u2
    sdx = s[..., 4] * dx + s[..., 7] * dy + s[..., 8] * dz
    sdy = s[..., 7] * dx + s[..., 5] * dy + s[..., 9] * dz
    sdz = s[..., 8] * dx + s[..., 9] * dy + s[..., 6] * dz
    q = dx * sdx + dy * sdy + dz * sdz
    c4 = c2 * c2
    c6 = c4 * c2
    gc = G * math.sqrt(c2)
    wd = (s[..., 3] * c2 * u3 - 1.5 * c4 * s[..., 10] * u5
          + 7.5 * c6 * q * u7) * gc
    ws = (-3.0 * c4 * u5) * gc
    return wd * dx + ws * sdx, wd * dy + ws * sdy, wd * dz + ws * sdz


def far_field_hier_plain(bodies, summ, far_src, far_tgt, *, n: int, tile: int,
                         eps2: float, c2: float, G: float) -> torch.Tensor:
    """Softened monopole + quadrupole far field (N, 3): for each live chunk,
    the target row's bodies against its ``FAR_ENTRIES`` node summaries."""
    k_t = n // tile
    live = _live_chunks(far_tgt, k_t)
    src = far_src[:live * FAR_ENTRIES].long().reshape(live, FAR_ENTRIES)
    tgt = far_tgt[:live].long()
    targets = bodies[:n, :3].reshape(k_t, tile, 3)
    acc = bodies.new_zeros((k_t, tile, 3))
    batch = max(1, _PLAIN_PAIRS // (tile * FAR_ENTRIES))
    for b in range(0, live, batch):
        s = summ[src[b:b + batch]][:, None]                      # (B, 1, E, 12)
        p = targets[tgt[b:b + batch]]                            # (B, T, 3)
        terms = _far_terms(s, p[..., 0:1], p[..., 1:2], p[..., 2:3],
                           eps2=eps2, c2=c2, G=G)                # (B, T, E) each
        acc.index_add_(0, tgt[b:b + batch], torch.stack([t.sum(-1) for t in terms], -1))
    return acc.reshape(n, 3)


def far_split(tile: int) -> tuple[int, int, int]:
    """``(sub, parts, stage_chunks)`` of the far kernel's block for target
    rows of ``tile`` bodies: ``sub`` consecutive targets of one row (the
    largest multiple of 32 that divides ``tile``, up to :data:`FAR_TARGETS`),
    two a thread, times ``parts``: whole warps, at most
    :data:`FAR_MAX_THREADS` threads and at least the 96 that stage one
    chunk's 192 node quads two a thread. Part ``p`` sums the entries
    ``p, p + parts, ...`` of each stage of ``stage_chunks`` chunks
    (:func:`far_parts`)."""
    sub = max(s for s in range(32, max(32, min(tile, FAR_TARGETS)) + 1, 32) if tile % s == 0)
    half = sub // 2
    parts = max(-(-3 * FAR_ENTRIES // (FAR_SLOTS * half)),
                min(FAR_PARTS, FAR_MAX_THREADS // half))
    parts += 1 if parts * half % 32 else 0   # whole warps: half is a multiple of 16
    stage = max(1, min(FAR_STAGE_CHUNKS, FAR_SLOTS * half * parts // (3 * FAR_ENTRIES)))
    return sub, parts, stage


def far_parts(n_entries: int, parts: int, stage_chunks: int) -> list[list[int]]:
    """The far kernel's split of a row's ``n_entries`` entries (its chunks'
    entries in order): for each part, the entries it sums, in its order."""
    per = stage_chunks * FAR_ENTRIES
    out: list[list[int]] = [[] for _ in range(parts)]
    for e0 in range(0, n_entries, per):
        for p in range(parts):
            out[p].extend(range(e0 + p, min(e0 + per, n_entries), parts))
    return out


def far_field_hier(bodies, summ, far_src, far_tgt, *, n: int, tile: int,
                   eps2: float, c2: float, G: float) -> torch.Tensor:
    """Hierarchical far field (N, 3) over the compacted far lists.

    ``far_field_hier.launches`` counts the kernel's launches.
    """
    kw = dict(n=n, tile=tile, eps2=eps2, c2=c2, G=G)
    if bodies.device.type == "cpu":
        return far_field_hier_plain(bodies, summ, far_src, far_tgt, **kw)
    if bodies.device.type != "cuda":
        raise ValueError(f"far_field_hier: no kernel for device {bodies.device}")
    dev = bodies.device
    _check_block(tile)
    if bodies.shape[0] < n or n % tile or n > cuda_build.MAX_BODIES:
        raise ValueError(f"far_field_hier: N={n} must divide tile={tile}")
    cuda_build.require_f32("bodies", bodies, (bodies.shape[0], 4), dev)
    cuda_build.require_f32("summ", summ, (summ.shape[0], 12), dev)
    cuda_build.require_normal_eps2("far_field_hier", eps2)
    _require_i32("far_src", far_src, dev)
    _require_i32("far_tgt", far_tgt, dev)
    n_chunks = far_tgt.shape[0]
    if far_src.shape[0] < n_chunks * FAR_ENTRIES:
        raise ValueError("far_field_hier: far_src shorter than its chunks")
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    sub, parts, stage_chunks = far_split(tile)
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        rc = lib.nbody_far_field(bodies.data_ptr(), n, tile, sub, parts, stage_chunks,
                                 summ.data_ptr(), far_src.data_ptr(), far_tgt.data_ptr(),
                                 n_chunks, out.data_ptr(), c2, eps2, G * math.sqrt(c2),
                                 _stream(dev))
        far_field_hier.launches += 1
    cuda_build.check(rc, "far_field_kernel")
    return out


far_field_hier.launches = 0


# ---------------------------------------------------- single-level far field
def far_field_single_plain(bodies, summ, near_mask, *, n: int, tile: int,
                           eps2: float, c2: float, G: float) -> torch.Tensor:
    """Single-level far field (N, 3): every body against all K_s level-0
    summaries except the near tiles of its target row."""
    k_s = near_mask.shape[1]
    s = summ[:k_s]
    rows = max(1, _PLAIN_PAIRS // max(k_s * tile, 1))
    targets = bodies[:n, :3]
    out = []
    for r in range(0, n // tile, rows):
        p = targets[r * tile:(r + rows) * tile]
        live = ~near_mask[r:r + rows].bool().repeat_interleave(tile, 0)
        terms = _far_terms(s, p[:, 0:1], p[:, 1:2], p[:, 2:3], eps2=eps2, c2=c2, G=G)
        out.append(torch.stack([torch.where(live, t, 0.0).sum(1) for t in terms], 1))
    return torch.cat(out) if out else bodies.new_zeros((0, 3))


def single_split(tile: int) -> tuple[int, int, int]:
    """``(parts, per, stage)`` of the single-level far kernel's block for
    target rows of ``tile`` bodies: one row, ``tile / 2`` threads of two
    targets times ``parts`` (about :data:`SINGLE_THREADS` threads, at least
    one part), rounded up to whole warps (the extra threads stage, they do
    not sum); each thread reads ``per`` mask entries a stage, so a stage is
    ``stage`` = ``per`` x threads entries (:func:`single_parts`)."""
    half = tile // 2
    parts = max(1, min(SINGLE_THREADS, SINGLE_MAX_THREADS) // half)
    per = max(1, min(SINGLE_ENTRIES, SINGLE_MAX_ENTRIES))
    return parts, per, per * -(-half * parts // 32) * 32


def single_parts(masked, parts: int, stage: int) -> list[list[int]]:
    """The single-level far kernel's split of one target row's source
    tiles, ``masked[e]`` true for a near tile: each stage of ``stage``
    entries keeps its unmasked tiles in index order, and part ``p`` sums the
    kept tiles ``p, p + parts, ...`` of each stage. For each part, the tiles
    it sums, in its order; every unmasked tile lies in exactly one part."""
    out: list[list[int]] = [[] for _ in range(parts)]
    for e0 in range(0, len(masked), stage):
        kept = [e for e in range(e0, min(e0 + stage, len(masked))) if not masked[e]]
        for p in range(parts):
            out[p].extend(kept[p::parts])
    return out


def far_field_single(bodies, summ, near_mask, *, n: int, tile: int, eps2: float,
                     c2: float, G: float) -> torch.Tensor:
    """Single-level far field (N, 3) of the level-0 summaries, the near
    tiles of each target row (``near_mask``) left out.

    ``far_field_single.launches`` counts the kernel's launches.
    """
    kw = dict(n=n, tile=tile, eps2=eps2, c2=c2, G=G)
    if bodies.device.type == "cpu":
        return far_field_single_plain(bodies, summ, near_mask, **kw)
    if bodies.device.type != "cuda":
        raise ValueError(f"far_field_single: no kernel for device {bodies.device}")
    dev = bodies.device
    _check_block(tile)
    k_t, k_s = near_mask.shape
    if n % tile or k_t != n // tile or bodies.shape[0] < n or n > cuda_build.MAX_BODIES:
        raise ValueError(f"far_field_single: N={n} must divide tile={tile} and "
                         f"match the mask's {k_t} rows")
    cuda_build.require_f32("bodies", bodies, (bodies.shape[0], 4), dev)
    cuda_build.require_f32("summ", summ, (summ.shape[0], 12), dev)
    if summ.shape[0] < k_s:
        raise ValueError(f"far_field_single: {summ.shape[0]} summary rows < K_s={k_s}")
    if near_mask.device != dev or near_mask.dtype not in (torch.bool, torch.uint8) \
            or not near_mask.is_contiguous():
        raise ValueError(f"near_mask must be a contiguous bool or uint8 tensor on {dev}")
    cuda_build.require_normal_eps2("far_field_single", eps2)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    parts, per, _ = single_split(tile)
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        rc = lib.nbody_far_single(bodies.data_ptr(), n, tile, parts, per, summ.data_ptr(),
                                  k_s, near_mask.data_ptr(), out.data_ptr(), c2, eps2,
                                  G * math.sqrt(c2), _stream(dev))
        far_field_single.launches += 1
    cuda_build.check(rc, "far_single_kernel")
    return out


far_field_single.launches = 0


# ------------------------------------------------------ dense near field
def gather_panels_plain(bodies, near_idx, *, tile: int) -> torch.Tensor:
    """(K, M T, 4): target tile k's near tiles ``near_idx[k]`` of body rows,
    side by side."""
    tiles = bodies[:bodies.shape[0] // tile * tile].reshape(-1, tile, 4)
    return tiles[near_idx.long()].reshape(near_idx.shape[0], -1, 4)


def gather_panels(bodies, near_idx, *, tile: int) -> torch.Tensor:
    """The dense path's near panels (K, M T, 4); ``near_idx`` must lie in
    [0, rows of ``bodies`` / ``tile``) (the kernel does not check it).

    ``gather_panels.launches`` counts the kernel's launches.
    """
    if bodies.device.type == "cpu":
        return gather_panels_plain(bodies, near_idx, tile=tile)
    if bodies.device.type != "cuda":
        raise ValueError(f"gather_panels: no kernel for device {bodies.device}")
    dev = bodies.device
    cuda_build.require_f32("bodies", bodies, (bodies.shape[0], 4), dev)
    if near_idx.device != dev or near_idx.dtype != torch.int32 or near_idx.dim() != 2 \
            or not near_idx.is_contiguous():
        raise ValueError(f"near_idx must be a contiguous 2-D int32 tensor on {dev}")
    k, m_near = near_idx.shape
    if tile <= 0 or k * m_near * tile > cuda_build.MAX_BODIES:
        raise ValueError(f"gather_panels: {k} x {m_near} tiles of {tile} rows is too many")
    out = torch.empty((k, m_near * tile, 4), dtype=torch.float32, device=dev)
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        rc = lib.nbody_gather_panels(bodies.data_ptr(), tile, near_idx.data_ptr(), k,
                                     m_near, out.data_ptr(), _stream(dev))
        gather_panels.launches += 1
    cuda_build.check(rc, "gather_panels_kernel")
    return out


gather_panels.launches = 0


def near_panel_plain(bodies, panels, *, tile: int, eps2: float,
                     c2: float) -> torch.Tensor:
    """Exact near field (K T, 3): target tile k against its panel k."""
    k, width = panels.shape[:2]
    targets = bodies[:k * tile, :3].reshape(k, tile, 3)
    batch = max(1, _PLAIN_PAIRS // max(tile * width, 1))
    out = []
    for b in range(0, k, batch):
        pan = panels[b:b + batch]
        d = pan[:, None, :, :3] - targets[b:b + batch, :, None, :]     # (B, T, W, 3)
        r2 = (d * d).sum(-1)
        inv = torch.rsqrt(r2 * c2 + eps2)
        w = pan[:, None, :, 3] * (inv * inv * inv)
        out.append((w[..., None] * d).sum(2))
    return torch.cat(out).reshape(k * tile, 3)


def panel_split(tile: int) -> tuple[int, int]:
    """``(parts, stage)`` of the near-panel kernel's block for target tiles
    of ``tile`` bodies: one tile, ``tile /`` :data:`PANEL_ROWS` threads of
    four targets times ``parts`` (about :data:`PANEL_THREADS` threads, at
    least one part); it stages ``stage`` panel rows at a time, and part
    ``p`` sums the rows ``p, p + parts, ...`` of each stage
    (:func:`near_parts`)."""
    group = tile // PANEL_ROWS
    return max(1, min(PANEL_THREADS, PANEL_MAX_THREADS) // group), max(1, PANEL_STAGE)


def near_panel(bodies, panels, *, tile: int, eps2: float, c2: float) -> torch.Tensor:
    """Exact near field (K T, 3) of each target tile against its gathered
    panel (:func:`gather_panels`).

    ``near_panel.launches`` counts the kernel's launches.
    """
    if bodies.device.type == "cpu":
        return near_panel_plain(bodies, panels, tile=tile, eps2=eps2, c2=c2)
    if bodies.device.type != "cuda":
        raise ValueError(f"near_panel: no kernel for device {bodies.device}")
    dev = bodies.device
    _check_block(tile)
    if panels.dim() != 3:
        raise ValueError("panels must be (K, W, 4)")
    k, width = panels.shape[:2]
    cuda_build.require_f32("panels", panels, (k, width, 4), dev)
    cuda_build.require_f32("bodies", bodies, (bodies.shape[0], 4), dev)
    if bodies.shape[0] < k * tile or k * max(width, tile) > cuda_build.MAX_BODIES:
        raise ValueError(f"near_panel: {k} tiles of {tile} need that many body rows")
    cuda_build.require_normal_eps2("near_panel", eps2)
    out = torch.empty((k * tile, 3), dtype=torch.float32, device=dev)
    parts, stage = panel_split(tile)
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        rc = lib.nbody_near_panel(bodies.data_ptr(), tile, panels.data_ptr(), k, width, parts,
                                  stage, out.data_ptr(), c2, eps2, _stream(dev))
        near_panel.launches += 1
    cuda_build.check(rc, "near_panel_kernel")
    return out


near_panel.launches = 0


# --------------------------------------------------------------- VIP sweep
def vip_both_plain(rows, panel, *, eps2: float,
                   c2: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(action (N, 3) of the panel on every row, reaction (W, 3) of every
    row on each panel body) from one pass over the N x W pairs."""
    w_cnt = panel.shape[0]
    batch = max(1, _PLAIN_PAIRS // max(w_cnt, 1))
    react = rows.new_zeros((w_cnt, 3))
    action = []
    for r in range(0, rows.shape[0], batch):
        pi = rows[r:r + batch]
        d = panel[None, :, :3] - pi[:, None, :3]                 # (B, W, 3)
        r2 = (d * d).sum(-1)
        inv = torch.rsqrt(r2 * c2 + eps2)
        u = inv * inv * inv
        action.append(((panel[None, :, 3] * u)[..., None] * d).sum(1))
        react -= ((pi[:, 3:4] * u)[..., None] * d).sum(0)
    return torch.cat(action), react


def vip_split(n: int, w: int) -> tuple[int, int, int]:
    """``(groups, pieces, piece)`` of the VIP sweep's grid for N rows and W
    VIP bodies: ``groups`` blocks of :data:`VIP_ROWS` rows times ``pieces``
    pieces of ``piece`` VIPs (a multiple of 32; the last piece what is left).
    The panel is cut into pieces of at most :data:`VIP_MAX_PIECE` VIPs, and
    further, down to one 32-VIP sub-panel, as far as it takes to bring the
    grid to about :data:`VIP_BLOCKS` blocks; with several pieces a second
    kernel adds the actions in piece order, and it always adds the reactions
    over the groups in group order."""
    if n < 0 or w < 0:
        raise ValueError(f"vip_split: N={n}, W={w} must not be negative")
    groups = max(1, -(-n // VIP_ROWS))
    subs = max(1, -(-w // 32))
    want = min(subs, max(-(-VIP_BLOCKS // groups), -(-w // VIP_MAX_PIECE), 1))
    piece = 32 * -(-subs // want)
    return groups, max(1, -(-w // piece)), piece


def vip_both(rows, panel, *, eps2: float,
             c2: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(action (N, 3), reaction (W, 3)) of the two-way VIP sweep.

    ``vip_both.launches`` counts kernel launches: a sweep is two, the pair
    kernel and the kernel that sums its partial reactions (and actions, when
    :func:`vip_split` cuts the panel), or only the first when W = 0.
    """
    if rows.device.type == "cpu":
        return vip_both_plain(rows, panel, eps2=eps2, c2=c2)
    if rows.device.type != "cuda":
        raise ValueError(f"vip_both: no kernel for device {rows.device}")
    dev = rows.device
    n, w_cnt = rows.shape[0], panel.shape[0]
    cuda_build.require_f32("rows", rows, (n, 4), dev)
    cuda_build.require_f32("panel", panel, (w_cnt, 4), dev)
    if max(n, w_cnt) > cuda_build.MAX_BODIES:
        raise ValueError(f"vip_both: at most {cuda_build.MAX_BODIES} bodies")
    cuda_build.require_normal_eps2("vip_both", eps2)
    groups, pieces, piece = vip_split(n, w_cnt)
    f32 = dict(dtype=torch.float32, device=dev)
    react_part = torch.empty((groups, w_cnt, 3), **f32)
    act_part = torch.empty((pieces if pieces > 1 else 0, n, 3), **f32)
    action = torch.empty((n, 3), **f32)
    react = torch.empty((w_cnt, 3), **f32)
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        rc = lib.nbody_vip_both(rows.data_ptr(), n, panel.data_ptr(), w_cnt, pieces, piece,
                                react_part.data_ptr(), act_part.data_ptr(), action.data_ptr(),
                                react.data_ptr(), c2, eps2, _stream(dev))
        vip_both.launches += 2 if w_cnt else 1
    cuda_build.check(rc, "vip_both_kernel")
    return action, react


vip_both.launches = 0
