"""Blocked all-pairs force: the hand-written CUDA kernel and its plain twin.

Counterpart of ``n_body_problem_tpu.ops.pallas_force``:
:func:`block_acc` stands where ``pallas_block_acc`` stands and
:func:`allpairs_acc` where ``pallas_acc`` does. On a CUDA tensor the
wrapper launches ``allpairs_acc_kernel`` (``csrc/allpairs.cu``); on a CPU
tensor it runs :func:`block_acc_plain`, the same function in plain PyTorch,
which is also what the kernel is checked against on the card. There is no
other path: a failed build or launch raises.

The kernel splits the columns as well as the rows, so that its grid fills
the card at any Ni: :func:`allpairs_split` chooses, from Ni and Nj alone, how
many groups of threads of a block share its rows (``parts``) and how many
column pieces the blocks of a row take (``pieces``); with more than one piece
a second kernel adds the pieces' partial sums. Every order of summation is
fixed by (Ni, Nj) and nothing is atomic, so the result is bitwise the same
from run to run.
"""

from __future__ import annotations

import torch

from n_body_problem_tpu_torch.ops import cuda_build
from n_body_problem_tpu_torch.ops.forces import pair_accel_tile

DEFAULT_TILE_I = 256
DEFAULT_TILE_J = 1024
# Largest (rows x columns) pair block the plain version materialises at once.
_PLAIN_PAIRS = 1 << 24
# csrc/allpairs.cu: 256 threads of four row bodies each, 1,024 column bodies
# a stage; the groups of threads a block may be cut into, and how many it is.
ALLPAIRS_BLOCK_ROWS = 1024
ALLPAIRS_STAGE = 1024
ALLPAIRS_PARTS = (1, 2, 4, 8)
ALLPAIRS_DEFAULT_PARTS = 8
# With fewer row blocks than two for each of an H100's 132 multiprocessors
# the columns are cut into pieces, as many as bring the grid to about eight
# blocks a multiprocessor.
ALLPAIRS_MIN_BLOCKS = 264
ALLPAIRS_CUT_BLOCKS = 1056


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


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def allpairs_split(ni: int, nj: int) -> tuple[int, int, int]:
    """``(rows, parts, pieces)`` of the kernel's launch for Ni row and Nj
    column bodies, in the kernel's integer arithmetic.

    A block holds ``rows = 1024 // parts`` row bodies, four a thread;
    ``parts`` groups of its threads hold the same rows and share out the
    columns of every stage (:func:`allpairs_columns`). Eight parts, so 128
    rows a block, were the fastest at every shape timed on the card. If the
    row blocks are fewer than :data:`ALLPAIRS_MIN_BLOCKS`, the column stages
    are cut into ``pieces`` contiguous runs, one block each, to bring the
    grid to about :data:`ALLPAIRS_CUT_BLOCKS`; a second kernel then adds the
    pieces in order. With one piece there is one launch."""
    if ni < 0 or nj < 0:
        raise ValueError(f"allpairs_split: Ni={ni}, Nj={nj} must not be negative")
    parts = ALLPAIRS_DEFAULT_PARTS
    rows = ALLPAIRS_BLOCK_ROWS // parts
    row_blocks = max(1, _ceil_div(ni, rows))
    stages = max(1, _ceil_div(nj, ALLPAIRS_STAGE))
    want = (1 if row_blocks >= ALLPAIRS_MIN_BLOCKS
            else min(stages, _ceil_div(ALLPAIRS_CUT_BLOCKS, row_blocks)))
    return rows, parts, _ceil_div(stages, _ceil_div(stages, want))


def stages_a_piece(nj: int, pieces: int) -> int:
    """Stages of :data:`ALLPAIRS_STAGE` columns each of the ``pieces`` takes
    (the last piece what is left)."""
    return _ceil_div(max(1, _ceil_div(nj, ALLPAIRS_STAGE)), pieces)


def allpairs_columns(nj: int, parts: int, pieces: int) -> list[list[list[range]]]:
    """``[piece][part]`` -> the runs of column indices that part of a block of
    that piece sums, in the kernel's order: of every stage of its piece, the
    ``part``-th run of ``1024 // parts`` columns (cut at Nj)."""
    per = stages_a_piece(nj, pieces)
    cols = ALLPAIRS_STAGE // parts
    out = []
    for piece in range(pieces):
        last = min(nj, (piece + 1) * per * ALLPAIRS_STAGE)
        out.append([[range(min(last, base + p * cols), min(last, base + (p + 1) * cols))
                     for base in range(piece * per * ALLPAIRS_STAGE, last, ALLPAIRS_STAGE)]
                    for p in range(parts)])
    return out


def _launch(pos_i, pos_j, mass_j, *, eps2, compensate, G) -> torch.Tensor:
    dev = pos_i.device
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    for name, t, shape in (("pos_i", pos_i, (ni, 3)), ("pos_j", pos_j, (nj, 3)),
                           ("mass_j", mass_j, (nj,))):
        cuda_build.require_f32(name, t, shape, dev)
    if max(ni, nj) > cuda_build.MAX_BODIES:
        raise ValueError(f"block_acc: at most {cuda_build.MAX_BODIES} bodies per side")
    cuda_build.require_normal_eps2("block_acc", eps2)
    out = torch.empty((ni, 3), dtype=torch.float32, device=dev)
    if ni == 0:
        return out
    c2 = compensate * compensate
    cols = torch.cat([pos_j, (mass_j * (G * c2 * compensate))[:, None]], dim=1)
    _, parts, pieces = allpairs_split(ni, nj)
    partial = (torch.empty((pieces, ni, 3), dtype=torch.float32, device=dev)
               if pieces > 1 else out)
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nbody_allpairs_acc(pos_i.data_ptr(), ni, cols.data_ptr(), nj, parts,
                                    stages_a_piece(nj, pieces), pieces, partial.data_ptr(),
                                    out.data_ptr(), c2, eps2, stream)
        block_acc.launches += 2 if pieces > 1 else 1
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

    ``block_acc.launches`` counts kernel launches: one a call, or two where
    :func:`allpairs_split` cuts the columns into pieces (the pair kernel
    and the kernel that adds the pieces). On the card ``eps2`` must be a
    normal float32 (``cuda_build.MIN_EPS2``).
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

# The wrappers whose ``.launches`` a captured CUDA graph adds to on every
# replay (``graphs.Program``).
COUNTED = (block_acc,)


def allpairs_acc(pos: torch.Tensor, mass: torch.Tensor, **kw) -> torch.Tensor:
    """acc (N, 3) from pos (N, 3) and mass (N,) — all-pairs block solve."""
    return block_acc(pos, pos, mass, **kw)
