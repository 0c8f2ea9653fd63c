"""Method A foil: the materialised pair-force matrix, in plain PyTorch.

Counterpart of ``n_body_problem_tpu.ops.pair_matrix`` (dev-history D1, the
reference's first working solver, ``project_develop_code.cu:657-861``):
every pair force of the strict upper triangle is written to a length
N(N-1)/2 array, then each body's row and column are reduced and divided by
its mass. The JAX version is plain ``jnp`` with no Pallas kernel, and so is
this one: ``torch.triu_indices`` for the pair enumeration and
``index_put_(accumulate=True)`` for ``segment_sum``. It runs on either
device, and on both it gives the same bits every run: ``index_put_`` sorts
its indices before it adds, where ``index_add_`` on the card adds with
atomics in whatever order the threads run.

It exists as the perf-history foil, not a production path: it moves
N(N-1)/2 pair forces through device memory where the kernels touch O(N).
Its int64 indices add 16 bytes a pair, so use small N.
"""

from __future__ import annotations

import torch

__all__ = ["pair_matrix_acc", "MAX_PAIR_MATRIX_BODIES"]

# Above this the materialised triangle exceeds a sane memory budget; refuse
# rather than run out of memory (the JAX package's cap).
MAX_PAIR_MATRIX_BODIES = 32768


def pair_matrix_acc(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    eps2: float,
    compensate: float = 0.1,
    G: float = 1.0,
) -> torch.Tensor:
    """acc (N, 3) via the materialised half-pair force matrix (slow foil)."""
    n = pos.shape[0]
    if n > MAX_PAIR_MATRIX_BODIES:
        raise ValueError(
            f"pair_matrix_acc is the Method-A perf foil; N={n} exceeds "
            f"{MAX_PAIR_MATRIX_BODIES} (the materialized triangle would be "
            ">8 GB). Use any production solver instead.")
    pos = pos.float()
    mass = mass.float()
    c2 = compensate * compensate
    gc3 = G * c2 * compensate

    # The strict upper triangle, flattened: calculate_index's enumeration.
    iu, ju = torch.triu_indices(n, n, offset=1, device=pos.device)
    d = pos[ju] - pos[iu]                                   # (P, 3)
    r2 = torch.sum(d * d, dim=-1)
    inv = torch.rsqrt(c2 * r2 + eps2)
    # FORCE per pair (both masses), as Method A stored it.
    f = (gc3 * mass[iu] * mass[ju] * inv * inv * inv)[:, None] * d

    # Force on i is the sum over its row, on j the reaction.
    acc_i = torch.zeros((n, 3), dtype=pos.dtype, device=pos.device).index_put_(
        (iu,), f, accumulate=True)
    acc_j = torch.zeros((n, 3), dtype=pos.dtype, device=pos.device).index_put_(
        (ju,), f, accumulate=True)
    force = acc_i - acc_j
    safe = torch.where(mass > 0, mass, torch.ones_like(mass))
    return torch.where(mass[:, None] > 0, force / safe[:, None], torch.zeros_like(force))
