"""The yardstick's table of peaks and the operations a kernel's work needs.

A frozen copy of the constants of ``n_body_problem_tpu_torch/kernel_compare.py``
(which ``chip_smoke.py`` imports) at commit
c8a9ef2832dd3ca6223213d0b57046ed74f6d186: FP32 operations a body pair one way
(20) and both ways (27) and a body-node term (52), an FMA counted as two and
an rsqrt as one, over the FP32 peak of one H100 SXM outside the tensor cores
(67 TFLOP/s at its 700 W limit, NVIDIA's data sheet); and the count of the
near pairs and far terms that a hierarchical treecode's acceptance lists
hold (``near_work`` and ``far_work`` there; ``_level_plan`` of
``ops/treecode.py`` for the far lists' sentinel node).
"""

from __future__ import annotations

PEAK_FP32 = 67e12          # FLOP/s
PAIR_FLOPS, PAIR_BOTH_FLOPS, NODE_FLOPS = 20, 27, 52
HIER_BRANCH, HIER_MIN_NODES = 2, 16


def symmetric_flops(n_real: int) -> float:
    """FP32 operations of one exact step: every unordered pair once, both
    ways."""
    return PAIR_BOTH_FLOPS * n_real * (n_real - 1) / 2


def level_nodes(k_s: int) -> int:
    """Nodes of every level of the binary hierarchy over ``k_s`` source
    tiles, the index of the far lists' zero sentinel node."""
    total, k = k_s, k_s
    while k % HIER_BRANCH == 0 and k // HIER_BRANCH >= HIER_MIN_NODES:
        k //= HIER_BRANCH
        total += k
    return total


def near_pairs(flat_src, chunk_tgt, n: int, tile: int, src_tile: int) -> int:
    """Body pairs the near lists hold: each live entry (neither the sentinel
    source ``n // src_tile`` nor in an unused chunk, whose target is the
    sentinel ``n // tile``) is a source tile against a target row."""
    e = flat_src.numel() // chunk_tgt.numel()
    ids = flat_src[:chunk_tgt.numel() * e].reshape(-1, e)
    live = (ids != n // src_tile) & (chunk_tgt < n // tile)[:, None]
    return int(live.sum()) * src_tile * tile


def far_terms(far_src, far_tgt, n: int, tile: int, src_tile: int) -> int:
    """Body-node terms the far lists hold: live entries times the row."""
    e = far_src.numel() // far_tgt.numel()
    ids = far_src[:far_tgt.numel() * e].reshape(-1, e)
    live = (ids != level_nodes(n // src_tile)) & (far_tgt < n // tile)[:, None]
    return int(live.sum()) * tile


def tree_flops(lists, n: int, tile: int, src_tile: int) -> float:
    """FP32 operations of one hierarchical treecode force on ``lists``
    (``flat_src, chunk_tgt, far_src, far_tgt, is_vip_body``): the near
    pairs one way, the far terms, and the VIP sweep's every body against
    every VIP body both ways."""
    flat_src, chunk_tgt, far_src, far_tgt, is_vip = lists
    return (PAIR_FLOPS * near_pairs(flat_src, chunk_tgt, n, tile, src_tile)
            + NODE_FLOPS * far_terms(far_src, far_tgt, n, tile, src_tile)
            + PAIR_BOTH_FLOPS * n * int(is_vip.sum()))
