"""``tree_force_glue_pct``: the share of ``tree_force_ms`` in kernels other
than the program's hand-written treecode kernels (matched by name): the
level summaries, the packing and the update."""

from nbody_bench.metrics._common import TREE_KERNELS, is_tree, step_kernels


def read(trace, run) -> float | None:
    ops = step_kernels(trace)
    total = sum(o[1] for o in ops)
    if not is_tree(run) or not total:
        return None
    glue = sum(o[1] for o in ops if not any(k in o[2] for k in TREE_KERNELS))
    return 100.0 * glue / total
