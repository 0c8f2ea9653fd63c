"""``tree_force_ms``: device ms a step of the kernels launched outside the
rebuild labels of a treecode run: the force, and the integrator's few
percent."""

from nbody_bench.metrics._common import is_tree, step_kernels


def read(trace, run) -> float | None:
    ops = step_kernels(trace)
    if not is_tree(run) or not ops:
        return None
    return sum(o[1] for o in ops) / 1e3 / trace.steps
