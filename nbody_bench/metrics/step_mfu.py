"""``step_mfu``: the whole step's FP32 operations over the FP32 peak, as a
share of the traced window's wall time a step. An exact step counts every
unordered pair both ways (27 n (n - 1) / 2); a treecode step the work of
the last traced call's acceptance lists (``peaks.tree_flops``: near pairs, far
terms, the VIP sweep), taken for every step."""

from nbody_bench import peaks
from nbody_bench.metrics._common import is_tree


def read(trace, run) -> float | None:
    step_s = trace.wall_us / 1e6 / trace.steps
    if not is_tree(run):
        return 100.0 * peaks.symmetric_flops(run.n) / peaks.PEAK_FP32 / step_s
    sim = run.system.sim
    if trace.tree_lists is None or len(trace.tree_lists) != 5:
        return None
    flops = peaks.tree_flops(trace.tree_lists, sim.state.n, sim.cfg.tree_tile,
                             sim.cfg.tree_src_tile)
    return 100.0 * flops / peaks.PEAK_FP32 / step_s
