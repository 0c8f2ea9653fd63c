"""``k7_roofline``: 20 FP32 operations a body pair the near lists hold,
over the FP32 peak, as a share of the device time of a call of kernel 7
(``near_field_kernel``). The lists are those of the last traced call
(``Simulation.tree_lists``), and the calls those of that chunk's steps,
the last near-field launches of the trace."""

from nbody_bench import peaks
from nbody_bench.metrics._common import is_tree, kernels


def read(trace, run) -> float | None:
    ops = sorted(kernels(trace, ("near_field_kernel",)))
    sim = run.system.sim
    lists = trace.tree_lists
    if not is_tree(run) or not ops or lists is None or len(lists) not in (4, 5):
        return None
    every, n_call = sim.cfg.tree_rebuild_every, run.cell.traffic["steps_per_call"]
    last = ops[-(n_call % every or every):]
    kernel_s = sum(o[1] for o in last) / 1e6 / len(last)
    pairs = peaks.near_pairs(lists[0], lists[1], sim.state.n, sim.cfg.tree_tile,
                             sim.cfg.tree_src_tile)
    return 100.0 * peaks.PAIR_FLOPS * pairs / peaks.PEAK_FP32 / kernel_s
