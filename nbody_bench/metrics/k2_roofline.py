"""``k2_roofline``: the FP32 operations of every unordered pair both
ways, 27 n (n - 1) / 2 a step, over the FP32 peak, as a share of the device
time a step of kernel 2 (``symmetric_acc_kernel``) and its slots' sum
(``symmetric_sum_kernel``). The pairs are those the physics needs, whatever
implements them."""

from nbody_bench import peaks
from nbody_bench.metrics._common import kernels


def read(trace, run) -> float | None:
    ops = kernels(trace, ("symmetric_acc_kernel", "symmetric_sum_kernel"))
    if not ops:
        return None
    step_s = sum(o[1] for o in ops) / 1e6 / trace.steps
    return 100.0 * peaks.symmetric_flops(run.n) / peaks.PEAK_FP32 / step_s
