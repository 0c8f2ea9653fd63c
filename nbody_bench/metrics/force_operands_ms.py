"""``force_operands_ms``: device ms a step inside the program's
``force.operands`` phase, the level summaries and the packing of the
kernels' operands (``ops/treecode.py`` ``kernel_operands``), timed by the
stamps the step's graph holds."""

from nbody_bench.metrics._spans import phase_ms


def read(trace, run) -> float | None:
    return phase_ms(trace, "force.operands", "treecode.step")
