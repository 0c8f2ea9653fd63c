"""``resort_ms``: device ms a rebuild inside the program's ``resort.order``
phase, the resort's Morton keys and their sort (``utils/morton.py``
``morton_order``), timed by the stamps the resort's graph holds. A program
without the phase reports nothing."""

from nbody_bench.metrics._spans import phase_ms


def read(trace, run) -> float | None:
    return phase_ms(trace, "resort.order", "treecode.resort")
