"""``build_lists_ms``: device ms a rebuild inside the program's
``build.lists`` phase, the compaction of the near and far work lists
(``ops/treecode.py`` ``_hier_compact``), timed by the build's stamps."""

from nbody_bench.metrics._spans import phase_ms


def read(trace, run) -> float | None:
    return phase_ms(trace, "build.lists", "treecode.build")
