"""``build_min_dist_ms``: device ms a rebuild inside the program's
``build.min_dist`` phases, the acceptance build's minimum distances from
every target row to every node (``ops/treecode.py`` ``_min_tile_dist``, once
a level), timed by the stamps the build's graph holds."""

from nbody_bench.metrics._spans import phase_ms


def read(trace, run) -> float | None:
    return phase_ms(trace, "build.min_dist", "treecode.build")
