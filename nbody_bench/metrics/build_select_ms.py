"""``build_select_ms``: device ms a rebuild inside the program's
``build.select`` phases, the work lists' row selections (``ops/treecode.py``
``_top_k`` in ``_compact_open_lists``: the near lists', and on the
hierarchical path the far lists'), timed by the stamps the build's graph
holds. A program without the phase reports nothing."""

from nbody_bench.metrics._spans import phase_ms


def read(trace, run) -> float | None:
    return phase_ms(trace, "build.select", "treecode.build")
