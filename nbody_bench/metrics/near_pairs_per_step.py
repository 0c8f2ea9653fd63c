"""``near_pairs_per_step``: body pairs the near field computes a step, from
the program's counters: each rebuild's count of the pairs its near lists
hold (source tile against target row, live entries only), weighted by the
steps taken on those lists, over the traced steps."""

from nbody_bench.metrics._spans import program_spans, work


def read(trace, run) -> float | None:
    found = program_spans(trace)
    totals = None if found is None else work(found)
    if totals is None:
        return None
    return totals["near_pairs"] / totals["steps"]
