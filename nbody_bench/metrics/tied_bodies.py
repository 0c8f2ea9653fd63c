"""``tied_bodies``: at the last traced resort, the real bodies whose 30-bit
Morton key equals that of the body before them in the new order, from the
program's counter on the ``resort.order`` phase: the part of the order that
the key's finer bits decide (a crowded galaxy centre). A program without
the phase reports nothing."""

from nbody_bench.metrics._spans import program_spans, stamped


def read(trace, run) -> float | None:
    found = program_spans(trace)
    order = [] if found is None else stamped(found, "resort.order")
    if not order:
        return None
    return float(order[-1].counters.get("tied_bodies", 0))
