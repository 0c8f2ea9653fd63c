"""``render_idle_ms``: device ms idle a frame while the program's ``render``
span is open (``render.splat.render_state``: the host launching the frame's
kernels): the trace's idle gaps (``Trace.idle_gaps``) against the render
spans, which the ``sim.run`` labels place on the trace's clock."""

import numpy as np

from nbody_bench.metrics._spans import program_spans


def read(trace, run) -> float | None:
    found = program_spans(trace)
    if found is None or not trace.frames or not trace.labels.get("sim.run"):
        return None
    spans = sorted((s.host_start, s.host_end) for s in found
                   if s.name == "render" and s.host_end is not None)
    gaps = trace.idle_gaps()
    if not spans:
        return None
    idle = 0.0
    if gaps:
        g0 = np.array([g[0] for g in gaps])
        g1 = g0 + np.array([g[1] for g in gaps])
        for a, b in spans:
            overlap = np.minimum(g1, b) - np.maximum(g0, a)
            idle += float(overlap[overlap > 0].sum())
    return idle / 1e3 / trace.frames
