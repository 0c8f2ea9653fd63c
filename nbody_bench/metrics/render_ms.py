"""``render_ms``: device ms a frame of the operations launched under the
loop's ``bench.frame`` label: the splat's kernels and the frame's copy to
the host."""


def read(trace, run) -> float | None:
    ops = [o for o in trace.device if o[4] == "bench.frame"]
    if not trace.frames or not ops:
        return None
    return sum(o[1] for o in ops) / 1e3 / trace.frames
