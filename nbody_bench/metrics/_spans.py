"""What the readers of the program's own spans share: the spans of the
traced window on the trace's clock (``utils.profiling.spans`` of
``n_body_problem_tpu_torch``), read once a trace. A program that records no
spans (one without ``profiling.spans``, or a window with none) gives None,
and its readers report nothing."""


def program_spans(trace):
    """The window's spans, kept on the trace as ``program_spans``, or None."""
    if not hasattr(trace, "program_spans"):
        trace.program_spans = _read(trace)
    return trace.program_spans


def _read(trace):
    try:
        from n_body_problem_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    stamp = profiling.STAMP_KERNEL
    # The events that place the spans on the trace's clock: the sim.run
    # labels and the stamp kernel's launches.
    events = [{"cat": "user_annotation", "name": "sim.run", "ts": a, "dur": d}
              for a, d in trace.labels.get("sim.run", ())]
    events += [{"cat": "kernel", "name": o[2], "ts": o[0], "dur": o[1]}
               for o in trace.device if o[3] == "kernel" and stamp in o[2]]
    return spans(events) or None


def work(found) -> dict | None:
    """``utils.profiling.work`` of the spans: the lists' counters weighted
    by the steps taken on them, or None without a counted build."""
    from n_body_problem_tpu_torch.utils import profiling

    out = profiling.work(found)
    return out if out["steps"] else None


def stamped(found, name: str) -> list:
    """The spans called ``name`` that hold device times."""
    return [s for s in found if s.name == name and s.device_us is not None]


def phase_ms(trace, phase: str, per: str) -> float | None:
    """Device ms inside the phase ``phase``, summed, over the stamped spans
    ``per`` (``treecode.build`` or ``treecode.step``)."""
    found = program_spans(trace)
    if found is None:
        return None
    phases, units = stamped(found, phase), stamped(found, per)
    if not phases or not units:
        return None
    return sum(s.device_us for s in phases) / 1e3 / len(units)
