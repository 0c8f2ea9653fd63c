"""``launches_per_step``: host calls that put work on the device (kernel and
graph launches, copies and fills) in the traced window, over its steps."""


def read(trace, run) -> float:
    return trace.launches / trace.steps
