"""``device_idle_pct``: 100 (1 - busy / wall), the union of the device's
operations over the traced window's wall time."""


def read(trace, run) -> float:
    return 100.0 * (1.0 - trace.busy_us() / trace.wall_us)
