"""``build_ms``: device ms a rebuild of the operations launched under the
program's ``treecode.resort`` and ``treecode.build`` labels (the device
resort and the acceptance build, replayed)."""

from nbody_bench.metrics._common import REBUILD_LABELS


def read(trace, run) -> float | None:
    builds = len(trace.labels.get("treecode.build", ()))
    ops = [o for o in trace.device if o[4] in REBUILD_LABELS]
    if not builds or not ops:
        return None
    return sum(o[1] for o in ops) / 1e3 / builds
