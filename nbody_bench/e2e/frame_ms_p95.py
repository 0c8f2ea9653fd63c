"""``frame_ms_p95``: the 95th percentile, over every frame of the window,
of the time from the loop's request to the frame in host memory."""

import numpy as np


def read(run) -> float | None:
    if not run.frames:
        return None
    return float(np.percentile(np.asarray(run.durations) * 1e3, 95))
