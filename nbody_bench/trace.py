"""The traced window: a ``torch.profiler`` trace of its first calls, and
the arithmetic that the per-layer readers share.

The busy union of the device's intervals and the idle share of the window
are a frozen copy of ``_device_events``/``_busy_us``/``profile_tree_step``
in ``n_body_problem_tpu_torch/treecode_profile.py`` at commit
c8a9ef2832dd3ca6223213d0b57046ed74f6d186. A device operation is attributed
to the innermost host label (``record_function``) open when the host
launched it, matched by the trace's correlation ids: the program's
``treecode.resort`` and ``treecode.build`` around its graph replays, and
the benchmark's own ``bench.*`` labels around the calls of its loops.
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile
import time

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_API_CATS = ("cuda_runtime", "cuda_driver")
# Host calls that put work on the device.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaMemcpy", "cudaMemset", "cuMemcpyAsync", "cuMemsetD8Async",
                "cuMemsetD32Async")


class Recorder:
    """A ``torch.profiler`` recording of the calls made while it is open,
    its wall time taken from its opening to the device's synchronize at its
    close. ``trace()`` reads the chrome trace through a file in ``TMPDIR``
    that is removed once read."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.wall_us = None

    def __enter__(self):
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.wall_us = (time.perf_counter() - self.t0) * 1e6
        return self.prof.__exit__(*exc)

    def trace(self) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
        finally:
            os.unlink(path)
        return Trace(events, self.wall_us)


class Trace:
    """The events of one traced stretch of the window. ``device``: (ts,
    dur, name, cat, label) of every device operation, ``label`` the
    innermost host label open at its launch (or None); ``launches``: how
    many host calls put work on the device; ``labels``: the host labels by
    name, each a list of (ts, dur). The harness adds ``calls``, ``steps``
    and ``frames``, the traced calls' counts, and ``tree_lists``, the
    acceptance lists the last traced call ended with (None off the
    treecode)."""

    def __init__(self, events: list, wall_us: float):
        self.wall_us = wall_us
        self.calls = self.steps = self.frames = 0
        self.tree_lists = None
        self.labels: dict[str, list] = {}
        for e in events:
            if e.get("cat") == "user_annotation" and "dur" in e:
                self.labels.setdefault(e["name"], []).append((e["ts"], e["dur"]))
        api = [e for e in events if e.get("cat") in HOST_API_CATS and "dur" in e]
        self.launches = sum(e["name"] in LAUNCH_CALLS for e in api)
        launch_ts = {e["args"]["correlation"]: e["ts"] for e in api
                     if "correlation" in e.get("args", {})}
        dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        host_ts = np.array([launch_ts.get(e.get("args", {}).get("correlation"), np.nan)
                            for e in dev], dtype=float)
        names = self._label_at(host_ts)
        self.device = [(e["ts"], e["dur"], e["name"], e["cat"], lab)
                       for e, lab in zip(dev, names)]
        self.host_ops = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation",
                                                                "cuda_runtime", "cuda_driver",
                                                                "python_function")
                         and "dur" in e]

    def _label_at(self, ts: np.ndarray) -> list:
        """The innermost host label open at each host time of ``ts``."""
        out = np.full(len(ts), -1)
        spans = sorted(((a, d, name) for name, iv in self.labels.items() for a, d in iv),
                       key=lambda s: -s[1])           # outermost first, inner ones win
        names = [s[2] for s in spans]
        order = np.argsort(ts)
        sts = ts[order]
        for i, (a, d, _) in enumerate(spans):
            lo, hi = np.searchsorted(sts, a, "left"), np.searchsorted(sts, a + d, "right")
            out[order[lo:hi]] = i
        return [names[i] if i >= 0 else None for i in out]

    def busy_us(self, ops=None) -> float:
        """µs the device was busy: the union of the intervals of ``ops``
        (every device operation by default)."""
        ops = self.device if ops is None else ops
        covered, end = 0.0, float("-inf")
        for a, b in sorted((o[0], o[0] + o[1]) for o in ops):
            if b > end:
                covered += b - max(a, end)
                end = b
        return covered

    def idle_gaps(self) -> list[tuple[float, float]]:
        """(start, length) µs of every gap between the device's busy
        intervals."""
        gaps, end = [], None
        for a, b in sorted((o[0], o[0] + o[1]) for o in self.device):
            if end is not None and a > end:
                gaps.append((end, a - end))
            end = b if end is None else max(end, b)
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (summed by name), and
        the longest idle gaps summed by the innermost host operation open
        across each, in seconds."""
        by_op: dict[str, float] = {}
        for _, dur, name, _, _ in self.device:
            by_op[name] = by_op.get(name, 0.0) + dur / 1e6
        gaps = sorted(self.idle_gaps(), key=lambda g: -g[1])[:2000]
        starts = np.array([e["ts"] for e in self.host_ops], dtype=float)
        ends = starts + np.array([e["dur"] for e in self.host_ops], dtype=float)
        by_host: dict[str, float] = {}
        for a, d in gaps:
            mid = a + d / 2
            inside = np.flatnonzero((starts <= mid) & (ends >= mid))
            name = ("(no host operation)" if not len(inside) else
                    self.host_ops[inside[np.argmin(ends[inside] - starts[inside])]]["name"])
            by_host[name] = by_host.get(name, 0.0) + d / 1e6
        pick = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"device_ops": pick(by_op), "idle_gaps": pick(by_host)}
