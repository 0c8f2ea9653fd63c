"""Profiling hooks: ``torch.profiler`` traces around the step loop.

Counterpart of ``n_body_problem_tpu.utils.profiling``: the JAX package's
``jax.profiler`` trace becomes a ``torch.profiler`` trace of the host and,
on a GPU, the card, written as a Chrome trace (viewable in Perfetto or
``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import pathlib

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | pathlib.Path | None):
    """``with trace("out/profile"):`` writes ``out/profile/trace.json``;
    no-op when ``log_dir`` is None. The card's activity is traced when
    CUDA is available."""
    if log_dir is None:
        yield
        return
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(log_dir / TRACE_NAME))


def annotate(name: str):
    """Named region inside a trace (``torch.profiler.record_function``)."""
    return record_function(name)
