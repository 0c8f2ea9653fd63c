"""The reader of the row selection's phase, ``build_select_ms``, on
hand-made traces: the device ms of the ``build.select`` phases a stamped
build, and nothing where the program has no such phase."""

from __future__ import annotations

import pytest

from nbody_bench.metrics import build_select_ms
from nbody_bench.trace import Trace
from n_body_problem_tpu_torch.utils.profiling import Span


def _trace(spans) -> Trace:
    tr = Trace([], wall_us=10_000.0)
    tr.frames = 0
    tr.program_spans = spans
    return tr


def _builds(selects: list[tuple[float, ...]]) -> list:
    """A run of stamped builds, each a ``build.lists`` phase holding one
    ``build.select`` phase a duration given (µs)."""
    out, ids = [], iter(range(1000))

    def add(name, parent, t0=None, t1=None):
        s = Span(next(ids), name, parent, 0, device_start=t0, device_end=t1)
        out.append(s)
        return s

    run = add("sim.run", None)
    t = 0.0
    for durations in selects:
        b = add("treecode.build", run.id, t, t + 1000)
        lists = add("build.lists", b.id, t + 500, t + 900)
        at = t + 500
        for d in durations:
            add("build.select", lists.id, at, at + d)
            at += d
        t += 2000
    return out


def test_select_ms_is_the_phases_a_stamped_build():
    tr = _trace(_builds([(30.0, 70.0), (20.0, 60.0)]))
    assert build_select_ms.read(tr, None) == pytest.approx((30 + 70 + 20 + 60) / 1e3 / 2)


def test_a_program_without_the_phase_reports_nothing():
    spans = [s for s in _builds([(30.0, 70.0)]) if s.name != "build.select"]
    assert build_select_ms.read(_trace(spans), None) is None
    assert build_select_ms.read(_trace(None), None) is None
