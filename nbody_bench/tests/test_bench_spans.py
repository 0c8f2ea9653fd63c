"""The readers of the program's own spans and counters on hand-made traces:
``build_min_dist_ms``, ``build_lists_ms``, ``force_operands_ms``,
``near_pairs_per_step`` and ``render_idle_ms``, and what they give where
the program records no spans."""

from __future__ import annotations

import pytest

from nbody_bench.metrics import (_spans, build_lists_ms, build_min_dist_ms, force_operands_ms,
                                 near_pairs_per_step, render_idle_ms)
from nbody_bench.trace import Trace
from n_body_problem_tpu_torch.utils import profiling
from n_body_problem_tpu_torch.utils.profiling import COUNTERS, Span


def _ev(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _tree_spans() -> list:
    """Two builds, three steps on the first build's lists and one on the
    second's: min_dist 100 + 50 µs and 80 µs, lists 30 and 40 µs,
    operands 10, 12, 14, 16 µs; near pairs 1,000 then 2,000."""
    out, ids = [], iter(range(100))

    def add(name, parent, t0=None, t1=None, **counters):
        s = Span(next(ids), name, parent, 0, device_start=t0, device_end=t1,
                 counters=counters)
        out.append(s)
        return s

    run = add("sim.run", None)
    t = 0.0
    for near, dists, lists, steps in ((1000, (100, 50), 30, (10, 12, 14)),
                                      (2000, (80,), 40, (16,))):
        b = add("treecode.build", run.id, t, t + 1000)
        add("build.levels", b.id, t, t + 5)
        o = add("build.open", b.id, t + 5, t + 500)
        for d in dists:
            add("build.min_dist", o.id, t + 5, t + 5 + d)
        counts = dict.fromkeys(COUNTERS, 1)
        counts["near_pairs"] = near
        add("build.lists", b.id, t + 500, t + 500 + lists, **counts)
        for op in steps:
            st = add("treecode.step", run.id, t, t + 100)
            add("force.operands", st.id, t, t + op)
            add("update", st.id, t + 90, t + 100)
        t += 2000
    return out


def _trace(spans, events=(), frames=0) -> Trace:
    tr = Trace(list(events), wall_us=10_000.0)
    tr.frames = frames
    tr.program_spans = spans
    return tr


def test_phase_readers_divide_by_the_stamped_builds_and_steps():
    tr = _trace(_tree_spans())
    assert build_min_dist_ms.read(tr, None) == pytest.approx((100 + 50 + 80) / 1e3 / 2)
    assert build_lists_ms.read(tr, None) == pytest.approx((30 + 40) / 1e3 / 2)
    assert force_operands_ms.read(tr, None) == pytest.approx((10 + 12 + 14 + 16) / 1e3 / 4)


def test_near_pairs_weight_each_build_by_its_steps():
    tr = _trace(_tree_spans())
    assert near_pairs_per_step.read(tr, None) == pytest.approx((3 * 1000 + 2000) / 4)


def test_render_idle_is_the_gaps_inside_the_render_spans():
    # Device busy [0, 10], [30, 40], [70, 80]: gaps [10, 30] and [40, 70].
    events = [_ev("user_annotation", "sim.run", 0, 5)]
    events += [_ev("kernel", f"k{i}", a, 10) for i, a in enumerate((0, 30, 70))]
    spans = [Span(0, "sim.run", None, 0, host_start=0.0, host_end=5.0),
             Span(1, "render", None, 1, host_start=20.0, host_end=50.0),
             Span(2, "render.project", 1, 1, host_start=20.0, host_end=25.0),
             Span(3, "render", None, 3, host_start=60.0, host_end=65.0)]
    tr = _trace(spans, events, frames=2)
    # [20, 30] and [40, 50] of the first, [60, 65] of the second.
    assert render_idle_ms.read(tr, None) == pytest.approx((10 + 10 + 5) / 1e3 / 2)
    tr = _trace(spans, events[1:], frames=2)     # no sim.run label: no clock
    assert render_idle_ms.read(tr, None) is None


def test_a_program_without_spans_reports_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    tr = Trace([_ev("user_annotation", "sim.run", 0, 5)], wall_us=10.0)
    tr.frames = 1
    for reader in (build_min_dist_ms, build_lists_ms, force_operands_ms, near_pairs_per_step,
                   render_idle_ms):
        assert reader.read(tr, None) is None
    tr = _trace(None, frames=1)                  # a window with no spans
    assert all(r.read(tr, None) is None for r in (build_lists_ms, near_pairs_per_step))


def test_the_events_that_place_the_spans(monkeypatch):
    seen = []
    monkeypatch.setattr(profiling, "spans", lambda events=None: seen.append(events) or [])
    events = [_ev("user_annotation", "sim.run", 0, 50),
              _ev("cuda_runtime", "cudaGraphLaunch", 1, 1, corr=7),
              _ev("kernel", "(anonymous namespace)::span_stamp_kernel(long long*, ...)", 3, 2,
                  corr=7),
              _ev("kernel", "near_field_kernel", 5, 20, corr=7)]
    tr = Trace(events, wall_us=100.0)
    assert _spans.program_spans(tr) is None and len(seen) == 1
    names = sorted((e["cat"], e["name"][:17]) for e in seen[0])
    assert names == [("kernel", "(anonymous namesp"), ("user_annotation", "sim.run")]
    assert _spans.program_spans(tr) is None and len(seen) == 1   # read once a trace
