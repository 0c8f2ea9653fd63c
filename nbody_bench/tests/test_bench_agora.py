"""The AGORA cell (``agora_disk.tree``) on the CPU at 2,048 bodies with
10-step calls, under its own limits: a sound run is correct, a run whose
calls leave out their closing half-kick is not (``test_bench_faults.py``
plants that fault in the leapfrog cells of ``new_cells`` alone). And the
readers of the resort's span and counter, ``resort_ms`` and
``tied_bodies``, on hand-made traces and on a program without them."""

from __future__ import annotations

import json

import pytest

from nbody_bench import harness
from nbody_bench.metrics import resort_ms, tied_bodies
from nbody_bench.tests import new_cells
from nbody_bench.tests.test_bench_faults import HalfKickLeftOut
from nbody_bench.trace import Trace
from n_body_problem_tpu_torch.utils.profiling import Span

N, STEPS = 2048, 10


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    new_cells.copy(tmp)
    p = tmp / "nbody_bench/configs/agora_disk.json"
    p.write_text(json.dumps(dict(json.loads(p.read_text()), n=N, probe_bodies=N)))
    p = tmp / "nbody_bench/traffic/tree.json"
    p.write_text(json.dumps(dict(json.loads(p.read_text()), steps_per_call=STEPS)))
    return tmp


def test_a_sound_run_is_correct(root):
    out = harness.run_cell("agora_disk.tree", 11, 0.5, False, root=root, device="cpu")
    assert out["correct"], out["checks"]


def test_a_closing_half_kick_left_out_is_not_correct(root):
    out = harness.run_cell("agora_disk.tree", 11, 0.5, False, root=root, device="cpu",
                           system_cls=HalfKickLeftOut)
    assert not out["correct"] and out["failed"] == out["attempted"] >= 1, out["checks"]
    assert out["checks"]["dv_lag"]["value"] > 0.4, out["checks"]


def _trace(spans) -> Trace:
    tr = Trace([], wall_us=10_000.0)
    tr.program_spans = spans
    return tr


def _resorts(tied):
    """Resorts of 400 and 600 µs, their ``resort.order`` 100 and 140 µs,
    the last counting ``tied`` bodies."""
    out = [Span(0, "sim.run", None, 0)]
    for i, (t, order, counters) in enumerate(((0.0, 100.0, {"tied_bodies": 5}),
                                              (1000.0, 140.0, tied))):
        r = Span(1 + 2 * i, "treecode.resort", 0, 0, device_start=t, device_end=t + 400 + 200 * i)
        out += [r, Span(2 + 2 * i, "resort.order", r.id, 0, device_start=t + 10,
                        device_end=t + 10 + order, counters=counters)]
    return out


def test_the_resort_readers():
    tr = _trace(_resorts({"tied_bodies": 1234}))
    assert resort_ms.read(tr, None) == pytest.approx((100 + 140) / 1e3 / 2)
    assert tied_bodies.read(tr, None) == 1234.0
    assert tied_bodies.read(_trace(_resorts({})), None) == 0.0   # no tie: an all-zero record


def test_a_program_without_the_resort_phase_reports_nothing():
    """The parent's resort holds no stamp: its spans have no device times."""
    spans = [Span(0, "sim.run", None, 0), Span(1, "treecode.resort", 0, 0)]
    for tr in (_trace(spans), _trace(None)):
        assert resort_ms.read(tr, None) is None and tied_bodies.read(tr, None) is None
