"""BENCHMARK.json against the benchmark's contract, the files it names, and
the harness's independence from JAX and the JAX package."""

from __future__ import annotations

import ast
import json
import pathlib
import re
import time

import pytest

from nbody_bench import harness, spec
from nbody_bench.tests import new_cells

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    named = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in (SOURCES_E2E if m in BENCH["end_to_end"] else SOURCES)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _line(w["why"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(BENCH["paths"][0] + "/")


def test_metrics_keys_bounds_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        reports = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", reports)) <= reports
    for w in cells:      # every cell: setup_s, another end-to-end metric, a per-layer one
        assert sum(w in m.get("workloads", cells) for m in BENCH["end_to_end"]) >= 2
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_file_is_found_by_name(workload):
    cell = spec.load(workload)
    assert cell.config["n"] > 0 and cell.traffic["loop"]
    assert hasattr(cell.loop.Loop, "call") and hasattr(cell.loop.Loop, "warm")
    assert set(cell.limits) >= {"force_p99", "dx_p90", "steps_gap"}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m["reader"].read), m["name"]
    conf = next(c for c in BENCH["configs"] if c["name"] == cell.name.split(".")[0])
    assert json.loads((ROOT / conf["file"]).read_text())["reduced"] == conf["reduced"]


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module)
    return out


SOURCES_PY = sorted(p for p in (ROOT / "nbody_bench").rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES_PY, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.FOREIGN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "nbody_bench" / "reference").rglob("*.py"):
        assert "n_body_problem_tpu_torch" not in {m.split(".")[0] for m in _imports(path)}


def test_foreign_modules_compare_whole_names(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "n_body_problem_tpu_torch_probe", object())
    assert harness.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "n_body_problem_tpu.ops", object())
    assert harness.foreign_modules() == ["n_body_problem_tpu.ops"]


@pytest.mark.parametrize("cell", ["tiny.short", *new_cells.CELLS])
def test_a_cell_a_mix_and_a_metric_are_added_by_files_alone(tmp_path, cell):
    """A configuration, traffic mix, cell, limits and per-layer metric, added
    as files and entries in a copy, run through the unchanged harness: a
    dummy cell, and those of ``new_cells`` (counts the program pads, two
    masses, the leapfrog; the batch and the live loop)."""
    new_cells.copy(tmp_path)
    if cell == "tiny.short":
        bench = json.loads(json.dumps(BENCH))
        (tmp_path / "nbody_bench/configs/tiny.json").write_text(json.dumps(
            dict(json.loads((ROOT / "nbody_bench/configs/plummer_65k.json").read_text()),
                 n=512, probe_bodies=512)))
        (tmp_path / "nbody_bench/traffic/short.json").write_text(json.dumps(
            {"solver": "auto", "settings": {}, "loop": "batch", "steps_per_call": 2,
             "judged_calls": 2, "traced_calls": 100}))
        (tmp_path / "nbody_bench/limits/tiny.short.json").write_text(
            json.dumps({"force_p99": 1e-4, "dx_p90": 1e-2, "steps_gap": 0}))
        bench["configs"].append({"name": "tiny", "source": "a test", "reduced": [],
                                 "file": "nbody_bench/configs/tiny.json", "why": "a test"})
        bench["workloads"].append({"name": "tiny.short", "config": "tiny", "traffic": "short",
                                   "chips": 1, "why": "a test"})
        next(m for m in bench["end_to_end"] if m["name"] == "ms_per_step")["workloads"].append(
            "tiny.short")
    else:
        new_cells.add(tmp_path, cell, steps_per_call=2)
        bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    (tmp_path / "nbody_bench/metrics/calls_per_s.py").write_text(
        "def read(trace, run):\n    return run.calls / run.window_s\n")
    bench["per_layer"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "entry and graphs",
                               "moves": "ms_per_step", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for trace in (False, True):
        out = harness.run_cell(cell, 7, 0.2, trace, root=tmp_path, device="cpu")
        assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0, out["checks"]
        assert list(out)[-1] == "checks"
        assert out["device"]["count"] == 1
        want = {"calls_per_s"} if trace else {"ms_per_step", "setup_s"}
        assert set(out["metrics"]) == want


def test_an_integrator_the_reference_does_not_follow_is_refused(tmp_path):
    new_cells.copy(tmp_path)
    path = tmp_path / "nbody_bench/configs/plummer_65k.json"
    config = json.loads(path.read_text())
    config["physics"]["integrator"] = "rk4"
    path.write_text(json.dumps(config))
    with pytest.raises(ValueError, match="rk4"):
        spec.load("plummer_65k.exact", tmp_path)


class _Counting:
    """A loop of ``steps``-step calls whose system counts ``taken`` a call."""

    def __init__(self, steps: int, taken: int):
        import torch

        self.steps, self.taken, self.count = steps, taken, 0
        self.zero = torch.zeros(4, 3)

    def call(self):
        from nbody_bench.snapshot import Call, Snapshot

        self.count += self.taken
        t = time.perf_counter()
        return Call(self.steps, t, t + 1e-3, Snapshot(self.zero, self.zero, self.zero,
                                                      step=self.count))


@pytest.mark.parametrize("horizon", [None, 30])
def test_judged_calls_stay_within_the_horizon(horizon):
    import numpy as np

    from nbody_bench.snapshot import Snapshot

    loop = _Counting(10, 10)
    run = harness.Run(spec.load("plummer_65k.exact"), 5)
    kept = harness.drive(loop, 0.05, Snapshot(loop.zero, loop.zero, loop.zero, step=0),
                         np.random.default_rng(5), run, judged_calls=2, horizon=horizon)
    ends = [c.snap.step for _, c in kept]
    assert run.steps == loop.count and run.calls > 3 and run.window_gap == 0
    assert ends[-1] == (loop.count if horizon is None else horizon)
    assert all(e <= (horizon or loop.count) for e in ends)


def test_the_window_counts_the_systems_steps():
    import numpy as np

    from nbody_bench.snapshot import Snapshot

    loop = _Counting(10, 9)
    run = harness.Run(spec.load("plummer_65k.exact"), 5)
    harness.drive(loop, 0.02, Snapshot(loop.zero, loop.zero, loop.zero, step=0),
                  np.random.default_rng(5), run, judged_calls=2)
    assert run.steps == 9 * run.calls and run.window_gap == run.calls
