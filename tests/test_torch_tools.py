"""The port's last tools against the JAX package's: ``tune_small_n`` (with
the five A/B runners as its modes), ``hier_census`` and ``dataset_sweep``,
on the CPU.

The JAX ``tools/tune_small_n.py``, ``tools/hier_census.py`` and
``validation/dataset_sweep.py`` are loaded from their files; the A/B runners
(``tools/ab_*.py``) run their benchmarks when imported, so their leg tables
are compared with literal copies of them.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import contextlib
import importlib.util
import io
import json
import math
import pathlib
import sys

import pytest

from n_body_problem_tpu_torch import bench, dataset_sweep, hier_census, tune_small_n

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_script(rel):
    """A JAX package script, loaded from its file (repo root on the path, as
    the scripts expect)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(f"_jax_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tune():
    return _jax_script("tools/tune_small_n.py")


def _stdout(fn, *a, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*a, **kw)
    return rc, [json.loads(line) for line in out.getvalue().splitlines()]


class Stub:
    """Stands for ``bench_config`` in both tools: a record made from the
    leg's arguments, ``vs_baseline`` given by N, and a log of every call."""

    def __init__(self, vs_by_n=None, fail=None):
        self.calls = []
        self.vs_by_n = vs_by_n or {}
        self.fail = fail

    def __call__(self, n, solver, steps, warmup=1, probe_error=None, windows=3, chunks=1,
                 **cfg_kw):
        cfg_kw.pop("device", None)
        self.calls.append((n, solver, steps, windows, chunks, sorted(cfg_kw.items())))
        if self.fail is not None and self.fail in cfg_kw:
            raise RuntimeError(f"stub: {self.fail} fails")
        pps = self.vs_by_n.get(n, 0.5) * bench.BASELINE
        ms = 1.0 + sum(len(k) % 7 for k in cfg_kw) / 10 + sum(
            v for v in cfg_kw.values() if isinstance(v, (int, float))) * 1e-3
        return {"solver": solver, "n": n, "n_padded": n, "steps_timed": steps * chunks,
                "ms_per_step": ms, "pairs_per_sec": pps, "padded_pairs_per_sec": pps,
                "probe_depth_steps": steps, "force_err_median": 1e-4,
                "force_err_p99": 1e-3}


def test_sweep_and_crossover_tables_equal_jax(jax_tune):
    assert tune_small_n.SWEEP == jax_tune.SWEEP
    assert tune_small_n.CROSSOVER_NS == jax_tune.CROSSOVER_NS == [20480, 32768, 49152, 65536]
    assert tune_small_n.SWEEP_N == jax_tune.SWEEP_N == 20480
    assert tune_small_n.MODE_STEPS["sweep"] == tune_small_n.MODE_STEPS["crossover"] == 256


@pytest.mark.parametrize("argv", [["--mode", "sweep"],
                                  ["--mode", "sweep", "--legs", "flat,default,vip0",
                                   "--steps", "64", "--sweep-n", "65536"],
                                  ["--mode", "crossover"],
                                  ["--mode", "crossover", "--n", "65536", "--steps", "64"]])
def test_protocol_matches_jax_line_for_line(jax_tune, monkeypatch, argv):
    """The same legs, in the same order, with the same arguments and
    records; the summary lines equal but for the card's name and limit."""
    vs = {20480: 0.3, 32768: 0.7, 49152: 1.2, 65536: 1.9}
    ours, theirs = Stub(vs), Stub(vs)
    monkeypatch.setattr(bench, "bench_config", ours)
    monkeypatch.setattr(jax_tune, "bench_config", theirs)
    rc, got = _stdout(tune_small_n.main, argv + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["tune_small_n.py", *argv])
    _, want = _stdout(jax_tune.main)
    assert rc == 0 and ours.calls == theirs.calls and ours.calls
    assert got[:-1] == want[:-1]
    summary = dict(got[-1])
    assert summary.pop("device") == "cpu" and summary.pop("power_limit") is None
    assert summary == want[-1]


# Literal copies of the A/B runners' legs (tools/ab_src.py, ab_union.py,
# ab_20k_r4.py, ab_20k_r4b.py, ab_bracket_r4.py): (N, steps, windows,
# chunks, overrides, the keys each runner adds to the record).
def _jax_ab_legs():
    from n_body_problem_tpu.config import tuned_tree_overrides

    base = tuned_tree_overrides(20480)
    r4 = [
        ("vip0", dict(base, tree_vip_tiles=0)),
        ("vip0_rebuild64", dict(base, tree_vip_tiles=0, tree_rebuild_every=64)),
        ("rebuild64", dict(base, tree_rebuild_every=64)),
        ("tile64_vip0", dict(base, tree_tile=64, tree_vip_tiles=0)),
        ("vip8", dict(base, tree_vip_tiles=8)),
    ]
    r4b = [("rowmerge_vip16_fixedprobe", dict(base))]
    bracket = [
        ("24k_tuned_fixedprobe", 24576, tuned_tree_overrides(24576)),
        ("32k_tuned_fixedprobe", 32768, tuned_tree_overrides(32768)),
    ]
    return {
        "ab-src": [(262144, 32, 3, 1, {"tree_src_tile": s}, {"src_tile": s}) for s in (64, 32)],
        "ab-union": [(262144, 32, 3, 1, {"tree_hier_union": u}, {"union": u})
                     for u in (True, False)],
        "r4": [(20480, 512, 1, 2, over, {"leg": tag, "overrides": over}) for tag, over in r4],
        "r4b": [(20480, 1024, 1, 1, over, {"leg": tag, "overrides": over})
                for tag, over in r4b],
        "bracket": [(n, 1024, 1, 1, over, {"leg": tag, "overrides": over})
                    for tag, n, over in bracket],
    }


@pytest.mark.parametrize("mode", ["ab-src", "ab-union", "r4", "r4b", "bracket"])
def test_ab_modes_run_the_jax_runners_legs(monkeypatch, mode):
    stub = Stub()
    monkeypatch.setattr(bench, "bench_config", stub)
    rc, lines = _stdout(tune_small_n.main, ["--mode", mode, "--device", "cpu"])
    legs = _jax_ab_legs()[mode]
    assert rc == 0 and len(lines) == len(legs) + 1
    for (n, steps, windows, chunks, over, added), call, rec in zip(legs, stub.calls, lines):
        assert call == (n, "treecode", steps, windows, chunks, sorted(over.items()))
        for key, value in added.items():
            assert rec[key] == value, key
        assert rec["vs_baseline"] == rec["pairs_per_sec"] / bench.BASELINE
    assert lines[-1]["summary"] == mode and lines[-1]["device"] == "cpu"


def _jax_crossover(done):
    """The JAX tool's interpolation (tools/tune_small_n.py:120-127), verbatim."""
    cross = None
    for a, b in zip(done, done[1:]):
        va, vb = a["vs_baseline"], b["vs_baseline"]
        if va < 1.0 <= vb:
            la, lb = math.log(a["n"]), math.log(b["n"])
            cross = math.exp(la + (lb - la) * (1.0 - va) / (vb - va))
            break
    return cross


@pytest.mark.parametrize("vs", [(0.3, 0.7, 1.2, 1.9), (0.3, 0.5, 0.7, 0.9), (1.1, 1.5, 2.0, 3.0),
                                (0.2, 1.0, 0.8, 1.4), (0.9, 1.3, 0.7, 1.6), (0.999,)])
def test_crossover_n_is_the_jax_formula(vs):
    records = [{"n": n, "vs_baseline": v} for n, v in zip(tune_small_n.CROSSOVER_NS, vs)]
    assert tune_small_n.crossover_n(records) == _jax_crossover(records)
    if vs == (0.3, 0.7, 1.2, 1.9):
        assert 32768 < tune_small_n.crossover_n(records) < 49152
    if max(vs) < 1.0 or min(vs) >= 1.0:
        assert tune_small_n.crossover_n(records) is None


def test_sweep_leg_runs_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "tune.jsonl"
    assert tune_small_n.main(["--device", "cpu", "--sweep-n", "2048", "--legs", "default",
                              "--steps", "2", "--out", str(out)]) == 0
    rec, summary = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert list(rec) == ["solver", "n", "n_padded", "steps_timed", "ms_per_step",
                         "pairs_per_sec", "padded_pairs_per_sec", "probe_depth_steps",
                         "force_err_median", "force_err_p99", "leg", "vs_baseline"]
    assert rec["leg"] == "default" and rec["n"] == 2048 and rec["steps_timed"] == 2
    assert rec["vs_baseline"] == rec["pairs_per_sec"] / bench.BASELINE
    assert math.isfinite(rec["ms_per_step"]) and rec["force_err_p99"] < 2.5e-3
    assert summary["best_leg"] == "default" and summary["device"] == "cpu"
    assert [json.loads(line) for line in out.read_text().splitlines()] == [rec, summary]


def test_failed_leg_fails_the_run_and_the_others_print(monkeypatch, capsys):
    monkeypatch.setattr(bench, "bench_config", Stub(fail="tree_hier"))
    assert tune_small_n.main(["--device", "cpu", "--legs", "default,flat,rebuild32"]) == 1
    captured = capsys.readouterr()
    lines = [json.loads(line) for line in captured.out.splitlines()]
    assert [r.get("leg") for r in lines[:-1]] == ["default", "rebuild32"]
    assert lines[-1]["summary"] == "sweep"
    assert "tune: leg flat failed" in captured.err and "1 failed: flat" in captured.err


def test_unknown_leg_is_an_error(capsys):
    with pytest.raises(SystemExit):
        tune_small_n.main(["--device", "cpu", "--legs", "default,nosuch"])
    assert "nosuch" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["tune_small_n_20260818.jsonl", "tune_small_n_20260819.jsonl",
                                  "tune_small_n_20990101.jsonl"])
def test_jax_tune_records_are_refused(name, capsys):
    path = ROOT / "validation" / name
    before = path.read_bytes() if path.exists() else None
    assert tune_small_n.main(["--device", "cpu", "--out", str(path)]) == 2
    assert "JAX package record" in capsys.readouterr().err
    assert (path.read_bytes() if path.exists() else None) == before


def test_jax_dataset_record_is_refused(capsys):
    path = ROOT / "validation" / "dataset_sweep.json"
    before = path.read_bytes()
    assert dataset_sweep.main(["--device", "cpu", "--out", str(path)]) == 2
    assert "JAX package's record" in capsys.readouterr().err
    assert path.read_bytes() == before


def test_hier_census_equals_jax_at_8192(capsys):
    jax_census = _jax_script("tools/hier_census.py")
    jax_census.census(8192)
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    got = hier_census.census(8192, device="cpu")
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert got == printed == want
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [r["union_coarse"] for r in got] == [False, True]


def test_dataset_sweep_matches_jax(tmp_path, monkeypatch, capsys):
    """Two small fallback specs and one missing file, in both packages'
    registries: the same statuses, body counts and finiteness."""
    from n_body_problem_tpu.io import datasets as jax_datasets

    from n_body_problem_tpu_torch.io import datasets

    for mod in (datasets, jax_datasets):
        spec = mod.DatasetSpec
        monkeypatch.setattr(mod, "DATASETS", {
            0: spec("absent", "absent.bin", "tipsy", (1, 1, 1)),
            1: spec("small_plummer", "small.tab", "tab", (1, 1, 1),
                    fallback_model="plummer", fallback_n=300),
            2: spec("small_disk", "disk.tab", "tab", (1, 1, 1),
                    fallback_model="disk_galaxy", fallback_n=255),
        })
    argv = ["--data-dir", str(tmp_path), "--steps", "2"]
    assert dataset_sweep.main(argv + ["--out", str(tmp_path / "ours.json"),
                                      "--device", "cpu"]) == 0
    monkeypatch.setattr(sys, "argv", ["dataset_sweep.py", *argv,
                                      "--out", str(tmp_path / "theirs.json")])
    _jax_script("validation/dataset_sweep.py").main()
    ours = json.loads((tmp_path / "ours.json").read_text())
    theirs = json.loads((tmp_path / "theirs.json").read_text())
    assert (ours["backend"], ours["device"], ours["power_limit"]) == ("cpu", "cpu", None)
    assert len(ours["results"]) == len(theirs["results"]) == 3
    for a, b in zip(ours["results"], theirs["results"]):
        assert list(a) == list(b)
        for key in ("dataset", "name", "status", "n_real", "n_padded", "steps", "finite",
                    "fallback_model"):
            assert a.get(key) == b.get(key), key
    assert [r["status"] for r in ours["results"]][1:] == ["ok", "ok"]
    assert ours["results"][0]["status"].startswith("missing: dataset 0 (absent)")
