"""The port's bench harness against the JAX package's root ``bench.py``.

The protocol (legs, flush order, probe order, record keys) is compared with
both harnesses' timing functions replaced by one stub; the record itself by
``time_config`` at a small treecode size on the CPU, with the capacities
pinned as ``__graft_entry__.py:164-169`` pins them so that both packages
take the hierarchical path.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest

from n_body_problem_tpu_torch import bench

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _root_module(name):
    """The JAX package's root script ``name``.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"_jax_root_{name}", ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_bench = _root_module("bench")


class Stub:
    """Stands for ``time_config`` and ``bench_config`` in both harnesses:
    fixed records made from the leg's arguments, and a log of every timing
    and probe in the order they ran."""

    def __init__(self, fail_n=None):
        self.events = []
        self.fail_n = fail_n

    def time_config(self, n, solver, steps, warmup=1, probe_error=None, windows=3,
                    chunks=1, **cfg_kw):
        cfg_kw.pop("device", None)
        self.events.append(("time", n, solver, steps, windows, chunks,
                            tuple(sorted(cfg_kw.items()))))
        if n == self.fail_n:
            raise RuntimeError(f"stub: leg at n={n} fails")
        total = steps * chunks
        seconds = 1e-6 * n + 1e-3 * total
        rec = {"solver": solver, "n": n, "n_padded": n, "steps_timed": total,
               "ms_per_step": seconds / total * 1e3,
               "pairs_per_sec": n * (n - 1) * total / seconds,
               "padded_pairs_per_sec": n * n * total / seconds}

        def probe():
            self.events.append(("probe", n))
            rec["probe_depth_steps"] = steps * warmup
            rec["force_err_median"] = 1e-4 + n * 1e-12
            rec["force_err_p99"] = 1e-3 + n * 1e-11
            return rec

        return rec, (probe if solver == "treecode" else None)

    def bench_render(self, n, solver, device=None):
        self.events.append(("render", n, solver))
        return 12.5

    def bench_config(self, n, solver, steps, warmup=1, probe_error=None, windows=3,
                     chunks=1, **cfg_kw):
        rec, probe = self.time_config(n, solver, steps, warmup, probe_error, windows,
                                      chunks, **cfg_kw)
        if probe is not None:
            probe()
        return rec


def _run_port(monkeypatch, capsys, stub, argv):
    monkeypatch.setattr(bench, "time_config", stub.time_config)
    monkeypatch.setattr(bench, "bench_config", stub.bench_config)
    monkeypatch.setattr(bench, "bench_render", stub.bench_render)
    rc = bench.main(argv)
    out = capsys.readouterr()
    return rc, [json.loads(line) for line in out.out.splitlines()], out.err


def _run_jax(monkeypatch, capsys, stub, argv):
    monkeypatch.setattr(jax_bench, "time_config", stub.time_config)
    monkeypatch.setattr(jax_bench, "bench_config", stub.bench_config)
    monkeypatch.setattr(jax_bench, "bench_render", stub.bench_render)
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    jax_bench.main()
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("full", [False, True])
def test_protocol_matches_jax_line_for_line(monkeypatch, capsys, full):
    argv = ["--full"] if full else []
    port, jax = Stub(), Stub()
    rc, lines, err = _run_port(monkeypatch, capsys, port, argv + ["--device", "cpu"])
    jax_lines = _run_jax(monkeypatch, capsys, jax, argv)
    assert rc == 0
    # the same legs with the same arguments, timings and probes in the same order
    assert port.events == jax.events
    timed = [e for e in port.events if e[0] == "time"]
    legs = 12 if full else 4
    assert len(timed) == legs + (2 if full else 0)
    # the step+render leg last, at 65,536 on the exact symmetric solver
    assert [e for e in port.events if e[0] == "render"] == (
        [("render", 65536, "pallas_symmetric")] if full else [])
    assert port.events[-1][0] == ("render" if full else "probe")
    assert [e[1] for e in timed[:4]] == [524288, 1048576, 20480, 65536]
    # every treecode timing before any probe, the probes cheapest first
    probes = [e[1] for e in port.events if e[0] == "probe"]
    first_probe = next(i for i, e in enumerate(port.events) if e[0] == "probe")
    assert all(e[0] == "time" for e in port.events[:legs])
    assert first_probe == legs
    assert probes[:legs] == sorted(probes[:legs])
    # one line after each leg, one after each probe, one at the end
    assert len(lines) == len(jax_lines) == 2 * legs + 1
    for i, (ours, theirs) in enumerate(zip(lines, jax_lines)):
        assert ours.pop("backend") == "cpu" and ours.pop("device") == "cpu", i
        theirs.pop("backend")
        assert list(ours) == list(theirs), i
        assert ours == theirs, i
    assert lines[-1]["legs_done"] == legs and lines[0]["legs_done"] == 1
    assert ("ms_per_step_with_render_65k" in lines[-1]) == full
    assert all("ms_per_step_with_render_65k" not in line for line in lines[:-1])
    assert "failed" not in err


def test_failed_leg_flushes_the_others_and_fails_the_run(monkeypatch, capsys):
    stub = Stub(fail_n=1048576)
    rc, lines, err = _run_port(monkeypatch, capsys, stub, ["--device", "cpu"])
    assert rc == 1
    assert "leg sustained_1m failed" in err and "stub: leg at n=1048576 fails" in err
    # three legs flushed, three probes, the final line
    assert len(lines) == 7
    assert lines[-1]["legs_done"] == 3 and lines[-1]["legs_total"] == 4
    assert "tree_ms_per_step_sustained_1m" not in lines[-1]
    assert [e[1] for e in stub.events if e[0] == "probe"] == [20480, 65536, 524288]


def test_failed_probe_fails_the_run(monkeypatch, capsys):
    stub = Stub()
    real = stub.time_config

    def time_config(n, solver, steps, **kw):
        rec, probe = real(n, solver, steps, **kw)
        if n == 20480:
            def probe():
                raise FloatingPointError("stub: probe fails")
        return rec, probe

    monkeypatch.setattr(stub, "time_config", time_config)
    rc, lines, err = _run_port(monkeypatch, capsys, stub, ["--device", "cpu"])
    assert rc == 1 and "probe sustained_20k failed" in err
    assert len(lines) == 4 + 3 + 1
    assert lines[-1]["tree_force_err_p99_sustained_20k"] is None
    assert lines[-1]["tree_force_err_p99_sustained_65k"] is not None


def test_every_leg_failing_prints_no_record(monkeypatch, capsys):
    class AllFail(Stub):
        def time_config(self, *a, **kw):
            raise RuntimeError("stub: all fail")

    rc, lines, err = _run_port(monkeypatch, capsys, AllFail(), ["--device", "cpu"])
    assert rc == 1 and lines == [] and "every treecode leg failed" in err


def test_suite_without_a_gpu_names_the_cpu_device(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bench.main([])


# The hierarchical path on the CPU: both capacities pinned
# (__graft_entry__.py:164-169 at N = 4,096).
N = 4096
PINNED = dict(tree_vip_tiles=8, tree_rebuild_every=4, tree_src_tile=64,
              tree_max_near=64, tree_hier=True, tree_tile=128,
              tree_flat_cap=(N // 128) * 64 * 8, tree_far_cap=(N // 128) * 64 * 8)


@pytest.mark.parametrize("case", ["pinned", "clamped"])
def test_time_config_record_matches_jax(case):
    """The record's integers exactly, its errors within rtol 1e-2.

    "pinned" is inside the treecode envelope. There the median body's
    error is f32 rounding, not the tree's approximation: against a float64
    oracle both packages' medians read 1.1e-7 (p99 7.27e-5 in both), but
    the JAX oracle on the CPU (one f32 sum over N) is itself 8.3e-7 from
    float64 at its median, the port's 1.0e-7. So that median is held to
    the JAX oracle's own f32 error, 1e-6, not to rtol 1e-2. "clamped" (32-
    body source tiles, at most 16 near tiles a row) makes the far field's
    error dominate every body, and there the median is held to rtol 1e-2.
    """
    kw = dict(steps=4, windows=1, **PINNED)
    if case == "clamped":
        kw.update(tree_src_tile=32, tree_max_near=16)
    ours, probe = bench.time_config(N, "treecode", device="cpu", **kw)
    theirs, jax_probe = jax_bench.time_config(N, "treecode", **kw)
    assert probe is not None and jax_probe is not None
    assert probe() is ours and jax_probe() is theirs
    assert list(ours) == list(theirs)
    for key in ("solver", "n", "n_padded", "steps_timed", "probe_depth_steps"):
        assert ours[key] == theirs[key], key
    seconds = ours["steps_timed"] * ours["ms_per_step"] / 1e3
    assert ours["pairs_per_sec"] * seconds / ours["steps_timed"] == pytest.approx(N * (N - 1))
    assert ours["padded_pairs_per_sec"] * seconds / ours["steps_timed"] == pytest.approx(N * N)
    # rtol 1e-2: the same sampled rows of the same state, f32 sums in
    # another order in each package
    assert ours["force_err_p99"] == pytest.approx(theirs["force_err_p99"], rel=1e-2)
    if case == "pinned":
        assert ours["force_err_median"] == pytest.approx(theirs["force_err_median"], abs=1e-6)
        assert ours["force_err_p99"] < 2.5e-3 and ours["force_err_median"] < 5e-4
    else:
        assert ours["force_err_median"] == pytest.approx(theirs["force_err_median"], rel=1e-2)
        assert ours["force_err_median"] > 1e-4   # the far field's, not rounding


def test_exact_leg_has_no_probe():
    rec, probe = bench.time_config(256, "direct", 2, windows=1, device="cpu")
    assert probe is None and "force_err_p99" not in rec and rec["n_padded"] == 256


def test_run_single_defaults_match_jax(monkeypatch, capsys):
    calls = {}

    def fake(name):
        def bench_config(n, solver, steps, chunks=1, windows=3, **kw):
            calls[name] = (n, solver, steps, chunks, windows)
            return {"pairs_per_sec": 2.6e11, "n": n}
        return bench_config

    monkeypatch.setattr(bench, "bench_config", fake("port"))
    monkeypatch.setattr(jax_bench, "bench_config", fake("jax"))
    for n, solver, steps in ((0, "", 0), (262144, "treecode", 0), (4096, "direct", 5)):
        ours = bench.run_single(n, solver, steps, device="cpu")
        theirs = jax_bench.run_single(n, solver, steps)
        assert calls["port"] == calls["jax"]
        assert ours.pop("device") == "cpu" and ours.pop("backend") == "cpu"
        theirs.pop("backend")
        assert ours == theirs
    assert calls["port"] == (4096, "direct", 5, 1, 3)
    capsys.readouterr()
    bench.run_single(0, "", 0, device="cpu")
    assert calls["port"] == (65536, "pallas_symmetric", 16, 1, 3)
    bench.run_single(262144, "", 0, device="cpu")
    assert calls["port"][2] == 8


def test_single_config_mode_prints_one_line(capsys):
    assert bench.main(["--n", "256", "--solver", "direct", "--steps", "2",
                       "--windows", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["backend"] == "cpu" and rec["n"] == 256 and rec["steps_timed"] == 2
    assert rec["metric"] == "pairwise interactions/sec/chip (direct, N=256)"
    assert rec["vs_baseline"] == pytest.approx(rec["pairs_per_sec"] / bench.BASELINE)
    assert bench.BASELINE == jax_bench.BASELINE


def test_bench_render_times_a_movie_step():
    """The step+render leg itself on the CPU at a small N: a warm and a
    timed 10-step movie at 1024x1024; its ms/step is finite."""
    ms = bench.bench_render(256, "direct", device="cpu")
    assert np.isfinite(ms) and ms > 0
