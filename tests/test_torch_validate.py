"""The port's physics validation against the JAX package's root
``validate.py``, on the CPU with plain solvers."""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import argparse
import contextlib
import importlib.util
import io
import json
import pathlib
import sys

import numpy as np
import pytest

from n_body_problem_tpu_torch import models, validate

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _root_module(name):
    """The JAX package's root script ``name``.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"_jax_root_{name}", ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_validate = _root_module("validate")


def _last_json(fn, *a):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*a)
    lines = out.getvalue().splitlines()
    assert len(lines) == 1   # one JSON report, nothing else on stdout
    return json.loads(lines[0])


@pytest.mark.parametrize("integrator", ["leapfrog", "semi_implicit_euler"])
def test_f64_oracle_is_the_jax_one_bitwise(integrator):
    s = models.plummer(64, seed=3)
    args = (s.pos.numpy(), s.vel.numpy(), s.mass.numpy())
    kw = dict(dt=0.008, steps=5, eps2=1e-6, compensate=0.1, integrator=integrator)
    for ours, theirs in zip(validate._numpy_f64_trajectory(*args, **kw),
                            jax_validate._numpy_f64_trajectory(*args, **kw)):
        assert ours.dtype == theirs.dtype == np.float64
        np.testing.assert_array_equal(ours, theirs)


def _f64_drifts(n, integrator, steps, check_every, dt=0.008, eps2=1e-6, c=0.1):
    """(E(step) - E0) / |E0| of the float64 oracle's trajectory."""
    s = models.plummer(n, seed=0)
    p0, v0, m = (x.numpy().astype(np.float64) for x in (s.pos, s.vel, s.mass))

    def energy(p, v):
        d = p[None] - p[:, None]
        phi = c * m[:, None] * m[None, :] * (c * c * (d * d).sum(-1) + eps2) ** -0.5
        np.fill_diagonal(phi, 0.0)
        return 0.5 * (m * (v * v).sum(1)).sum() - 0.5 * phi.sum()

    e0 = energy(p0, v0)
    out = []
    for k in range(check_every, steps + 1, check_every):
        p, v = validate._numpy_f64_trajectory(p0, v0, m, dt=dt, steps=k, eps2=eps2,
                                              compensate=c, integrator=integrator)
        out.append((energy(p, v) - e0) / abs(e0))
    return out


@pytest.mark.parametrize("solver, integrator", [("direct", "leapfrog"),
                                                ("direct", "semi_implicit_euler"),
                                                ("mxu", "leapfrog")])
def test_long_run_report_matches_jax(monkeypatch, solver, integrator):
    argv = ["--n", "256", "--steps", "20", "--check-every", "10", "--solver", solver,
            "--integrator", integrator]
    ours = _last_json(validate.main, argv + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["validate.py", *argv])
    theirs = _last_json(jax_validate.main)
    # the JAX report's keys in its order, and the card's name and power limit
    assert [k for k in ours if k not in ("device", "power_limit")] == list(theirs)
    assert ours["backend"] == ours["device"] == "cpu" and ours["power_limit"] is None
    for key in ("metric", "unit", "steps", "n", "solver", "integrator", "dt"):
        assert ours[key] == theirs[key], key
    assert [list(h) for h in ours["history"]] == [list(h) for h in theirs["history"]]
    f64 = _f64_drifts(256, integrator, 20, 10)
    for h_ours, h_theirs, drift64 in zip(ours["history"], theirs["history"], f64, strict=True):
        assert h_ours["step"] == h_theirs["step"]
        assert h_ours["overspeed"] == h_theirs["overspeed"] == 0
        assert h_ours["energy"] == pytest.approx(h_theirs["energy"], rel=1e-5)
        # A drift of 1e-6 to 1e-4 is a difference of two f32 energy sums,
        # each rounded at about 1e-7 of |E|: rtol 1e-5 on the energies
        # allows 2e-5 on (E - E0) / |E0|. Both packages' drifts sit within
        # 1e-6 of the float64 oracle's (measured: port <= 1.5e-7, JAX
        # <= 5.5e-7 off it at n = 256), so that is what they are held to.
        assert h_ours["rel_energy_drift"] == pytest.approx(h_theirs["rel_energy_drift"],
                                                           abs=2e-5)
        assert h_ours["rel_energy_drift"] == pytest.approx(drift64, abs=1e-6)
        assert h_theirs["rel_energy_drift"] == pytest.approx(drift64, abs=1e-6)
        assert h_ours["momentum_err"] < 1e-6 and h_ours["angmom_err"] < 1e-6
    assert ours["max_abs_drift"] == max(abs(h["rel_energy_drift"]) for h in ours["history"])


def test_long_run_on_a_dataset(tmp_path, capsys):
    from n_body_problem_tpu_torch.io import write_tipsy

    s = models.disk_galaxy(255, seed=2)
    write_tipsy(tmp_path / "galaxy_20K.bin", s.pos.numpy(), s.vel.numpy(), s.mass.numpy(),
                n_dark=16)
    assert validate.main(["--dataset", "0", "--data-dir", str(tmp_path), "--steps", "4",
                          "--check-every", "2", "--solver", "direct",
                          "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert report["n"] == 256 and [h["step"] for h in report["history"]] == [2, 4]


def test_card_reads_name_and_power_limit(monkeypatch):
    """A long-run record names the card and its power limit: the name from
    ``torch.cuda``, the limit from the ``nvidia-smi`` query of that card."""
    import subprocess

    import torch

    from n_body_problem_tpu_torch import bench

    calls = []

    def smi(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")

    monkeypatch.setattr(subprocess, "run", smi)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "NVIDIA H100 80GB HBM3")
    assert bench.card(torch.device("cuda", 1)) == {"device": "NVIDIA H100 80GB HBM3",
                                                  "power_limit": "700.00 W"}
    assert calls == [["nvidia-smi", "--id=1", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]]
    assert bench.card(torch.device("cpu")) == {"device": "cpu", "power_limit": None}


def test_convergence_matches_jax():
    ns = argparse.Namespace(n=256, solver="direct")
    ours = _last_json(validate.run_convergence, argparse.Namespace(device="cpu", **vars(ns)))
    theirs = _last_json(jax_validate.run_convergence, ns)
    assert list(ours) == list(theirs)
    assert list(ours["oracle_f64"]) == list(theirs["oracle_f64"])
    for integrator in ("semi_implicit_euler", "leapfrog"):
        a, b = ours["scaling"][integrator], theirs["scaling"][integrator]
        assert a["dts"] == b["dts"]
        assert a["fitted_order"] == pytest.approx(b["fitted_order"], abs=0.1), integrator
    # the integrators' formal orders, and the f32 run on the float64 oracle
    assert ours["scaling"]["leapfrog"]["fitted_order"] > 1.8
    assert ours["oracle_f64"]["pos_delta_p99"] < 1e-5


def test_validate_without_a_gpu_names_the_cpu_device(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        validate.main(["--n", "64", "--steps", "1", "--check-every", "1"])
