"""The port's four examples (``n_body_problem_tpu_torch.examples``): each
``main`` on the CPU at a small size, against the port's own
``Simulation`` where the example's numbers can be checked."""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import re

import numpy as np
import pytest

from n_body_problem_tpu_torch import SimConfig, Simulation, models
from n_body_problem_tpu_torch.examples import (galaxy_collision_movie, multichip_ring,
                                               quickstart, treecode_large_n)

_E = re.compile(r"\bE=(\S+)")


def _energies(text):
    return [float(e) for e in _E.findall(text)]


def test_quickstart(capsys):
    assert quickstart.main(["--device", "cpu", "--n", "512", "--blocks", "2",
                            "--steps", "5"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("N=512  E0=") and lines[0].endswith("solver=auto")
    assert [line.split()[1] for line in lines[1:3]] == ["5", "10"]
    assert lines[-1].startswith("wall: ")
    sim = Simulation(SimConfig(dt=0.008), models.plummer(512, seed=0), device="cpu")
    sim.run(10)
    energies = _energies("\n".join(lines))
    assert np.isfinite(energies).all() and len(energies) == 2
    assert energies[-1] == pytest.approx(sim.diagnostics()["energy"], rel=1e-6)


def test_galaxy_collision_movie_writes_a_gif(tmp_path, capsys):
    assert galaxy_collision_movie.main([str(tmp_path), "--device", "cpu", "--n", "512",
                                        "--blocks", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["step 100: 20 frames", f"wrote {tmp_path / 'movie.gif'} (20 frames)"]
    assert len(list((tmp_path / "frames").glob("*.png"))) == 20
    assert (tmp_path / "movie.gif").read_bytes()[:6] == b"GIF89a"


def test_multichip_ring_in_a_gloo_world_of_two(capsys):
    assert multichip_ring.main(["--device", "cpu", "--devices", "2", "--n", "256",
                                "--blocks", "2", "--steps", "5"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "mesh: 2 devices, strategy=half_ring (Newton's 3rd law across chips)"
    assert [line.split()[1] for line in lines[1:]] == ["5", "10"]
    assert all(line.endswith("overspeed=0") for line in lines[1:])
    sim = Simulation(SimConfig(solver="direct", integrator="leapfrog", dt=0.005),
                     models.plummer(256, seed=0), device="cpu")
    want = []
    for _ in range(2):
        sim.run(5)
        want.append(sim.diagnostics()["energy"])
    # the sharded state within the ring tests' rtol of the single device's
    np.testing.assert_allclose(_energies("\n".join(lines)), want, rtol=1e-5)


def test_treecode_large_n(capsys):
    assert treecode_large_n.main(["--device", "cpu", "--n", "2048", "--steps", "2"]) == 0
    head, tail = capsys.readouterr().out.splitlines()
    assert head.startswith("n=2048  mac_tau=0.0002  near capacity=")
    ms, drift = re.search(r"^(\S+) ms/step .* dE/E=(\S+)  overspeed=0$", tail).groups()
    assert float(ms) > 0 and abs(float(drift)) < 1e-3
