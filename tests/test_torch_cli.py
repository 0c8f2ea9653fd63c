"""The port's CLI, and the port's independence from JAX."""

import pathlib
import subprocess
import sys

import numpy as np

from n_body_problem_tpu.io.checkpoint import load_checkpoint as jax_load
from n_body_problem_tpu_torch.cli import main

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "n_body_problem_tpu_torch"


def test_run_writes_checkpoint_jax_reads(tmp_path, capsys):
    rc = main(["run", "--model", "plummer", "--n", "256", "--steps", "10",
               "--steps-per-block", "5", "--diag-every", "5",
               "--checkpoint-every", "5", "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    err = capsys.readouterr().err
    assert "n=256 (padded 256)" in err and "[step 10]" in err and "done: 10 steps" in err
    assert (tmp_path / "ck_00000005.npz").exists()
    state, cfg = jax_load(tmp_path / "final.npz")
    assert int(state.step) == 10 and state.n_real == 256
    assert np.isfinite(np.asarray(state.pos)).all()
    assert cfg.solver == "auto"


def test_resume_continues_steps(tmp_path):
    assert main(["run", "--model", "plummer", "--n", "64", "--steps", "4",
                 "--solver", "direct", "--out", str(tmp_path / "a")]) == 0
    assert main(["run", "--resume", str(tmp_path / "a" / "final.npz"), "--steps", "3",
                 "--out", str(tmp_path / "b")]) == 0
    state, cfg = jax_load(tmp_path / "b" / "final.npz")
    assert int(state.step) == 7 and cfg.solver == "direct"


def test_unported_flags_name_the_roadmap(tmp_path, capsys):
    for extra in (["--render-every", "10"], ["--devices", "2"], ["--tree-tuned"],
                  ["--dataset", "0"], ["--gif"], ["--serve", "8000"]):
        rc = main(["run", "--model", "plummer", "--n", "64", "--steps", "1",
                   "--out", str(tmp_path), *extra])
        assert rc == 2, extra
        assert "ROADMAP" in capsys.readouterr().err, extra


def test_info(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "solvers:" in out and "pallas_symmetric" in out and "symmetric.cu" in out


def test_import_leaves_jax_out():
    """In a fresh process (this one has JAX loaded by tests/conftest.py)."""
    code = ("import sys, n_body_problem_tpu_torch, n_body_problem_tpu_torch.cli; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'n_body_problem_tpu.'))"
            " or m == 'n_body_problem_tpu']; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_package_sources_never_import_jax():
    for path in PACKAGE.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "jaxlib", "n_body_problem_tpu"), (
                    f"{path}: {line}")
