"""The port's CLI, and the port's independence from JAX."""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import pathlib
import subprocess
import sys

import numpy as np
import pytest

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
                 "--solver", "direct", "--device", "cpu", "--out", str(tmp_path / "a")]) == 0
    assert main(["run", "--resume", str(tmp_path / "a" / "final.npz"), "--steps", "3",
                 "--device", "cpu", "--out", str(tmp_path / "b")]) == 0
    state, cfg = jax_load(tmp_path / "b" / "final.npz")
    assert int(state.step) == 7 and cfg.solver == "direct"


def test_unported_flags_name_the_roadmap(tmp_path, capsys):
    """Every strategy is ported; ``--strategy treecode_staged`` below the flat
    machinery's 2,048 bodies exits 2 with the JAX package's message."""
    rc = main(["run", "--model", "plummer", "--n", "64", "--steps", "1", "--device", "cpu",
               "--out", str(tmp_path), "--devices", "2", "--strategy", "treecode_staged"])
    assert rc == 2
    assert "treecode_staged needs the flat-list machinery" in capsys.readouterr().err
    assert not (tmp_path / "final.npz").exists()


def test_run_devices_shards_over_gloo_ranks(tmp_path):
    """``--device cpu --devices 2 --strategy half_ring``: two gloo ranks,
    rank 0 writes final.npz (the gathered state), equal to the one-device
    run's real bodies within tests/test_parallel.py's multi-step tolerance."""
    common = ["run", "--model", "plummer", "--n", "64", "--steps", "4", "--steps-per-block",
              "2", "--checkpoint-every", "2", "--device", "cpu"]
    assert main(common + ["--devices", "2", "--strategy", "half_ring",
                          "--out", str(tmp_path / "d2")]) == 0
    assert main(common + ["--out", str(tmp_path / "d1")]) == 0
    two, _ = jax_load(tmp_path / "d2" / "final.npz")
    one, _ = jax_load(tmp_path / "d1" / "final.npz")
    assert int(two.step) == 4 and two.n_real == 64 and two.n == 64
    np.testing.assert_allclose(np.asarray(two.pos), np.asarray(one.pos)[:64], rtol=2e-5,
                               atol=1e-5)
    assert (tmp_path / "d2" / "ck_00000002.npz").exists()


def test_run_devices_staged_over_gloo_ranks(tmp_path):
    """``--devices 2 --strategy treecode_staged`` at 4,096 bodies (the
    hierarchical path, planned for the ranks): rank 0's final.npz against
    the one-device treecode run. The two runs keep their bodies in their
    own Morton orders, so each coordinate is compared sorted (a permutation
    of the bodies leaves it unchanged, and it moves no more than the
    bodies do), within the staged run test's rtol 5e-4, atol 5e-5."""
    common = ["run", "--model", "plummer", "--n", "4096", "--steps", "4", "--solver",
              "treecode", "--device", "cpu"]
    assert main(common + ["--devices", "2", "--strategy", "treecode_staged",
                          "--out", str(tmp_path / "d2")]) == 0
    assert main(common + ["--out", str(tmp_path / "d1")]) == 0
    two, _ = jax_load(tmp_path / "d2" / "final.npz")
    one, _ = jax_load(tmp_path / "d1" / "final.npz")
    assert int(two.step) == 4 and two.n_real == 4096
    a, b = np.asarray(two.pos)[:4096], np.asarray(one.pos)[:4096]
    assert np.isfinite(a).all()
    np.testing.assert_allclose(np.sort(a, axis=0), np.sort(b, axis=0), rtol=5e-4, atol=5e-5)


def test_run_render_every_writes_frames_and_gif(tmp_path, capsys):
    """``--render-every 2 --gif`` on the CPU: a frame after every block that
    crosses the interval (steps 2, 4, 6), then movie.gif of them."""
    pytest.importorskip("PIL")
    from PIL import Image

    rc = main(["run", "--model", "plummer", "--n", "128", "--steps", "6", "--solver",
               "direct", "--render-every", "2", "--gif", "--width", "48", "--height", "32",
               "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    assert "assembled movie.gif (3 frames)" in capsys.readouterr().err
    names = sorted(p.name for p in (tmp_path / "frames").glob("*.png"))
    assert names == [f"frame_{i:06d}.png" for i in range(3)]
    with Image.open(tmp_path / "frames" / names[0]) as im:
        assert im.size == (48, 32)
    with Image.open(tmp_path / "movie.gif") as gif:
        assert gif.n_frames == 3 and gif.size == (48, 32)
    state, _ = jax_load(tmp_path / "final.npz")
    assert int(state.step) == 6


def test_run_gif_without_pillow_is_an_error(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    rc = main(["run", "--model", "plummer", "--n", "64", "--steps", "2", "--solver",
               "direct", "--render-every", "2", "--gif", "--width", "16", "--height",
               "16", "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 2 and "Pillow" in capsys.readouterr().err
    assert (tmp_path / "frames" / "frame_000000.png").exists()


def test_render_reads_a_jax_checkpoint(tmp_path):
    """``render`` on a checkpoint the JAX CLI wrote gives the JAX CLI's PNG
    within 1 in 255 a channel (the frames are float32 sums in another
    order, so a value on a rounding edge may land one step apart)."""
    from n_body_problem_tpu.cli import main as jax_main
    from PIL import Image

    assert jax_main(["run", "--model", "disk_galaxy", "--n", "300", "--steps", "2",
                     "--solver", "direct", "--out", str(tmp_path / "run")]) == 0
    ck = str(tmp_path / "run" / "final.npz")
    flags = ["--width", "96", "--height", "64", "--scales", "2", "2", "2",
             "--exposure", "1.5", "--cam-theta", "30", "--cam-phi", "25", "--cam-zoom", "2.5"]
    assert jax_main(["render", ck, str(tmp_path / "jax.png"), *flags]) == 0
    assert main(["render", ck, str(tmp_path / "port.png"), *flags, "--device", "cpu"]) == 0
    with Image.open(tmp_path / "jax.png") as a, Image.open(tmp_path / "port.png") as b:
        want, got = np.asarray(a).astype(int), np.asarray(b).astype(int)
    assert got.shape == want.shape == (64, 96, 3)
    assert want.max() > 0
    assert np.abs(got - want).max() <= 1


def test_render_defaults_to_the_card(tmp_path, capsys, monkeypatch):
    import torch

    from n_body_problem_tpu_torch.cli import build_parser

    args = build_parser().parse_args(["render", "a.npz", "b.png"])
    assert (args.device, args.width, args.height, args.cam_phi) == ("cuda", 1024, 768, 20.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["render", str(tmp_path / "a.npz"), str(tmp_path / "b.png")]) == 2
    assert 'device="cpu"' in capsys.readouterr().err


def test_run_without_a_gpu_names_the_cpu_device(tmp_path, capsys, monkeypatch):
    """``--device`` defaults to cuda; with no GPU the command fails and says
    how to ask for the CPU, and never falls back to it quietly."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main(["run", "--model", "plummer", "--n", "64", "--steps", "1",
               "--out", str(tmp_path)])
    assert rc != 0
    assert 'device="cpu"' in capsys.readouterr().err
    assert not (tmp_path / "final.npz").exists()


def test_run_treecode_tree_tuned(tmp_path, capsys):
    """``--solver treecode --tree-tuned`` on the CPU, with the capacities
    pinned in a config file (the hierarchical path's, as the JAX package's
    CPU runs pin them)."""
    cfg = tmp_path / "caps.json"
    cfg.write_text('{"tree_flat_cap": 16384, "tree_far_cap": 16384}')
    rc = main(["run", "--model", "plummer", "--n", "4096", "--steps", "4",
               "--steps-per-block", "2", "--diag-every", "2", "--config", str(cfg),
               "--solver", "treecode", "--tree-tuned", "--device", "cpu",
               "--out", str(tmp_path / "o")])
    assert rc == 0
    assert "solver=treecode" in capsys.readouterr().err
    state, saved = jax_load(tmp_path / "o" / "final.npz")
    assert int(state.step) == 4 and np.isfinite(np.asarray(state.pos)).all()
    # the tuning table's 20,480-and-under row (config.tuned_tree_overrides)
    assert (saved.tree_src_tile, saved.tree_rebuild_every, saved.tree_near_slack,
            saved.tree_mac_tau) == (32, 32, 4, 5e-4)


def test_run_agora_disk_with_its_physics(tmp_path, capsys):
    """``--model agora_disk`` with the deployment's physics (GADGET's G,
    80 pc softening, 0.1 Myr KDK steps) on the treecode, its capacities
    pinned for the CPU's hierarchical path."""
    cfg = tmp_path / "caps.json"
    cfg.write_text('{"tree_flat_cap": 16384, "tree_far_cap": 16384}')
    rc = main(["run", "--model", "agora_disk", "--n", "4096", "--steps", "4",
               "--steps-per-block", "2", "--config", str(cfg), "--solver", "treecode",
               "--integrator", "leapfrog", "--g", "43007.1", "--dt", "1.0227e-4",
               "--eps2", "0.0064", "--compensate", "1", "--device", "cpu",
               "--out", str(tmp_path / "o")])
    assert rc == 0
    assert "solver=treecode" in capsys.readouterr().err
    state, saved = jax_load(tmp_path / "o" / "final.npz")
    assert int(state.step) == 4 and np.isfinite(np.asarray(state.pos)).all()
    assert (saved.G, saved.integrator) == (43007.1, "leapfrog")
    mass = np.asarray(state.mass)
    assert mass.max() / mass.min() == pytest.approx(36.5, abs=0.1)


def test_info(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "solvers:" in out and "pallas_symmetric" in out and "symmetric.cu" in out
    assert "native io: " in out
    names = ("galaxy_20k", "dubinski", "tab65536", "stars", "k17c", "k17hp")
    for i, name in enumerate(names):
        assert f"  {i}: {name}" in out, name


def _tipsy_file(directory, n=512):
    """A galaxy_20K-layout tipsy file (dark bodies first) of ``n`` bodies."""
    from n_body_problem_tpu_torch.io import write_tipsy
    from n_body_problem_tpu_torch.models import plummer

    s = plummer(n, seed=5)
    path = directory / "galaxy_20K.bin"
    write_tipsy(path, s.pos.numpy(), s.vel.numpy(), s.mass.numpy(),
                np.full(n, 0.01, np.float32), n_dark=n // 8)
    return path, s


def test_run_dataset_export_snap_and_profile(tmp_path, capsys):
    """``--dataset 0 --data-dir`` on a synthetic tipsy file; the snap export
    read back by the JAX package's reader; the profiler's trace."""
    import json

    from n_body_problem_tpu.io import read_snap as jax_read_snap

    _, s = _tipsy_file(tmp_path)
    out = tmp_path / "o"
    rc = main(["run", "--dataset", "0", "--data-dir", str(tmp_path), "--steps", "4",
               "--steps-per-block", "2", "--solver", "direct", "--export-snap", "--profile",
               "--device", "cpu", "--out", str(out)])
    assert rc == 0
    assert "n=512 (padded 512)" in capsys.readouterr().err
    state, _ = jax_load(out / "final.npz")
    assert int(state.step) == 4 and state.n_real == 512
    snap = jax_read_snap(out / "final.snap")
    assert snap.n == 512 and snap.time == pytest.approx(float(state.time))
    # %.7g: the snap format's printed precision
    np.testing.assert_allclose(snap.pos, np.asarray(state.pos)[:512], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(snap.eps, 0.01, rtol=1e-6)
    trace = json.loads((out / "profile" / "trace.json").read_text())
    assert any(e.get("name") == "aten::add" for e in trace["traceEvents"])


def test_run_defaults_to_dataset_1(tmp_path):
    """With no --model the run loads dataset 1, whose fallback is 81,920
    galaxy_collision stars (+2 bulge particles) when the file is absent."""
    from n_body_problem_tpu_torch.cli import _load_initial_state, build_parser

    args = build_parser().parse_args(["run", "--data-dir", str(tmp_path)])
    assert args.dataset == 1 and args.device == "cuda"
    state, scales, cam, ck = _load_initial_state(args)
    assert state.n_real == 81922 and scales == (100, 100, 100) and ck is None
    assert state.pos.device.type == "cpu"


def test_run_missing_dataset_file_is_an_error(tmp_path, capsys):
    rc = main(["run", "--dataset", "3", "--data-dir", str(tmp_path), "--steps", "1",
               "--device", "cpu", "--out", str(tmp_path / "o")])
    assert rc == 2 and "stars.dat" in capsys.readouterr().err


def test_convert(tmp_path, capsys):
    from n_body_problem_tpu.io import read_csv as jax_read_csv

    path, s = _tipsy_file(tmp_path, n=100)
    assert main(["convert", str(path), str(tmp_path / "o.csv")]) == 0
    assert "wrote 100 bodies" in capsys.readouterr().err
    d = jax_read_csv(tmp_path / "o.csv")
    assert d.n == 100
    np.testing.assert_allclose(d.pos, s.pos.numpy(), rtol=1e-5, atol=1e-6)


def test_bench_subcommand(capsys):
    import json

    assert main(["bench", "--n", "256", "--steps", "2", "--solver", "direct",
                 "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["n"] == 256 and rec["steps_timed"] == 2 and rec["backend"] == "cpu"
    assert np.isfinite(rec["ms_per_step"]) and rec["pairs_per_sec"] > 0


def test_bench_subcommand_defaults():
    from n_body_problem_tpu_torch.cli import build_parser

    args = build_parser().parse_args(["bench"])
    assert (args.n, args.steps, args.solver, args.device) == (65536, 20, "auto", "cuda")


def test_top_level_names_cover_jax():
    """The port's ``__all__`` holds every name of the JAX package's, and its
    own ``from_numpy`` and ``to_numpy``; ``nb.io`` is there, as in JAX."""
    import n_body_problem_tpu as jnb
    import n_body_problem_tpu_torch as tnb

    assert set(tnb.__all__) == set(jnb.__all__) | {"from_numpy", "to_numpy"}
    assert all(hasattr(tnb, name) for name in tnb.__all__)
    assert hasattr(tnb, "io") and tnb.io.load_dataset is not None


def test_import_leaves_jax_out():
    """In a fresh process (this one has JAX loaded by tests/conftest.py)."""
    code = ("import sys, n_body_problem_tpu_torch, n_body_problem_tpu_torch.cli, "
            "n_body_problem_tpu_torch.bench, n_body_problem_tpu_torch.validate, "
            "n_body_problem_tpu_torch.io, n_body_problem_tpu_torch.utils.profiling, "
            "n_body_problem_tpu_torch.render.server, n_body_problem_tpu_torch.parallel, "
            "n_body_problem_tpu_torch.multichip, n_body_problem_tpu_torch.sharded_equality, "
            "n_body_problem_tpu_torch.mesh_scaling, n_body_problem_tpu_torch.tune_small_n, "
            "n_body_problem_tpu_torch.hier_census, n_body_problem_tpu_torch.dataset_sweep, "
            "n_body_problem_tpu_torch.examples.quickstart, "
            "n_body_problem_tpu_torch.examples.galaxy_collision_movie, "
            "n_body_problem_tpu_torch.examples.multichip_ring, "
            "n_body_problem_tpu_torch.examples.treecode_large_n; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'n_body_problem_tpu.'))"
            " or m in ('n_body_problem_tpu', 'bench', 'validate')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_package_sources_never_import_jax():
    """Nor the JAX system's root harness (``bench``) or validation
    (``validate``): the port has its own."""
    for path in PACKAGE.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                names = words[1:2] if words[0] == "from" else words[1:]
                for name in names:
                    assert name.split(".")[0] not in (
                        "jax", "jaxlib", "n_body_problem_tpu", "bench", "validate"), (
                        f"{path}: {line}")


def test_package_data_ships_every_build_input():
    """Every file the kernel build hashes or includes, and the native
    parser's source and Makefile, match a package-data pattern of
    pyproject.toml, so that an installed port can build both."""
    import fnmatch
    import tomllib

    from n_body_problem_tpu_torch.io import native
    from n_body_problem_tpu_torch.ops import cuda_build

    patterns = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "tool"]["setuptools"]["package-data"]["n_body_problem_tpu_torch"]
    inputs = sorted(cuda_build.CSRC_DIR.glob("*.cu*"))
    assert {p.suffix for p in inputs} == {".cu", ".cuh"}
    for src in cuda_build.sources():   # every header a source includes
        for line in src.read_text().splitlines():
            if line.startswith('#include "'):
                assert cuda_build.CSRC_DIR / line.split('"')[1] in inputs, (src, line)
    inputs += [native.SOURCE, native.NATIVE_DIR / "Makefile"]
    for path in inputs:
        rel = path.relative_to(PACKAGE).as_posix()
        assert any(fnmatch.fnmatch(rel, pat) for pat in patterns), rel
