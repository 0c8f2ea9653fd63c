"""The port's multi-device tools: the dry run, sharded equality, mesh scaling.

Each tool runs in gloo worlds of 2 at a tiny N here (the JAX package's
tools take a virtual mesh of 8 and up to 262,144 bodies); the committed
record of the port's sharded equality at 65,536 bodies / 8 ranks is held
as tests/test_parallel.py holds the JAX package's.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import json
import pathlib

import pytest

from n_body_problem_tpu_torch import mesh_scaling, multichip, sharded_equality

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_KEYS = {"n", "devices", "steps", "rebuild_every", "resorts_fired", "max_abs_delta",
            "max_rel_delta", "sharded_overspeed", "sharded_energy_finite",
            "wall_s_sharded_cpu_mesh", "wall_s_single_chip_cpu", "passes"}


def test_sharded_equality_tool_writes_its_record(tmp_path, capsys):
    """The flat path at 2,048 bodies over two gloo ranks, two resorts: the
    JAX tool's record keys (and the device), passing."""
    out = tmp_path / "eq.json"
    assert sharded_equality.main(["--n", "2048", "--devices", "2", "--paths", "flat",
                                  "--device", "cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())["flat"]
    assert set(rec) == JAX_KEYS | {"device"}
    assert rec["n"] == 2048 and rec["devices"] == 2 and rec["resorts_fired"] == 2
    assert rec["passes"] is True and rec["max_rel_delta"] < 5e-4
    assert rec["sharded_overspeed"] == 0 and rec["sharded_energy_finite"]
    assert json.loads(capsys.readouterr().out.strip())["flat"] == rec


def test_sharded_equality_never_writes_the_jax_record(capsys):
    jax_record = ROOT / "validation" / "sharded_equality_65k.json"
    before = jax_record.read_bytes()
    assert sharded_equality.main(["--out", str(jax_record), "--device", "cpu"]) == 2
    assert "JAX package's record" in capsys.readouterr().err
    assert jax_record.read_bytes() == before


def test_sharded_equality_record_committed():
    """The port's record at 65,536 bodies over 8 gloo ranks: both paths,
    two resorts, within 5e-4 of the scale (tests/test_parallel.py's bar for
    the JAX package's record)."""
    rec = json.loads((ROOT / "validation" / "torch_sharded_equality_65k.json").read_text())
    for path in ("flat", "hier"):
        r = rec[path]
        assert set(r) == JAX_KEYS | {"device"}
        assert r["n"] == 65536 and r["devices"] == 8 and r["device"] == "cpu"
        assert r["resorts_fired"] >= 2
        assert r["max_rel_delta"] < 5e-4 and r["passes"] is True


def test_mesh_scaling_tool(tmp_path, capsys):
    """Every strategy of the tool at 2,048 bodies over two gloo ranks: a
    finite row each, the host's ms/step under the JAX tool's key."""
    out = tmp_path / "scaling.json"
    assert mesh_scaling.main(["--n", "2048", "--devices", "2", "--device", "cpu",
                              "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["backend"] == "gloo-cpu" and rec["steps"] == 1
    assert [(r["n"], r["devices"], r["strategy"]) for r in rec["results"]] == [
        (2048, 2, "half_ring"), (2048, 2, "treecode")]
    assert all(r["finite"] and r["ms_per_step_cpu"] > 0 for r in rec["results"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec


@pytest.mark.slow
def test_dryrun_multichip_two_ranks():
    """The seven legs over two gloo ranks (about 50 s here: the staged leg
    alone runs 16,384 bodies), each within its tolerance of the single
    device (a leg outside it raises)."""
    legs = multichip.dryrun_multichip(2, device="cpu")
    assert list(legs) == ["ring", "half_ring", "dense treecode (leapfrog)",
                          "flat treecode (semi_implicit_euler)", "flat treecode (leapfrog)",
                          "hier treecode", "staged treecode (ring-streamed panels)"]


def test_multichip_cli_refuses_a_ring_it_cannot_start(capsys):
    """``--devices 0``: no ring, exit 1 with the reason (no rank starts)."""
    assert multichip.main(["--devices", "0", "--device", "cpu"]) == 1
    assert "requested 0 devices" in capsys.readouterr().err
