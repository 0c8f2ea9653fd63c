"""A run with the timed path broken underneath it has to come out not
correct, and a sound one correct.

The harness is driven on the CPU (it skips its look for a card), each cell
of ``BENCHMARK.json`` at 2,048 bodies with 10-step calls in place of 50,
under the cell's own limits, and three cells of ``new_cells`` added to the
copy by files (counts the program pads, two masses, the leapfrog). Where an
accepted cell's solver is ``auto`` (kernel 2 on the card), the CPU takes
the plain direct sum: its own ``auto``, the matmul form, cancels to 1e-5 in
float32. The added cells keep the CPU's ``auto``, which pads to 1,024 as
the card's does. The faults each cell can have: a step that returns its
state unchanged; half the bodies left out of the force, the rest counted
double (the mean over the rest); in a padded cell, the padding handed back
or moved into the real slots; answers altered where they are produced (one
force in 16 off by 10 %); a call that takes fewer steps than it was asked
for (the last two left out). No cell spans chips, so none leaves out an
exchange between them.
"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from nbody_bench import harness, spec
from nbody_bench.port import Port
from nbody_bench.reference.control import Control
from nbody_bench.snapshot import Snapshot
from nbody_bench.tests import new_cells

N, STEPS = 2048, 10
PADDED = ("padded.tree", "galaxy.exact")
NEW = (*PADDED, "galaxy.tree")
LEAPFROG = ("leapfrog.exact", "galaxy.exact", "galaxy.tree")
CELLS = (*(w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())
           ["workloads"]), *NEW)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark at the test's size, with the new cells and
    ``leapfrog.exact`` added (their own sizes; ``auto`` stays the CPU's,
    which pads)."""
    tmp = tmp_path_factory.mktemp("bench")
    new_cells.copy(tmp)
    for p in (tmp / "nbody_bench/configs").glob("*.json"):
        p.write_text(json.dumps(dict(json.loads(p.read_text()), n=N, probe_bodies=N)))
    for p in (tmp / "nbody_bench/traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t["steps_per_call"] = min(t["steps_per_call"], STEPS)
        t["solver"] = "direct" if t["solver"] == "auto" else t["solver"]
        p.write_text(json.dumps(t))
    for cell in (*NEW, "leapfrog.exact"):
        new_cells.add(tmp, cell, STEPS)
    return tmp


class Unchanged(Port):
    """Every call hands back the state it was given."""

    def run(self, n_steps):
        if not hasattr(self, "_snap"):
            self._snap = super().run(n_steps)
        return self._snap


class Altered(Port):
    """Every 16th body's force comes back 10 % off."""

    def run(self, n_steps):
        snap = super().run(n_steps)
        snap.acc = snap.acc.clone()
        snap.acc[::16] *= 1.1
        return snap


class Shortchanged(Port):
    """Every call leaves its last two steps out (one step where it is
    asked for one or two)."""

    def run(self, n_steps):
        return super().run(max(n_steps - 2, 1) if n_steps > 1 else 0)


class WithPadding(Port):
    """Every call hands back the program's whole state, padding and all."""

    def run(self, n_steps):
        s = self.sim.run(n_steps)
        return Snapshot(s.pos, s.vel, s.acc, self.sim.sort_perm, s.step)


class PaddingInside(Port):
    """The last real slot holds the first padding body, under its own index."""

    def run(self, n_steps):
        s, k = self.sim.run(n_steps), self.sim.state.n_real
        ids = list(range(k)) if self.sim.sort_perm is None else list(self.sim.sort_perm)
        return Snapshot(s.pos[1:k + 1], s.vel[1:k + 1], s.acc[1:k + 1], ids[1:] + [k], s.step)


class HalfKickLeftOut(Port):
    """Every call's last step leaves out its closing half-kick: the state,
    and so the next call, carries ``v_{n-1/2}``."""

    def run(self, n_steps):
        snap = super().run(n_steps)
        s = self.sim.state
        s.vel = s.vel - s.acc * (0.5 * self.sim.cfg.dt)
        snap.vel = s.vel[:s.n_real]
        return snap


class Reference64(Control):
    """The reference's own leapfrog in float64 in the program's place."""

    def __init__(self, *args):
        super().__init__(*args, dtype=torch.float64)
        self.phys = dataclasses.replace(self.phys, integrator="leapfrog")


def _half(force):
    def half(pos, mass, *aux, **kw):
        keep = torch.zeros_like(mass)
        keep[::2] = 2.0
        return force(pos, mass * keep, *aux, **kw)
    return half


@pytest.fixture
def half_sources(monkeypatch):
    """The force of every solver the CPU runs (``direct``, ``auto``'s
    ``mxu``, the treecode) counts every other body twice and leaves the rest
    out."""
    from n_body_problem_tpu_torch.ops import forces, registry

    for name in ("direct_acc", "mxu_acc"):
        monkeypatch.setattr(forces, name, _half(getattr(forces, name)))
    for path, (build, force) in list(registry._TREE_FNS.items()):
        monkeypatch.setitem(registry._TREE_FNS, path, (build, _half(force)))


def _run(root, cell, system_cls=None):
    return harness.run_cell(cell, 11, 0.5, False, root=root, device="cpu",
                            system_cls=system_cls)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(root, cell):
    out = _run(root, cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [Unchanged, Altered, Shortchanged],
                         ids=["unchanged", "altered", "shortchanged"])
def test_a_planted_fault_is_not_correct(root, cell, fault):
    out = _run(root, cell, fault)
    assert not out["correct"] and out["failed"] >= 1, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_bodies_left_out_is_not_correct(root, cell, half_sources):
    out = _run(root, cell)
    assert not out["correct"] and out["failed"] >= 1, out["checks"]


@pytest.mark.parametrize("cell", PADDED)
@pytest.mark.parametrize("fault", [WithPadding, PaddingInside], ids=["with", "inside"])
def test_padding_handed_back_is_not_correct(root, cell, fault):
    out = _run(root, cell, fault)
    assert not out["correct"] and out["failed"] == out["attempted"] >= 1, out["checks"]
    assert out["checks"]["force_p99"]["value"] is None


@pytest.mark.parametrize("cell", LEAPFROG)
def test_a_closing_half_kick_left_out_is_not_correct(root, cell):
    """Its positions and forces are the leapfrog's; its velocity lags half a
    kick along the force on every body."""
    out = _run(root, cell, HalfKickLeftOut)
    assert not out["correct"] and out["failed"] == out["attempted"] >= 1, out["checks"]
    assert out["checks"]["dv_lag"]["value"] > 0.4, out["checks"]


@pytest.mark.parametrize("cell,correct", [("leapfrog.exact", True), ("plummer_65k.exact", False)])
def test_the_float64_leapfrog_is_judged_by_the_configurations_integrator(root, cell, correct):
    """Judged as a leapfrog it is correct; judged as the Euler step the
    configuration states, its forces (at the state's positions, not one
    step back) read far off."""
    out = _run(root, cell, Reference64)
    assert out["correct"] is correct, out["checks"]
    if not correct:
        assert out["checks"]["force_p99"]["value"] > 0.1, out["checks"]
