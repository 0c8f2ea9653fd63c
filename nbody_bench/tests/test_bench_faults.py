"""A run with the timed path broken underneath it has to come out not
correct, and a sound one correct.

The harness is driven on the CPU (it skips its look for a card), each cell
at 2,048 bodies with 10-step calls in place of 50, under the cell's own
limits. Where a cell's solver is ``auto`` (kernel 2 on the card), the CPU
takes the plain direct sum: its own ``auto``, the matmul form, cancels to
1e-5 in float32. The faults each cell can have: a step that returns its state
unchanged; half the bodies left out of the force, the rest counted double
(the mean over the rest); answers altered where they are produced (one
force in 16 off by 10 %); a call that takes fewer steps than it was asked
for (the last two left out). No cell spans chips, so none leaves out an
exchange between them.
"""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from nbody_bench import harness, spec
from nbody_bench.port import Port

N, STEPS = 2048, 10
CELLS = ("plummer_65k.exact", "plummer_65k.tree", "plummer_65k.live", "plummer_1m.tree")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark at the test's size."""
    tmp = tmp_path_factory.mktemp("bench")
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp)
    shutil.copytree(spec.ROOT / "nbody_bench", tmp / "nbody_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for p in (tmp / "nbody_bench/configs").glob("*.json"):
        p.write_text(json.dumps(dict(json.loads(p.read_text()), n=N, probe_bodies=N)))
    for p in (tmp / "nbody_bench/traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t["steps_per_call"] = min(t["steps_per_call"], STEPS)
        t["solver"] = "direct" if t["solver"] == "auto" else t["solver"]
        p.write_text(json.dumps(t))
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


def _half(force):
    def half(pos, mass, *aux, **kw):
        keep = torch.zeros_like(mass)
        keep[::2] = 2.0
        return force(pos, mass * keep, *aux, **kw)
    return half


@pytest.fixture
def half_sources(monkeypatch):
    """The force of every solver the CPU runs counts every other body
    twice and leaves the rest out."""
    from n_body_problem_tpu_torch.ops import forces, registry

    monkeypatch.setattr(forces, "direct_acc", _half(forces.direct_acc))
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
