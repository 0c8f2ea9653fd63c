"""The control, the plain reference in bfloat16 put in the program's place,
has to come out not correct in every cell of ``BENCHMARK.json`` and in the
leapfrog cells of ``new_cells`` added to the copy, judged under the cell's
own limits. It runs on the card, at 16,384 bodies (16,000 in the added
cells) so that a test run holds it; ``python3 -m nbody_bench.control``
reads it at the cells' own sizes."""

from __future__ import annotations

import json

import pytest
import torch

from nbody_bench import control, spec
from nbody_bench.tests import new_cells

NEW = ("leapfrog.exact", "galaxy.exact", "galaxy.tree", "galaxy.live")
CELLS = (*(w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())
           ["workloads"]), *NEW)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tmp_path, cell):
    if not torch.cuda.is_available():
        pytest.skip("the control runs on a CUDA card")
    new_cells.copy(tmp_path)
    for p in (tmp_path / "nbody_bench/configs").glob("*.json"):
        p.write_text(json.dumps(dict(json.loads(p.read_text()), n=16384, probe_bodies=4096)))
    if cell in NEW:
        new_cells.add(tmp_path, cell, 50, n=16000)
    out = control.readings(cell, 21, 0.5, root=tmp_path)
    assert not out["correct"] and out["failed"] == out["attempted"] >= 1, out["checks"]
