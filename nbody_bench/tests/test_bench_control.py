"""The control, the plain reference in bfloat16 put in the program's place,
has to come out not correct in every cell, judged under the cell's own
limits. It runs on the card, at 16,384 bodies so that a test run holds it;
``python3 -m nbody_bench.control`` reads it at the cells' own sizes."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from nbody_bench import control, spec

CELLS = ("plummer_65k.exact", "plummer_65k.tree", "plummer_65k.live", "plummer_1m.tree")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tmp_path, cell):
    if not torch.cuda.is_available():
        pytest.skip("the control runs on a CUDA card")
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT / "nbody_bench", tmp_path / "nbody_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for p in (tmp_path / "nbody_bench/configs").glob("*.json"):
        p.write_text(json.dumps(dict(json.loads(p.read_text()), n=16384, probe_bodies=4096)))
    out = control.readings(cell, 21, 0.5, root=tmp_path)
    assert not out["correct"] and out["failed"] == out["attempted"] >= 1, out["checks"]
