"""Repeated runs of the port are bitwise identical (tests/test_determinism.py).

The JAX tests pin that a run repeated gives the same bits on every exact
solver; the port's plain solvers hold it on the CPU here, ``pallas`` in
tests/test_torch_simulation.py, and the half ring in the gloo world of
tests/test_torch_parallel.py.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import pytest
import torch

import n_body_problem_tpu_torch as tnb


@pytest.mark.parametrize("solver", ["direct", "blocked", "mxu"])
def test_bitwise_deterministic_runs(solver):
    """tests/test_determinism.py:19, at its shapes: 128 bodies, 25 steps."""
    cfg = tnb.SimConfig(solver=solver, block_size=64, pallas_tile_i=64, pallas_tile_j=128)
    results = []
    for _ in range(2):
        sim = tnb.Simulation(cfg, tnb.models.plummer(128, seed=0), device="cpu")
        sim.run(25)
        results.append(sim.state.pos.clone())
    assert torch.equal(results[0], results[1])
