"""Repeated runs of the port are bitwise identical (tests/test_determinism.py).

The JAX tests pin that a run repeated gives the same bits on every exact
solver; the port's plain solvers and the symmetric solver's twins (which
fill the kernels' slots and add them in slot order) hold it on the CPU
here, ``pallas`` in tests/test_torch_simulation.py, and the half ring in the
gloo world of tests/test_torch_parallel.py. On the card the symmetric
kernels are held to it by tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import pytest
import torch

import n_body_problem_tpu_torch as tnb


@pytest.mark.parametrize("solver", ["direct", "blocked", "mxu", "pallas_symmetric",
                                    "pallas_symmetric:bf16x3", "pallas_symmetric:mixed"])
def test_bitwise_deterministic_runs(solver):
    """tests/test_determinism.py:19, at its shapes: 128 bodies, 25 steps;
    ``pallas_symmetric`` in each precision at tile 32 (K = 4, with near and
    fast diagonals in "mixed")."""
    solver, _, precision = solver.partition(":")
    cfg = tnb.SimConfig(solver=solver, block_size=64, pallas_tile_i=64, pallas_tile_j=128,
                        pallas_sym_tile=32, pallas_sym_precision=precision or "f32")
    results = []
    for _ in range(2):
        sim = tnb.Simulation(cfg, tnb.models.plummer(128, seed=0), device="cpu")
        sim.run(25)
        results.append(sim.state.pos.clone())
    assert torch.equal(results[0], results[1])
