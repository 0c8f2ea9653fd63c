"""The CUDA kernels on the card (marked ``cuda``; they skip without a GPU).

Run them on a machine with a GPU:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest imports JAX, which a GPU machine
need not have; this file needs only torch.)

Each kernel is held against its plain PyTorch version on the same inputs on
the card, within rtol=1e-4, atol=2e-6 (the JAX package's bounds for these
kernels against the direct oracle, tests/test_pallas_symmetric.py:27).
"""

import pytest
import torch

import n_body_problem_tpu_torch as tnb
from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric
from n_body_problem_tpu_torch.state import pad_state_to

pytestmark = pytest.mark.cuda

PHYS = dict(eps2=1e-6, compensate=0.1, G=1.0)
TOL = dict(rtol=1e-4, atol=2e-6)
SIZES = [(128, 128), (896, 896), (1024, 934)]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; run on the card with -m cuda")
    return torch.device("cuda", 0)


def _bodies(n, n_real, seed, device):
    s = pad_state_to(tnb.models.plummer(n_real, seed=seed), n).to(device)
    return s.pos, s.mass


@pytest.mark.parametrize("n,n_real", SIZES)
def test_allpairs_kernel_matches_plain(cuda, n, n_real):
    pos, mass = _bodies(n, n_real, 1, cuda)
    rows = _bodies(384, 384, 2, cuda)[0] + 0.5
    for pi in (pos, rows):
        got = cuda_force.block_acc(pi, pos, mass, tile_i=128, tile_j=128, **PHYS)
        torch.testing.assert_close(got, cuda_force.block_acc_plain(pi, pos, mass, **PHYS), **TOL)
        again = cuda_force.block_acc(pi, pos, mass, tile_i=128, tile_j=128, **PHYS)
        assert torch.equal(got, again)   # fixed loop order, no atomics


@pytest.mark.parametrize("n,n_real", SIZES)
def test_symmetric_kernel_matches_plain(cuda, n, n_real):
    pos, mass = _bodies(n, n_real, 3, cuda)
    got = cuda_symmetric.symmetric_acc(pos, mass, tile=128, **PHYS)
    want = cuda_symmetric.symmetric_acc_plain(pos, mass, tile=128, **PHYS)
    torch.testing.assert_close(got, want, **TOL)
    assert float((mass[:, None] * got).sum(0).abs().max()) < 1e-6


def test_wrappers_count_launches(cuda):
    pos, mass = _bodies(256, 256, 4, cuda)
    a0, s0 = cuda_force.block_acc.launches, cuda_symmetric.symmetric_acc.launches
    cuda_force.allpairs_acc(pos, mass, tile_i=128, tile_j=128, **PHYS)
    cuda_symmetric.symmetric_acc(pos, mass, tile=128, **PHYS)
    torch.cuda.synchronize()
    assert (cuda_force.block_acc.launches - a0, cuda_symmetric.symmetric_acc.launches - s0) == (1, 1)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    pos, mass = _bodies(256, 256, 5, cuda)
    with pytest.raises(TypeError):
        cuda_force.allpairs_acc(pos.double(), mass.double(), tile_i=128, tile_j=128, **PHYS)
    with pytest.raises(ValueError):
        cuda_force.block_acc(pos, pos, mass.cpu(), tile_i=128, tile_j=128, **PHYS)
    p64, m64 = _bodies(192, 192, 6, cuda)
    with pytest.raises(ValueError, match="128"):
        cuda_symmetric.symmetric_acc(p64, m64, tile=64, **PHYS)


def test_simulation_on_card_matches_cpu(cuda):
    # Same bodies and steps; the card's sums run in another order (and with
    # atomics for the symmetric kernel), so positions agree to float32
    # rounding grown over 5 steps.
    for solver in ("pallas", "pallas_symmetric"):
        cfg = tnb.SimConfig(solver=solver, pallas_tile_i=128, pallas_tile_j=128,
                            pallas_sym_tile=128)
        gpu = tnb.Simulation(cfg, tnb.models.plummer(500, seed=7), device=cuda)
        cpu = tnb.Simulation(cfg, tnb.models.plummer(500, seed=7), device="cpu")
        gpu.run(5)
        cpu.run(5)
        torch.testing.assert_close(gpu.state.pos.cpu(), cpu.state.pos, rtol=1e-4, atol=1e-5)
