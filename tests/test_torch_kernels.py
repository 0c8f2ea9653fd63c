"""The kernels' plain versions against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
the Pallas kernel in interpret mode with small tiles, as the JAX package's
own tests do. The CUDA kernels themselves are compared with these plain
versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import n_body_problem_tpu as jnb
import n_body_problem_tpu_torch as tnb
from n_body_problem_tpu.ops.pallas_force import pallas_block_acc
from n_body_problem_tpu.ops.pallas_symmetric import symmetric_acc as jax_symmetric_acc
from n_body_problem_tpu_torch.ops import cuda_build, cuda_force, cuda_symmetric

EPS2 = 1e-6
C = 0.1
SOURCES = ["allpairs.cu", "far_hier.cu", "far_single.cu", "gather.cu", "near.cu",
           "near_panel.cu", "symmetric.cu", "vip.cu"]


def _pair(jstate):
    """The same bodies as numpy (for JAX) and torch (for the port)."""
    pos, mass = np.asarray(jstate.pos), np.asarray(jstate.mass)
    return (pos, mass), (torch.from_numpy(pos.copy()), torch.from_numpy(mass.copy()))


@pytest.mark.parametrize("rows", ["square", "block"])
def test_block_acc_plain_matches_pallas(rows):
    # rtol=1e-4, atol=1e-6: the JAX package's bound for this kernel against
    # the direct sum (tests/test_pallas.py:30); both sides are float32 sums
    # over the same pairs in different orders.
    (pj, mj), (tpj, tmj) = _pair(jnb.pad_state(jnb.models.plummer(300, seed=7), multiple=128))
    if rows == "square":
        pi, tpi = pj, tpj
    else:
        pi = np.asarray(jnb.models.plummer(192, seed=8).pos) + np.float32(0.5)
        tpi = torch.from_numpy(pi.copy())
    want = np.asarray(pallas_block_acc(pi, pj, mj, eps2=EPS2, compensate=C,
                                       tile_i=64, tile_j=128))
    got = cuda_force.block_acc(tpi, tpj, tmj, eps2=EPS2, compensate=C,
                               tile_i=64, tile_j=128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    plain = cuda_force.block_acc_plain(tpi, tpj, tmj, eps2=EPS2, compensate=C)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


@pytest.mark.parametrize(
    "n_real,tile",
    [
        (120, 32),   # even K = 4
        (200, 32),   # odd K = 7
        (60, 64),    # K = 1 (pure diagonal triangle)
        (90, 32),    # even K with padding bodies in the last tile
    ],
)
def test_symmetric_plain_matches_pallas(n_real, tile):
    # rtol=1e-4, atol=2e-6: the JAX package's bound for this kernel against
    # the direct sum (tests/test_pallas_symmetric.py:27). The coverage is the
    # same; the JAX reaction runs through centred matmul panels, so the
    # rounding differs.
    (p, m), (tp, tm) = _pair(jnb.pad_state(jnb.models.plummer(n_real, seed=3), multiple=tile))
    want = np.asarray(jax_symmetric_acc(p, m, eps2=EPS2, compensate=C, tile=tile))
    got = cuda_symmetric.symmetric_acc(tp, tm, eps2=EPS2, compensate=C, tile=tile)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-6)


def test_symmetric_plain_covers_every_pair_once():
    """Against the port's own direct sum: a missed or doubled tile pair
    would be off by a whole pair force, far outside float32 rounding."""
    state = tnb.pad_state(tnb.models.plummer(450, seed=9), multiple=64)
    for tile in (64, 128, 32):
        if state.n % tile:
            continue
        got = cuda_symmetric.symmetric_acc_plain(state.pos, state.mass, eps2=EPS2,
                                                 compensate=C, tile=tile)
        want = tnb.ops.direct_acc(state.pos, state.mass, eps2=EPS2, compensate=C)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=2e-6)


def test_symmetric_momentum():
    """Half-pair evaluation applies +/- the same pair force, so the net
    momentum change is zero to rounding (tests/test_pallas_symmetric.py:30-39)."""
    state = tnb.pad_state(tnb.models.plummer(100, seed=5), multiple=32)
    acc = cuda_symmetric.symmetric_acc(state.pos, state.mass, eps2=EPS2, compensate=C, tile=32)
    net = torch.sum(state.mass[:, None] * acc, dim=0)
    np.testing.assert_allclose(net.numpy(), np.zeros(3), atol=1e-6)


def test_cpu_tensors_launch_no_kernel():
    before = (cuda_force.block_acc.launches, cuda_symmetric.symmetric_acc.launches)
    state = tnb.pad_state(tnb.models.plummer(100, seed=0), multiple=128)
    cuda_force.allpairs_acc(state.pos, state.mass, eps2=EPS2, tile_i=128, tile_j=128)
    cuda_symmetric.symmetric_acc(state.pos, state.mass, eps2=EPS2, tile=128)
    sim = tnb.Simulation(tnb.SimConfig(solver="pallas_symmetric", pallas_sym_tile=64),
                         tnb.models.plummer(64, seed=0), device="cpu")
    sim.run(2)
    assert (cuda_force.block_acc.launches, cuda_symmetric.symmetric_acc.launches) == before
    assert before == (0, 0)


@pytest.mark.parametrize("kernel", ["allpairs", "symmetric"])
def test_misaligned_n_raises(kernel):
    state = tnb.models.plummer(100, seed=0)
    with pytest.raises(ValueError):
        if kernel == "allpairs":
            cuda_force.allpairs_acc(state.pos, state.mass, eps2=EPS2, tile_i=64, tile_j=128)
        else:
            cuda_symmetric.symmetric_acc(state.pos, state.mass, eps2=EPS2, tile=64)


def test_fast_math_precisions_not_ported():
    state = tnb.pad_state(tnb.models.plummer(60, seed=0), multiple=64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cuda_symmetric.symmetric_acc(state.pos, state.mass, eps2=EPS2, tile=64,
                                     precision="bf16x3")
    with pytest.raises(ValueError):
        cuda_symmetric.symmetric_acc(state.pos, state.mass, eps2=EPS2, tile=64,
                                     precision="f16")


def test_kernel_argument_checks():
    """What the CUDA wrappers check before a launch, on CPU tensors."""
    dev = torch.device("cpu")
    good = torch.zeros((8, 3))
    cuda_build.require_f32("x", good, (8, 3), dev)
    for bad, exc in ((good.double(), TypeError), (good[:, :2], ValueError),
                     (torch.zeros((3, 8)).t(), ValueError), (good.numpy(), TypeError)):
        with pytest.raises(exc):
            cuda_build.require_f32("x", bad, (8, 3), dev)


def test_build_inputs_are_the_package_sources():
    names = [p.name for p in cuda_build.sources()]
    assert names == SOURCES
    assert cuda_build.library_path().parent.parent == cuda_build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert "--use_fast_math" not in cuda_build.NVCC_FLAGS


def test_build_hash_covers_the_included_headers(tmp_path, monkeypatch):
    """Editing a header the kernels include must rebuild the library."""
    import shutil

    for src in cuda_build.CSRC_DIR.iterdir():
        shutil.copy(src, tmp_path / src.name)
    assert (tmp_path / "lists.cuh").is_file()
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    before = cuda_build.source_hash()
    (tmp_path / "lists.cuh").write_text((tmp_path / "lists.cuh").read_text() + "\n")
    assert cuda_build.source_hash() != before
    assert [p.name for p in cuda_build.sources()] == SOURCES
