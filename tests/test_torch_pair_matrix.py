"""The port's pair-matrix foil against the JAX package's, on the same bodies."""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import numpy as np
import pytest
import torch

import n_body_problem_tpu as jnb
import n_body_problem_tpu_torch as tnb
from n_body_problem_tpu.ops.pair_matrix import pair_matrix_acc as jax_pair_matrix_acc
from n_body_problem_tpu_torch.ops.pair_matrix import MAX_PAIR_MATRIX_BODIES, pair_matrix_acc

EPS2 = 1e-6
C = 0.1


@pytest.mark.parametrize("n_real,multiple", [(300, 1), (300, 64)])
def test_pair_matrix_matches_jax(n_real, multiple):
    # rtol=1e-4, atol=2e-6: the exact kernels' bound against the direct sum
    # (tests/test_pallas_symmetric.py:27); both sides sum the same pair
    # forces in another order. With multiple=64 the zero-mass padding bodies
    # get 0, as in JAX.
    state = jnb.pad_state(jnb.models.plummer(n_real, seed=5), multiple=multiple)
    pos, mass = np.asarray(state.pos), np.asarray(state.mass)
    want = np.asarray(jax_pair_matrix_acc(pos, mass, eps2=EPS2, compensate=C))
    got = pair_matrix_acc(torch.from_numpy(pos.copy()), torch.from_numpy(mass.copy()),
                          eps2=EPS2, compensate=C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-6)
    assert not got[n_real:].any()


def test_pair_matrix_matches_the_direct_sum():
    state = tnb.models.plummer(200, seed=6)
    got = pair_matrix_acc(state.pos, state.mass, eps2=EPS2, compensate=C)
    want = tnb.ops.direct_acc(state.pos, state.mass, eps2=EPS2, compensate=C)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=2e-6)


def test_pair_matrix_refuses_large_n():
    # 40,000 bodies: refused before anything is materialised.
    pos = torch.zeros((40000, 3))
    with pytest.raises(ValueError, match="foil"):
        pair_matrix_acc(pos, torch.ones(40000), eps2=EPS2)
    assert MAX_PAIR_MATRIX_BODIES == 32768


def test_pair_matrix_registry_and_padding():
    from n_body_problem_tpu_torch.ops.forces import required_padding
    from n_body_problem_tpu_torch.ops.registry import make_force_fn

    assert required_padding("pair_matrix", 300, 256) == 300
    state = tnb.models.plummer(100, seed=0)
    cfg = tnb.SimConfig(solver="pair_matrix")
    got = make_force_fn(cfg)(state.pos, state.mass)
    want = pair_matrix_acc(state.pos, state.mass, eps2=cfg.eps2, compensate=cfg.compensate,
                           G=cfg.G)
    assert torch.equal(got, want)
