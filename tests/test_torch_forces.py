"""The port's plain PyTorch solvers against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import numpy as np
import pytest
import torch

from n_body_problem_tpu.ops import forces as jf
from n_body_problem_tpu_torch.ops import forces as tf

EPS2 = 1e-6
C = 0.1


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32) / n
    return pos, mass


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("solver", ["direct_acc", "blocked_acc", "mxu_acc"])
def test_solver_matches_jax_direct(solver):
    # rtol=2e-4, atol=2e-4: the JAX package's own bound between its solvers
    # and direct_acc (tests/test_forces.py:56); the sums run in another order.
    pos, mass = _cloud(256, seed=0)
    want = np.asarray(jf.direct_acc(pos, mass, eps2=EPS2, compensate=C))
    kw = {} if solver == "direct_acc" else {"block_size": 64}
    got = getattr(tf, solver)(*_t(pos, mass), eps2=EPS2, compensate=C, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_direct_close_to_jax_direct():
    # The same broadcast formula in both packages; only the reduction order
    # of the last sum can differ, so float32 rounding is the whole gap.
    pos, mass = _cloud(200, seed=1)
    want = np.asarray(jf.direct_acc(pos, mass, eps2=EPS2, compensate=C))
    got = tf.direct_acc(*_t(pos, mass), eps2=EPS2, compensate=C).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_symmetric_tile_matches_jax():
    # Both halves of the block pair; float32 reduction-order tolerance.
    pi, mi = _cloud(48, seed=2)
    pj, mj = _cloud(80, seed=3)
    want = jf.pair_accel_tile_symmetric(pi, mi, pj, mj, eps2=EPS2, compensate=C)
    got = tf.pair_accel_tile_symmetric(*_t(pi, mi, pj, mj), eps2=EPS2, compensate=C)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "solver", ["blocked", "mxu", "pallas", "auto", "pallas_symmetric", "treecode", "direct"])
def test_required_padding_matches_jax(solver):
    for n in (1, 100, 128, 200, 1000, 4097, 65536, 262145):
        for block, ti, tj, sym in ((256, 256, 1024, 512), (64, 64, 128, 64), (128, 32, 96, 96)):
            args = (solver, n, block, ti, tj, sym, 32, 64)
            assert tf.required_padding(*args) == jf.required_padding(*args), args


def test_two_body_closed_form():
    """Two unit masses at distance r with plain softening (c = 1): the pull
    is m r / (r^2 + eps2)^1.5 toward each other."""
    r, eps2 = 2.0, 1e-4
    pos = torch.tensor([[0.0, 0.0, 0.0], [r, 0.0, 0.0]])
    mass = torch.tensor([1.0, 1.0])
    acc = tf.direct_acc(pos, mass, eps2=eps2, compensate=1.0)
    want = r / (r * r + eps2) ** 1.5
    np.testing.assert_allclose(acc[:, 0].numpy(), [want, -want], rtol=1e-6)
    np.testing.assert_array_equal(acc[:, 1:].numpy(), np.zeros((2, 2)))


def test_plain_softening_matches_jax():
    # compensate = 1 gives plain Plummer softening; same tolerance as above.
    pos, mass = _cloud(128, seed=4)
    want = np.asarray(jf.direct_acc(pos, mass, eps2=1e-4, compensate=1.0))
    got = tf.blocked_acc(*_t(pos, mass), eps2=1e-4, compensate=1.0, block_size=32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_compensate_equals_effective_softening():
    """c-scaled pair math equals plain softening with eps2 / c^2 (times G c^3
    folding), the identity the config documents."""
    pos, mass = _cloud(64, seed=5)
    a = tf.direct_acc(*_t(pos, mass), eps2=EPS2, compensate=C)
    b = tf.direct_acc(*_t(pos, mass), eps2=EPS2 / C**2, compensate=1.0)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)


def test_blocked_rejects_misaligned():
    pos, mass = _cloud(100, seed=0)
    with pytest.raises(ValueError):
        tf.blocked_acc(*_t(pos, mass), eps2=EPS2, block_size=64)
    with pytest.raises(ValueError):
        tf.mxu_acc(*_t(pos, mass), eps2=EPS2, block_size=64)
