"""The port's Morton sort against the JAX package's: keys and permutations
must be exactly equal, on the host and on the device path."""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import n_body_problem_tpu as jnb
import n_body_problem_tpu_torch as tnb
from n_body_problem_tpu.utils import morton as jm
from n_body_problem_tpu_torch.utils import morton as tm


def _bodies(n, seed, model="plummer"):
    """Positions and masses (numpy, float32) of a model from both packages'
    shared generator."""
    st = jnb.models.make_model(model, n, seed=seed)
    return np.asarray(st.pos), np.asarray(st.mass)


def _cols(pos):
    return [torch.from_numpy(pos[:, i].copy()) for i in range(3)]


KEY_CASES = [(4096, 4096, 0), (8192, 8000, 3), (6144, 6143, 5)]


@pytest.mark.parametrize("n,n_real,seed", KEY_CASES)
def test_device_keys_equal_jax(n, n_real, seed):
    pos, _ = _bodies(n, seed)
    want = np.asarray(jm.morton_keys_cols(*(jnp.asarray(pos[:, i]) for i in range(3)),
                                          n_real))
    got = tm.morton_keys_cols(*_cols(pos), n_real)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[n_real:] == 0x7FFFFFFF).all()


@pytest.mark.parametrize("n,n_real,seed", KEY_CASES)
def test_device_keys_of_positions_equal_jax(n, n_real, seed):
    """``morton_keys_device`` on (N, 3) positions (utils/morton.py:106)."""
    pos, _ = _bodies(n, seed)
    want = np.asarray(jm.morton_keys_device(jnp.asarray(pos), n_real))
    got = tm.morton_keys_device(torch.from_numpy(pos.copy()), n_real)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,n_real,model", [(4096, 4096, "plummer"),
                                            (8192, 7990, "galaxy_collision")])
def test_resort_cols_permutation_equals_jax(n, n_real, model):
    pos, mass = _bodies(n, 1, model)
    n = pos.shape[0]   # a galaxy collision adds its two central masses
    ids = np.arange(n, dtype=np.int32)
    jcols = jm.resort_cols(tuple(jnp.asarray(a) for a in (*pos.T, mass, ids)), n_real)
    tcols = tm.resort_cols((*_cols(pos), torch.from_numpy(mass.copy()),
                            torch.from_numpy(ids.copy())), n_real)
    np.testing.assert_array_equal(tcols[4].numpy(), np.asarray(jcols[4]))
    for got, want in zip(tcols[:4], jcols[:4]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (tcols[4][n_real:].numpy() == np.arange(n_real, n)).all()   # padding last


@pytest.mark.parametrize("seed", [0, 7])
def test_host_argsort_equals_jax(seed):
    pos, _ = _bodies(3000, seed, "galaxy_collision")
    np.testing.assert_array_equal(tm.morton_argsort(pos), jm.morton_argsort(pos))
    np.testing.assert_array_equal(tm.morton_keys(pos), jm.morton_keys(pos))
    np.testing.assert_array_equal(tm.morton_argsort(torch.from_numpy(pos.copy())),
                                  jm.morton_argsort(pos))


def test_device_resort_tracks_ids_and_keeps_padding_last():
    state = tnb.pad_state(tnb.models.plummer(1000, seed=2), multiple=256)
    ids = torch.arange(state.n, dtype=torch.int32)
    out, out_ids = tm.device_resort(state, ids)
    torch.testing.assert_close(out.pos, state.pos[out_ids.long()], rtol=0, atol=0)
    torch.testing.assert_close(out.mass, state.mass[out_ids.long()], rtol=0, atol=0)
    assert (out_ids[1000:] == torch.arange(1000, state.n, dtype=torch.int32)).all()
    assert sorted(out_ids.tolist()) == list(range(state.n))


@pytest.mark.parametrize("cfg", [dict(morton_sort=True), dict(resort_every=4)])
def test_sorted_simulation_equals_jax(cfg):
    """``morton_sort`` / ``resort_every`` on an exact solver: the same host
    sort, so the same body order and the same trajectory as JAX's."""
    kw = dict(solver="direct", **cfg)
    js = jnb.Simulation(jnb.SimConfig(**kw), jnb.models.plummer(300, seed=3))
    ts = tnb.Simulation(tnb.SimConfig(**kw), tnb.models.plummer(300, seed=3), device="cpu")
    js.run(10)
    ts.run(10)
    np.testing.assert_array_equal(ts.sort_perm, np.asarray(js.sort_perm))
    # rtol=1e-4, atol=1e-5: float32 force sums in another order, over 10 steps
    # (as tests/test_torch_simulation.py compares these solvers).
    np.testing.assert_allclose(ts.state.pos.numpy(), np.asarray(js.state.pos),
                               rtol=1e-4, atol=1e-5)
