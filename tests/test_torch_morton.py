"""The port's Morton sort against the JAX package's: keys and permutations
must be exactly equal, on the host and on the device path."""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import jax.numpy as jnp
import morton_ties
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
    """The JAX package's permutation where the 30-bit keys differ; inside a
    tie, the order of the port's fine key (``morton_keys_wide``)."""
    pos, mass = _bodies(n, 1, model)
    n = pos.shape[0]   # a galaxy collision adds its two central masses
    ids = np.arange(n, dtype=np.int32)
    jcols = jm.resort_cols(tuple(jnp.asarray(a) for a in (*pos.T, mass, ids)), n_real)
    tcols = tm.resort_cols((*_cols(pos), torch.from_numpy(mass.copy()),
                            torch.from_numpy(ids.copy())), n_real)
    order = tcols[4].numpy()
    morton_ties.assert_jax_order_but_ties(order[:n_real], np.asarray(jcols[4])[:n_real],
                                          morton_ties.keys(pos, n_real))
    wide = tm.morton_keys_wide(*_cols(pos), n_real).numpy()
    assert (np.diff(wide[order]) >= 0).all()         # the wide keys' order
    for got, want in zip(tcols[:4], (*pos.T, mass)):
        np.testing.assert_array_equal(got.numpy(), want[order])
    assert (order[n_real:] == np.arange(n_real, n)).all()   # padding last


def test_order_across_distinct_keys_equals_jax():
    """A galaxy's centre crowds thousands of bodies into one 30-bit cell:
    across cells the order is still the JAX package's."""
    from n_body_problem_tpu_torch.models.agora import agora_arrays

    pos, _, _ = agora_arrays(8192, seed=4)
    n_real = 8000
    keys = morton_ties.keys(pos, n_real)
    assert np.unique(keys).size < n_real - 1000       # many ties
    ids = np.arange(8192, dtype=np.int32)
    jperm = np.asarray(jm.resort_cols(tuple(jnp.asarray(a) for a in (*pos.T, ids)),
                                      n_real)[3])
    perm = tm.morton_order(*_cols(pos), n_real).numpy()
    morton_ties.assert_jax_order_but_ties(perm[:n_real], jperm[:n_real], keys)
    assert (perm[n_real:] == np.arange(n_real, 8192)).all()


def _one_cell(seed, count=3000):
    """Two corner bodies fix the box at 1,023 key cells a side; ``count``
    bodies are uniform inside the cell (517, 517, 517)."""
    rng = np.random.default_rng(seed)
    inner = 517.0 + rng.uniform(0.001, 0.999, (count, 3))
    return np.concatenate([[[0.0, 0.0, 0.0], [1023.0, 1023.0, 1023.0]],
                           inner]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_a_crowded_cell_is_ordered_by_the_fine_key(seed):
    """3,000 bodies in one 30-bit cell come out in the order of their place
    inside it (11 bits a dimension). A 128-body tile inside one octant of
    the cell spans under half its width on every axis, and the tiles'
    boxes hold under a quarter of the volume they do in the 30-bit order
    alone, where a stable sort keeps the bodies' order and every tile spans
    the whole cell."""
    pos = _one_cell(seed)
    n = pos.shape[0]
    keys = tm.morton_keys_cols(*_cols(pos), n)
    assert torch.unique(keys).numel() == 3
    perm = tm.morton_order(*_cols(pos), n).numpy()
    inner = perm[perm >= 2]
    t = pos[inner] - 517.0
    fine = np.zeros(len(t), np.int64)
    q = np.clip((t * 2048).astype(np.int64), 0, 2047)
    for b in range(11):
        for axis in range(3):
            fine |= ((q[:, axis] >> b) & 1) << (3 * b + axis)
    assert (np.diff(fine) > 0).all()
    octant = fine >> 30
    wide_volume = coarse_volume = 0.0
    for a in range(0, len(t) - 127, 128):
        tile = t[a:a + 128]
        extent = tile.max(0) - tile.min(0)
        if octant[a] == octant[a + 127]:
            assert (extent < 0.5).all(), extent
        wide_volume += extent.prod()
        coarse = pos[2 + a:2 + a + 128]            # the input order, kept by the 30-bit sort
        coarse_extent = coarse.max(0) - coarse.min(0)
        assert (coarse_extent > 0.9).all(), coarse_extent
        coarse_volume += coarse_extent.prod()
    assert wide_volume < 0.25 * coarse_volume, (wide_volume, coarse_volume)


def test_wide_keys_hold_the_30_bit_keys_on_top():
    """The top 30 bits are ``morton_keys_cols``' key, and padding sorts last
    with every bit set."""
    pos, _ = _bodies(6144, 5)
    n_real = 6000
    wide = tm.morton_keys_wide(*_cols(pos), n_real)
    assert wide.dtype == torch.int64
    np.testing.assert_array_equal((wide[:n_real] >> 33).numpy(),
                                  tm.morton_keys_cols(*_cols(pos), n_real)[:n_real].numpy())
    assert (wide[n_real:] == 2**63 - 1).all() and (wide[:n_real] < 2**63 - 1).all()


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
