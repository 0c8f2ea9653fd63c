"""The port's state, models and checkpoints against the JAX package's.

The state is what moves between the two packages (this system has no
weights), so these comparisons are exact: same bits, same dtypes.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import numpy as np
import pytest
import torch

import n_body_problem_tpu as jnb
import n_body_problem_tpu_torch as tnb
from n_body_problem_tpu.io.checkpoint import load_checkpoint as jax_load
from n_body_problem_tpu.io.checkpoint import save_checkpoint as jax_save
from n_body_problem_tpu.state import to_numpy as jax_to_numpy
from n_body_problem_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from n_body_problem_tpu_torch.state import pad_state_to, unpad_state

_FIELDS = ("pos", "vel", "mass", "eps", "acc", "time", "step", "n_real")


def _jax_state(n=100, seed=0):
    """A JAX state with every field non-trivial: padding, acc, time, step."""
    rng = np.random.default_rng(seed)
    s = jnb.make_state(
        rng.standard_normal((n, 3)), rng.standard_normal((n, 3)),
        rng.uniform(0.1, 1.0, n), rng.uniform(0.0, 0.01, n),
        acc=rng.standard_normal((n, 3)), time=0.25, step=7)
    return jnb.pad_state(s, multiple=64)


def _assert_same(d_jax: dict, d_torch: dict) -> None:
    assert set(d_jax) == set(d_torch)
    for k in d_jax:
        assert d_jax[k].dtype == d_torch[k].dtype, k
        np.testing.assert_array_equal(d_torch[k], d_jax[k], err_msg=k)


def test_from_numpy_equals_jax_state():
    js = _jax_state()
    ts = tnb.from_numpy(jax_to_numpy(js))
    assert (ts.n, ts.n_real, ts.n_padding) == (js.n, js.n_real, js.n_padding)
    assert ts.pos.dtype == torch.float32 and ts.step.dtype == torch.int32
    _assert_same(jax_to_numpy(js), tnb.to_numpy(ts))
    np.testing.assert_array_equal(ts.real_mask().numpy(), np.asarray(js.real_mask()))


def test_make_state_matches_jax_from_float64():
    """float64 inputs round to the same float32 values in both packages."""
    rng = np.random.default_rng(1)
    args = (rng.standard_normal((33, 3)), rng.standard_normal((33, 3)),
            rng.uniform(size=33))
    _assert_same(jax_to_numpy(jnb.make_state(*args)),
                 tnb.to_numpy(tnb.make_state(*args)))


def test_make_state_validates_shapes():
    with pytest.raises(ValueError):
        tnb.make_state(np.zeros((4, 2)), np.zeros((4, 2)), np.zeros(4))
    with pytest.raises(ValueError):
        tnb.make_state(np.zeros((4, 3)), np.zeros((4, 3)), np.zeros(5))


def test_pad_unpad_roundtrip():
    state = tnb.models.plummer(100, seed=0)
    padded = tnb.pad_state(state, multiple=256, extra=1)
    assert padded.n == 257 and padded.n_real == 100
    assert float(padded.mass[100:].sum()) == 0.0
    _assert_same(jax_to_numpy(jnb.pad_state(jnb.models.plummer(100, seed=0),
                                            multiple=256, extra=1)),
                 tnb.to_numpy(padded))
    back = unpad_state(pad_state_to(state, 300))
    _assert_same(tnb.to_numpy(state), tnb.to_numpy(back))


def test_checkpoint_jax_to_torch(tmp_path):
    js = _jax_state(seed=2)
    cfg = jnb.SimConfig(dt=0.004, solver="pallas_symmetric", integrator="leapfrog")
    jax_save(tmp_path / "j.npz", js, cfg)
    ts, tcfg = load_checkpoint(tmp_path / "j.npz")
    _assert_same(jax_to_numpy(js), tnb.to_numpy(ts))
    assert tcfg.to_dict() == cfg.to_dict()


def test_checkpoint_torch_to_jax(tmp_path):
    ts = tnb.from_numpy(jax_to_numpy(_jax_state(seed=3)))
    cfg = tnb.SimConfig(dt=0.004, solver="pallas", pallas_tile_i=64)
    save_checkpoint(tmp_path / "t.npz", ts, cfg)
    js, jcfg = jax_load(tmp_path / "t.npz")
    _assert_same(jax_to_numpy(js), tnb.to_numpy(ts))
    assert jcfg.to_dict() == cfg.to_dict()


@pytest.mark.parametrize("name", sorted(jnb.models.MODELS))
def test_models_bit_identical(name):
    n = 300
    _assert_same(jax_to_numpy(jnb.models.make_model(name, n, seed=5)),
                 tnb.to_numpy(tnb.models.make_model(name, n, seed=5)))


def test_state_to_device_keeps_values():
    state = tnb.models.plummer(64, seed=0)
    moved = state.to("cpu")
    assert moved.device.type == "cpu" and moved.n_real == 64
    _assert_same(tnb.to_numpy(state), tnb.to_numpy(moved))
