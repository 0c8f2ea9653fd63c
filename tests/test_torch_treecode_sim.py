"""The port's treecode Simulation against the JAX package's, on the CPU.

The hierarchical run loop (Morton resort + acceptance build every
``tree_rebuild_every`` steps, then near/far/VIP forces and the update)
with the capacities pinned as tests/test_treecode_hier.py:235-237 pins
them, so both packages take the same path off the TPU/GPU.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import morton_ties
import numpy as np
import pytest
import torch

import n_body_problem_tpu as jnb
import n_body_problem_tpu_torch as tnb
from n_body_problem_tpu.ops import treecode as jtc
from n_body_problem_tpu_torch.ops import treecode as ttc
from n_body_problem_tpu_torch.ops.registry import make_force_fn

N = 4096
PINNED = dict(solver="treecode", tree_flat_cap=64 * 32 * 4,
              tree_far_cap=32 * jtc.FAR_ENTRIES * 8, tree_vip_tiles=8,
              tree_rebuild_every=4)


def _unsorted(pos, perm):
    """Rows of ``pos`` back in the input order (``perm[i]`` = input index
    of the body at slot i)."""
    inv = np.empty(len(perm), int)
    inv[np.asarray(perm)] = np.arange(len(perm))
    return np.asarray(pos)[: len(perm)][inv]


@pytest.mark.parametrize("integrator", ["semi_implicit_euler", "leapfrog"])
def test_treecode_simulation_matches_jax(integrator):
    kw = dict(integrator=integrator, **PINNED)
    js = jnb.Simulation(jnb.SimConfig(donate=False, **kw), jnb.models.plummer(N, seed=11))
    ts = tnb.Simulation(tnb.SimConfig(**kw), tnb.models.plummer(N, seed=11), device="cpu")
    for field in ("tree_tile", "tree_max_near", "tree_far_max", "tree_vip_tiles",
                  "morton_sort"):
        assert getattr(ts.cfg, field) == getattr(js.cfg, field), field
    assert ts.cfg.tree_tile == ttc.DEFAULT_HIER_TILE
    js.run(8)
    ts.run(8)
    # The last resort (step 4) orders the bodies as the JAX package's does
    # where their 30-bit keys differ, inside a tie by the port's fine key.
    at4 = tnb.Simulation(tnb.SimConfig(**kw), tnb.models.plummer(N, seed=11), device="cpu")
    at4.run(4)
    keys, order = morton_ties.last_resort(at4)
    morton_ties.assert_jax_order_but_ties(ts.sort_perm, js.sort_perm, keys)
    np.testing.assert_array_equal(ts.sort_perm, order)
    pj = _unsorted(js.state.pos, js.sort_perm)
    pt = _unsorted(ts.state.pos.numpy(), ts.sort_perm)
    assert np.isfinite(pt).all()
    # 1e-4: float32 force sums in another order, over 8 steps.
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
    ref = tnb.Simulation(tnb.SimConfig(solver="direct", integrator=integrator),
                         tnb.models.plummer(N, seed=11), device="cpu")
    ref.run(8)
    # Both within 1e-3 of the exact solver (tests/test_treecode_hier.py:252).
    assert np.abs(pt - ref.state.pos.numpy()).max() < 1e-3
    assert np.abs(pj - ref.state.pos.numpy()).max() < 1e-3
    dt, dj = ts.diagnostics(), js.diagnostics()
    for key in ("step", "n_real", "n_padded", "overspeed"):
        assert dt[key] == dj[key], key
    assert dt["time"] == pytest.approx(dj["time"], rel=1e-6)


def test_treecode_run_tracks_ids_over_calls():
    """Two runs compose their device permutations into sort_perm."""
    ts = tnb.Simulation(tnb.SimConfig(**PINNED), tnb.models.plummer(N, seed=2), device="cpu")
    once = tnb.Simulation(tnb.SimConfig(**PINNED), tnb.models.plummer(N, seed=2), device="cpu")
    ts.run(4)
    ts.run(4)
    once.run(8)
    assert sorted(ts.sort_perm.tolist()) == list(range(N))
    np.testing.assert_allclose(_unsorted(ts.state.pos.numpy(), ts.sort_perm),
                               _unsorted(once.state.pos.numpy(), once.sort_perm),
                               rtol=0, atol=1e-5)
    assert int(ts.state.step) == 8


def test_treecode_force_fn_builds_its_own_lists():
    """``make_force_fn`` for direct callers (and ``prime_leapfrog``) on
    Morton-sorted bodies: within the hier envelope of the direct sum."""
    sim = tnb.Simulation(tnb.SimConfig(**PINNED), tnb.models.plummer(N, seed=4), device="cpu")
    s = sim.state
    acc = make_force_fn(sim.cfg, "cpu", s.n)(s.pos, s.mass)
    exact = tnb.ops.direct_acc(s.pos, s.mass, eps2=1e-6, compensate=0.1)
    err = ((acc - exact).norm(dim=1) / exact.norm(dim=1)).numpy()
    assert np.percentile(err, 99) < 2.5e-3 and np.median(err) < 5e-4
    step = sim.step_fn(s)
    torch.testing.assert_close(step.acc, acc, rtol=0, atol=0)


def test_treecode_run_keeps_the_lists_it_stepped_with():
    """``Simulation.tree_lists`` are the lists of the last chunk, in the
    state's slot order: a leapfrog step's stored acceleration is the force
    on the final positions with exactly those lists."""
    from n_body_problem_tpu_torch.ops.registry import tree_kwargs

    sim = tnb.Simulation(tnb.SimConfig(integrator="leapfrog", **PINNED),
                         tnb.models.plummer(N, seed=5), device="cpu")
    assert sim.tree_lists is None
    sim.run(6)   # chunks of 4 and 2 steps
    lists = sim.tree_lists
    assert len(lists) == 5
    s = sim.state
    acc = ttc.treecode_acc_hier(s.pos, s.mass, lists, **tree_kwargs(sim.cfg)[1])
    torch.testing.assert_close(acc, s.acc, rtol=0, atol=0)
    sim.run(0)
    assert sim.tree_lists is lists


def test_decompose_split_reproduces_the_jax_record():
    """``treecode_profile --decompose``'s arithmetic is the JAX tool's
    (tools/decompose_step.py:168-175): from the legs of the JAX record it
    gives the record's integrator, amortized rebuild and glue."""
    import json
    import pathlib

    from n_body_problem_tpu_torch.treecode_profile import decompose_split

    path = pathlib.Path(__file__).resolve().parents[1] / "validation/decompose20k_20260819.json"
    rec = json.loads(path.read_text())
    got = decompose_split(rec, rec["rebuild_every"])
    assert set(got) == {"integrator_ms", "amortized_rebuild_ms", "glue_ms"}
    for key, value in got.items():
        assert abs(value - rec[key]) <= 1e-9, key


def test_force_error_probe_measures_relative_error():
    """The chip probe's error measure: 0 on the exact force, and the
    relative size of a uniform perturbation, on all bodies or a sample."""
    from n_body_problem_tpu_torch.treecode_profile import force_error

    s = tnb.state.pad_state_to(tnb.models.plummer(1000, seed=6), 1024)
    cfg = tnb.SimConfig()
    exact = tnb.ops.direct_acc(s.pos, s.mass, eps2=cfg.eps2, compensate=cfg.compensate)
    assert force_error(exact, s.pos, s.mass, 1000, cfg) == pytest.approx((0, 0), abs=2e-6)
    for sample in (None, 300):
        p99, med = force_error(exact * 1.001, s.pos, s.mass, 1000, cfg, sample)
        assert p99 == pytest.approx(1e-3, rel=1e-2) and med == pytest.approx(1e-3, rel=1e-2)
