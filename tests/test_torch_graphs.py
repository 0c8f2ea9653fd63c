"""``Simulation`` on the static buffers of ``graphs.StaticRun`` against the
eager loop, on the CPU.

On the CPU a program of the run is called directly where the card replays
its CUDA graph, so a run is bitwise the eager loop's
(``simulation.make_treecode_run``, ``run_steps``) on every path: the
hierarchical and flat treecode paths at 2,048 bodies with their capacities
pinned (as tests/test_torch_movie.py pins them), the dense path at 1,024,
and an exact solver. Each run takes two whole chunks of
``tree_rebuild_every`` = 2 steps and a remainder. The card's replays are
held to the same loop by the ``cuda`` cases of tests/test_torch_cuda.py and
by ``chip_smoke.py`` phase 13.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import numpy as np
import pytest
import torch

import n_body_problem_tpu as jnb
import n_body_problem_tpu_torch as tnb
from n_body_problem_tpu_torch.graphs import StaticRun, clone_state
from n_body_problem_tpu_torch.ops import cuda_treecode
from n_body_problem_tpu_torch.ops.registry import tree_path
from n_body_problem_tpu_torch.render import OrbitCamera
from n_body_problem_tpu_torch.simulation import make_step_fn, make_treecode_run, run_steps

R = 2                 # tree_rebuild_every
STEPS = 2 * R + 1     # two whole chunks and a remainder
FIELDS = ("pos", "vel", "mass", "eps", "acc", "time", "step")


def _cfg(path: str, **kw) -> tnb.SimConfig:
    """A treecode config that takes ``path`` on the CPU."""
    base = dict(solver="treecode", tree_rebuild_every=R, **kw)
    if path == "dense":
        return tnb.SimConfig(**base)
    base.update(tree_vip_tiles=8, tree_src_tile=32, tree_max_near=64)
    if path == "hier":
        return tnb.SimConfig(tree_hier=True, tree_tile=128, tree_flat_cap=16 * 64 * 8,
                             tree_far_cap=16 * 64 * 8, **base)
    return tnb.SimConfig(tree_flat_cap=64 * 64, **base)


def _sim(path: str, seed: int = 3, **kw) -> tnb.Simulation:
    sim = tnb.Simulation(_cfg(path, **kw), tnb.models.plummer(1024 if path == "dense" else 2048,
                                                              seed=seed), device="cpu")
    assert tree_path(sim.cfg) == path
    return sim


def _assert_same_state(got, want):
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("integrator", ["semi_implicit_euler", "leapfrog"])
@pytest.mark.parametrize("path", ["hier", "flat", "dense"])
def test_run_is_the_eager_loop_bitwise(path, integrator):
    """Two ``run`` calls of two chunks and a remainder each: the state,
    ``sort_perm``, ``tree_lists``, step and time are the eager loop's."""
    sim = _sim(path, integrator=integrator)
    ref = make_treecode_run(sim.cfg)
    state, perm = clone_state(sim.state), sim.sort_perm.copy()
    for call in (1, 2):
        state, ids, aux = ref(state, STEPS)
        perm = perm[ids[: state.n_real].numpy()]
        got = sim.run(STEPS)
        _assert_same_state(got, state)
        np.testing.assert_array_equal(sim.sort_perm, perm)
        assert len(sim.tree_lists) == len(aux)
        for have, want in zip(sim.tree_lists, aux):
            assert torch.equal(have, want)
        assert int(got.step) == call * STEPS
        assert float(got.time) == pytest.approx(call * STEPS * sim.cfg.dt, rel=1e-6)


def test_exact_run_is_run_steps_bitwise():
    """An exact solver replays one step: two calls are ``run_steps``'s."""
    sim = tnb.Simulation(tnb.SimConfig(solver="direct", integrator="leapfrog"),
                         tnb.models.plummer(512, seed=4), device="cpu")
    state = clone_state(sim.state)
    step = make_step_fn(sim.cfg, "cpu", sim.state.n)
    for _ in range(2):
        state = run_steps(state, step, STEPS)
        _assert_same_state(sim.run(STEPS), state)


@pytest.mark.parametrize("path", ["hier", "direct"])
def test_a_returned_state_is_not_rewritten(path):
    """What ``run`` hands out (the state, the lists) is a copy: a later
    ``run`` steps the static buffers and leaves it as it was."""
    if path == "direct":
        sim = tnb.Simulation(tnb.SimConfig(solver="direct"), tnb.models.plummer(256, seed=1),
                             device="cpu")
    else:
        sim = _sim(path)
    first = sim.run(STEPS)
    kept = clone_state(first)
    lists = sim.tree_lists
    kept_lists = None if lists is None else [a.clone() for a in lists]
    second = sim.run(STEPS)
    assert second is sim.state and second is not first
    assert not torch.equal(second.pos, first.pos)
    _assert_same_state(first, kept)
    for f in FIELDS:
        assert getattr(first, f) is not getattr(sim._static.state, f), f
    if lists is not None:
        assert sim.tree_lists is not lists
        for have, want in zip(lists, kept_lists):
            assert torch.equal(have, want)


@pytest.mark.parametrize("path", ["hier", "dense"])
def test_trajectory_and_movie_take_the_eager_spans(path):
    """Each frame's span restarts the chunks (hierarchical and flat paths)
    or takes ``step_fn``'s steps (dense path), as the eager loop does; the
    trajectory's frames are in the call-entry order on the chunked paths.
    The movie and the trajectory end in the same state."""
    n_steps, every = 6, 3                  # spans of one chunk and a remainder
    traj, mov = _sim(path), _sim(path)
    frames = traj.trajectory(n_steps, save_every=every)
    state = clone_state(_sim(path).state)
    if path == "dense":
        step = make_step_fn(traj.cfg, "cpu", state.n)
        want = []
        for _ in range(n_steps // every):
            state = run_steps(state, step, every)
            want.append(state.pos)
    else:
        ref = make_treecode_run(traj.cfg)
        ids, want = ref.start(state), []
        for _ in range(n_steps // every):
            state, ids, _ = ref.advance(state, ids, every)
            want.append(torch.empty_like(state.pos).index_copy_(0, ids.long(), state.pos))
        state = ref.finish(state, n_steps)
    assert torch.equal(frames, torch.stack(want))
    _assert_same_state(traj.state, state)
    mov.movie(n_steps, every, OrbitCamera(distance=2.0), width=16, height=16)
    _assert_same_state(mov.state, traj.state)
    np.testing.assert_array_equal(mov.sort_perm, traj.sort_perm)


def test_cpu_programs_are_direct_calls_and_count_nothing():
    """On the CPU nothing is captured: a program is its function, called
    once a step, and the kernels' counters stay where they were."""
    sim = _sim("dense")
    before = cuda_treecode.near_panel.launches
    sim.run(STEPS)
    g = sim._static
    assert isinstance(g, StaticRun) and g._pool is None and sim.capture_seconds == 0.0
    assert all(p.graph is None for p in g._programs.values())
    assert set(g._programs) == {"treecode.resort", "treecode.build", "treecode.step"}
    assert cuda_treecode.near_panel.launches == before
    calls = []
    prog = g.program("counting", lambda run: calls.append(run))
    g.repeat(prog, 3)
    assert calls == [g] * 3


def test_dense_run_with_a_remainder_matches_jax():
    """The dense path (the CPU's) at 1,024 bodies, two chunks and a
    remainder, against the JAX package's ``Simulation``: ``sort_perm``
    exactly, positions within tests/test_torch_treecode_sim.py's atol 1e-4."""
    kw = dict(solver="treecode", tree_rebuild_every=R)
    js = jnb.Simulation(jnb.SimConfig(donate=False, **kw), jnb.models.plummer(1024, seed=3))
    ts = tnb.Simulation(tnb.SimConfig(**kw), tnb.models.plummer(1024, seed=3), device="cpu")
    js.run(STEPS)
    ts.run(STEPS)
    np.testing.assert_array_equal(ts.sort_perm, np.asarray(js.sort_perm))
    np.testing.assert_allclose(ts.state.pos.numpy(), np.asarray(js.state.pos), rtol=0, atol=1e-4)
    assert int(ts.state.step) == int(js.state.step) == STEPS
