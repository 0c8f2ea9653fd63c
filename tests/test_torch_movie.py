"""``Simulation.movie`` and ``Simulation.trajectory`` of the port against the
JAX package's, on the CPU.

Frames agree within rtol 1e-5 and atol 1e-6 x the frame's maximum (the
splat's float32 sums in another order, tests/test_torch_render.py);
positions within rtol 1e-5 and atol 1e-5 (the forces' float32 sums in
another order, over the few steps taken). The treecode runs pin their
capacities as tests/test_torch_treecode_sim.py does, so that both packages
take the hierarchical or the flat path off the TPU and the GPU; the JAX
package's own 4,096-body movie tests are ``slow``, so the parity cases run
at 2,048 bodies, and the port is held against its own ``run`` at 4,096.
Each frame is a program of the run (``graphs.frame_program``), held to the
bit to the eager frame loop (``simulation.eager_movie``,
``eager_trajectory``) on every path.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import morton_ties
import numpy as np
import pytest
import torch

import n_body_problem_tpu as jnb
import n_body_problem_tpu_torch as tnb
from n_body_problem_tpu.render import OrbitCamera as JaxCamera
from n_body_problem_tpu_torch.ops.registry import tree_path
from n_body_problem_tpu_torch.render import OrbitCamera
from n_body_problem_tpu_torch.simulation import eager_movie, eager_trajectory

FRAME_RTOL, FRAME_ATOL = 1e-5, 1e-6   # atol x the frame's maximum
POS_TOL = dict(rtol=1e-5, atol=1e-5)


def _pinned(n, path, rebuild_every=4):
    """The capacities that make both packages take ``path`` at ``n`` bodies
    (32-body source tiles at 2,048, so that the hierarchy has its 64)."""
    src = 32 if n < 4096 else 64
    kw = dict(solver="treecode", tree_vip_tiles=8, tree_src_tile=src, tree_max_near=64,
              tree_rebuild_every=rebuild_every)
    if path == "hier":
        return dict(kw, tree_hier=True, tree_tile=128, tree_flat_cap=(n // 128) * 64 * 8,
                    tree_far_cap=(n // 128) * 64 * 8)
    return dict(kw, tree_flat_cap=(n // 32) * 64)


def _pair(cfg, n, seed):
    js = jnb.Simulation(jnb.SimConfig(donate=False, **cfg), jnb.models.plummer(n, seed=seed))
    ts = tnb.Simulation(tnb.SimConfig(**cfg), tnb.models.plummer(n, seed=seed), device="cpu")
    return js, ts


def _assert_frames_close(got, want):
    assert got.shape == want.shape
    assert want.max() > 0, "blank frames"
    np.testing.assert_allclose(got, want, rtol=FRAME_RTOL, atol=FRAME_ATOL * want.max())


def test_direct_movie_and_trajectory_match_jax():
    js, ts = _pair(dict(solver="direct"), 256, seed=1)
    kw = dict(width=64, height=48)
    want = np.asarray(js.movie(6, 3, JaxCamera(distance=2.0), (1.0, 1.0, 1.0), **kw))
    got = ts.movie(6, 3, OrbitCamera(distance=2.0), (1.0, 1.0, 1.0), **kw)
    assert got.shape == (2, 48, 64, 3) and got.device.type == "cpu"
    _assert_frames_close(got.numpy(), want)
    want = np.asarray(js.trajectory(4, save_every=2))
    got = ts.trajectory(4, save_every=2)
    assert got.shape == (2, 256, 3)
    np.testing.assert_allclose(got.numpy(), want, **POS_TOL)
    np.testing.assert_allclose(ts.state.pos.numpy(), np.asarray(js.state.pos), **POS_TOL)
    assert int(ts.state.step) == int(js.state.step) == 10
    assert ts.wall_seconds > 0


@pytest.mark.parametrize("path,method", [("hier", "movie"), ("flat", "trajectory")])
def test_treecode_matches_jax(path, method):
    """The chunked treecode movie (hierarchical) and trajectory (flat)
    against the JAX package's: 2 frames of 4 steps each, one rebuild a
    frame. The final bodies are in the JAX package's slot order but inside
    a tie of their 30-bit Morton keys (tests/morton_ties.py)."""
    js, ts = _pair(_pinned(2048, path), 2048, seed=7)
    assert tree_path(ts.cfg) == path and js._jit_tree_movie is not None
    if method == "movie":
        want = np.asarray(js.movie(8, 4, JaxCamera(distance=2.0), width=64, height=64))
        got = ts.movie(8, 4, OrbitCamera(distance=2.0), width=64, height=64)
        _assert_frames_close(got.numpy(), want)
    else:
        want = np.asarray(js.trajectory(8, save_every=4))
        got = ts.trajectory(8, save_every=4)
        np.testing.assert_allclose(got.numpy(), want, **POS_TOL)
    # The last resort (step 4): the JAX package's order where the 30-bit
    # keys differ, inside a tie the port's fine key; positions by body.
    at4 = tnb.Simulation(tnb.SimConfig(**_pinned(2048, path)), tnb.models.plummer(2048, seed=7),
                         device="cpu")
    at4.run(4)
    keys, order = morton_ties.last_resort(at4)
    morton_ties.assert_jax_order_but_ties(ts.sort_perm, js.sort_perm, keys)
    np.testing.assert_array_equal(ts.sort_perm, order)
    np.testing.assert_allclose(_by_body(ts.state.pos.numpy(), ts.sort_perm),
                               _by_body(np.asarray(js.state.pos), js.sort_perm), **POS_TOL)
    assert int(ts.state.step) == int(js.state.step) == 8
    assert float(ts.state.time) == pytest.approx(float(js.state.time), rel=1e-6)


def _by_body(rows, perm):
    """Rows (slot order) indexed by original body id (``perm[i]``: the id
    of the body at slot i)."""
    out = np.empty((len(perm), 3), np.float32)
    out[np.asarray(perm)] = rows[: len(perm)]
    return out


def test_treecode_movie_and_trajectory_equal_run():
    """With ``render_every == tree_rebuild_every`` = 2 the hierarchical
    movie takes run()'s very chunks (two of 2 steps): its final state
    equals run()'s to the bit (atol=0), as do its permutation and lists. The trajectory's frames are
    in the call-entry order: its last frame is run()'s positions there, to
    the bit. (The flat path's chunks are held to run()'s by the next test,
    its trajectory to the JAX package's by the one before.)"""
    n = 4096
    cfg = tnb.SimConfig(**_pinned(n, "hier", rebuild_every=2))
    runs = [tnb.Simulation(cfg, tnb.models.plummer(n, seed=9), device="cpu") for _ in range(3)]
    ref, mov, traj = runs
    entry = traj.sort_perm.copy()
    ref.run(4)
    frames = mov.movie(4, 2, OrbitCamera(distance=2.0), width=32, height=32)
    assert frames.shape == (2, 32, 32, 3) and bool(frames.isfinite().all())
    assert float(frames.max()) > 0
    for field in ("pos", "vel", "acc", "time", "step"):
        np.testing.assert_array_equal(getattr(mov.state, field).numpy(),
                                      getattr(ref.state, field).numpy(), err_msg=field)
    np.testing.assert_array_equal(mov.sort_perm, ref.sort_perm)
    assert mov.tree_lists is not None
    for got, want in zip(mov.tree_lists, ref.tree_lists):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    hist = traj.trajectory(4, save_every=2).numpy()
    assert hist.shape == (2, n, 3)
    np.testing.assert_array_equal(_by_body(hist[-1], entry),
                                  _by_body(ref.state.pos.numpy(), ref.sort_perm))
    np.testing.assert_array_equal(traj.state.pos.numpy(), ref.state.pos.numpy())
    # Row r is the same body in both frames: it moves little in 2 steps,
    # where a row of another Morton order would jump by the system's size.
    disp = np.linalg.norm(hist[1][:n] - hist[0][:n], axis=1)
    assert np.median(disp) < 0.1


def test_movie_cadence_restarts_at_every_frame():
    """Each frame advances ``render_every`` steps as its own chunks
    (divmod(render_every, r)): with r = 3 and 2 steps a frame, 4 steps are
    the chunks 2, 2 of run(2) twice, not run(4)'s 3, 1. On the flat path."""
    n = 2048
    cfg = tnb.SimConfig(**_pinned(n, "flat", rebuild_every=3))
    mov = tnb.Simulation(cfg, tnb.models.plummer(n, seed=5), device="cpu")
    ref = tnb.Simulation(cfg, tnb.models.plummer(n, seed=5), device="cpu")
    mov.movie(4, 2, OrbitCamera(distance=2.0), width=16, height=16)
    ref.run(2)
    ref.run(2)
    np.testing.assert_array_equal(mov.state.pos.numpy(), ref.state.pos.numpy())
    np.testing.assert_array_equal(mov.sort_perm, ref.sort_perm)
    assert int(mov.state.step) == 4


def test_dense_tree_long_span_refused():
    """The dense treecode path cannot re-sort inside movie()/trajectory():
    spans beyond 4 rebuild cadences are refused, short ones run."""
    cfg = tnb.SimConfig(solver="treecode", tree_vip_tiles=8, tree_max_near=32,
                        tree_rebuild_every=4, tree_flat_cap=0)
    sim = tnb.Simulation(cfg, tnb.models.plummer(1024, seed=3), device="cpu")
    assert tree_path(sim.cfg) == "dense"
    with pytest.raises(ValueError, match="re-sort"):
        sim.trajectory(64, save_every=8)
    with pytest.raises(ValueError, match="re-sort"):
        sim.movie(64, render_every=8, camera=OrbitCamera(distance=2.0), width=16, height=16)
    hist = sim.trajectory(8, save_every=8)
    assert hist.shape == (1, 1024, 3) and int(sim.state.step) == 8
    np.testing.assert_array_equal(hist[0].numpy(), sim.state.pos.numpy())


@pytest.mark.parametrize("method", ["movie", "trajectory"])
def test_span_must_be_a_multiple(method):
    sim = tnb.Simulation(tnb.SimConfig(solver="direct"), tnb.models.plummer(16, seed=0),
                         device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        if method == "movie":
            sim.movie(5, 2, OrbitCamera())
        else:
            sim.trajectory(5, 2)


# two cameras and scales: the second call of a movie loads them into the
# buffers of the program the first call made
CAMERAS = ((OrbitCamera(distance=2.0), (0.0, 0.0, 0.0)),
           (OrbitCamera(theta_deg=40.0, phi_deg=-25.0, distance=3.0), (1.0, 0.5, 0.25)))
FIELDS = ("pos", "vel", "mass", "eps", "acc", "time", "step")


@pytest.mark.parametrize("path", ["hier", "flat", "dense", "direct"])
def test_frames_are_the_eager_frame_loop_bitwise(path):
    """Two ``movie`` calls (another camera and scale the second time), then
    a ``trajectory``, each of two frames a step apart, through the frame
    programs: the frames, the state and ``sort_perm`` are the eager frame
    loop's from the same state, to the bit, on the hierarchical and flat
    paths (each frame its own chunk), the dense path and an exact solver."""
    if path == "direct":
        cfg, n = dict(solver="direct"), 256
    elif path == "dense":
        cfg, n = dict(solver="treecode", tree_rebuild_every=2), 1024
    else:
        cfg, n = _pinned(2048, path, rebuild_every=2), 2048
    sim = tnb.Simulation(tnb.SimConfig(integrator="leapfrog", **cfg),
                         tnb.models.plummer(n, seed=3), device="cpu")
    assert path == "direct" or tree_path(sim.cfg) == path
    kw = dict(width=24, height=16)
    calls = [(lambda c=c: eager_movie(sim, 2, 1, *c, **kw), lambda c=c: sim.movie(2, 1, *c, **kw))
             for c in CAMERAS]
    calls.append((lambda: eager_trajectory(sim, 2), lambda: sim.trajectory(2)))
    for eager, replayed in calls:
        want, state, perm = eager()
        got = replayed()
        assert got.shape == want.shape and float(got.abs().max()) > 0
        assert torch.equal(got, want)
        for f in FIELDS:
            assert torch.equal(getattr(sim.state, f), getattr(state, f)), f
        np.testing.assert_array_equal(sim.sort_perm, perm)
    assert {"movie 24x16", "trajectory"} <= set(sim._static._programs) & set(sim._static.buffers)
