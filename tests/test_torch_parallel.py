"""The port's exact ring and half ring in gloo worlds (tests/test_parallel.py:22-190).

The worlds of 8 and 5 are spawned once for the file (``parallel.spawn_ring``),
the world of 1 runs in this process, and each runs every case of its size
(``parallel.drive.run_cases``); the tests compare the numpy results. The same inputs, made by the JAX package's models, go through
the port's single-device step or ``Simulation`` and through the JAX package's
sharded step on its fake CPU devices, within the JAX test's tolerances. The
JAX tests' D = 16 and 32 meshes stay JAX-only.
"""

import torch_threads  # noqa: F401  (first: the CPU threads of this worker)

import jax
import numpy as np
import pytest
import torch.distributed as dist

import n_body_problem_tpu as jnb
from n_body_problem_tpu import diagnostics as jdiag
from n_body_problem_tpu.state import to_numpy as jax_to_numpy
from n_body_problem_tpu.parallel import make_ring_mesh as jax_mesh
from n_body_problem_tpu.parallel import make_sharded_step as jax_sharded_step
from n_body_problem_tpu.parallel import shard_state as jax_shard
from n_body_problem_tpu_torch import SimConfig, Simulation, from_numpy, make_step_fn
from n_body_problem_tpu_torch.parallel import make_ring_mesh, spawn_ring
from n_body_problem_tpu_torch.parallel.drive import run_cases

STEP_TOL = dict(rtol=1e-5, atol=1e-6)     # one step
RUN_TOL = dict(rtol=2e-5, atol=1e-5)      # several steps
DIRECT = SimConfig(solver="direct")
LEAPFROG = SimConfig(solver="direct", integrator="leapfrog")


def _state(n, seed, multiple=None):
    """A Plummer sphere of the JAX package, padded, as its numpy dict."""
    s = jnb.models.plummer(n, seed=seed)
    return jax_to_numpy(jnb.pad_state(s, multiple=multiple) if multiple else s)


def _jax_state(d):
    return jnb.make_state(d["pos"], d["vel"], d["mass"], d["eps"], acc=d["acc"],
                          n_real=int(d["n_real"]))


def _jax_steps(d, cfg, n_dev, steps, strategy="ring"):
    """The JAX package's sharded steps of the same state on ``n_dev`` of its
    fake CPU devices."""
    mesh = jax_mesh(n_dev, devices=jax.devices()[:n_dev])
    step = jax.jit(jax_sharded_step(jnb.SimConfig(**cfg.to_dict()), mesh, strategy=strategy))
    s = jax_shard(_jax_state(d), mesh)
    for _ in range(steps):
        s = step(s)
    return np.asarray(s.pos), np.asarray(s.vel)


def _port_steps(d, cfg, steps):
    """The port's single-device steps of the same state."""
    step, s = make_step_fn(cfg, "cpu"), from_numpy(d)
    for _ in range(steps):
        s = step(s)
    return s


def _cases8():
    ring = dict(kind="step", cfg=DIRECT, steps=1)
    cases = {
        "ring": dict(ring, state=_state(250, 0, 8)),
        "ring 5 leapfrog": dict(kind="step", cfg=LEAPFROG, steps=5, state=_state(120, 1, 8)),
        "kinetic": dict(kind="kinetic", state=_state(128, 2, 8)),
        "indivisible": dict(kind="shard_error", state=_state(100, 3)),
        "half 240": dict(ring, state=_state(240, 7, 8), strategy="half_ring"),
        "half 250": dict(ring, state=_state(250, 7, 8), strategy="half_ring"),
        "straddle": dict(ring, steps=3, state=_state(130, 19, 8), strategy="half_ring"),
        "wrapper": dict(kind="sim", cfg=LEAPFROG, state=_state(160, 11), steps=10,
                        strategy="half_ring"),
    }
    for run in ("repeat 1", "repeat 2"):   # tests/test_determinism.py:39
        cases[run] = dict(ring, steps=5, state=_state(120, 1, 8), strategy="half_ring")
    for strategy in ("ring", "half_ring"):
        cases[f"prime {strategy}"] = dict(kind="sim", cfg=LEAPFROG, state=_state(144, 23),
                                          steps=4, strategy=strategy)
        for solver in ("xla", "pallas"):
            cases[f"{solver} {strategy}"] = dict(ring, state=_state(2000, 13, 8 * 256),
                                                 strategy=strategy, local_solver=solver)
        cases[f"ranks {strategy}"] = dict(kind="ranks", cfg=DIRECT, state=_state(250, 0, 8),
                                          strategy=strategy)
        cases[f"replay {strategy}"] = dict(kind="replay", cfg=LEAPFROG, state=_state(160, 29),
                                           steps=3, strategy=strategy)
    return cases


def _world(n_dev, cases):
    return dict(zip(cases, spawn_ring(run_cases, n_dev, device_type="cpu",
                                      args=(list(cases.values()),))))


@pytest.fixture(scope="module")
def world8():
    cases = _cases8()
    return cases, _world(8, cases)


@pytest.fixture(scope="module")
def world5():
    cases = {"odd": dict(kind="step", cfg=LEAPFROG, steps=1, state=_state(98, 8, 5),
                         strategy="half_ring")}
    return cases, _world(5, cases)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo world of one rank, in this process (a spawned rank would cost
    its start-up and nothing else)."""
    cases = {s: dict(kind="step", cfg=DIRECT, steps=1, state=_state(64, 9, 1), strategy=s)
             for s in ("ring", "half_ring")}
    rendezvous = (tmp_path_factory.mktemp("world1") / "rendezvous").as_uri()
    dist.init_process_group("gloo", init_method=rendezvous, world_size=1, rank=0)
    try:
        return cases, dict(zip(cases, run_cases(make_ring_mesh(1, device="cpu"),
                                                list(cases.values()))))
    finally:
        dist.destroy_process_group()


def _check_step(case, got, n_dev, tol, vel=True):
    """A world's steps against the port's single device and the JAX
    package's sharded steps."""
    cfg, steps = case["cfg"], case["steps"]
    want = _port_steps(case["state"], cfg, steps)
    np.testing.assert_allclose(got["pos"], want.pos.numpy(), **tol)
    jpos, jvel = _jax_steps(case["state"], cfg, n_dev, steps, case.get("strategy", "ring"))
    np.testing.assert_allclose(got["pos"], jpos, **tol)
    if vel:
        np.testing.assert_allclose(got["vel"], want.vel.numpy(), **tol)
        np.testing.assert_allclose(got["vel"], jvel, **tol)


@pytest.mark.parametrize("strategy", ["ring", "half_ring"])
def test_sharded_run_is_its_eager_loop_bitwise(world8, strategy):
    """``ShardedSimulation.run`` (its programs, called directly on the CPU)
    against its eager loop (``sharded.eager_run``) from the same state, two
    calls of 3 leapfrog steps: the gathered state and ``sort_perm``, to the
    bit."""
    _, res = world8
    for call in res[f"replay {strategy}"]:
        for k, want in call["eager"].items():
            np.testing.assert_array_equal(call["run"][k], want, err_msg=k)
    assert int(call["run"]["step"]) == 6


def test_sharded_run_deterministic(world8):
    """The half ring run twice for 5 steps gives the same bits
    (tests/test_determinism.py:39)."""
    _, got = world8
    np.testing.assert_array_equal(got["repeat 1"]["pos"], got["repeat 2"]["pos"])
    np.testing.assert_array_equal(got["repeat 1"]["vel"], got["repeat 2"]["vel"])


def test_ring_force_matches_direct(world8):
    cases, res = world8
    _check_step(cases["ring"], res["ring"], 8, STEP_TOL)


def test_ring_multi_step_trajectory(world8):
    cases, res = world8
    _check_step(cases["ring 5 leapfrog"], res["ring 5 leapfrog"], 8, RUN_TOL, vel=False)
    assert res["ring 5 leapfrog"]["step"] == 5


def test_sharded_energy_psum(world8):
    cases, res = world8
    want = float(jdiag.kinetic_energy(_jax_state(cases["kinetic"]["state"])))
    assert res["kinetic"] == pytest.approx(want, rel=1e-6)


def test_shard_state_requires_divisibility(world8):
    _, res = world8
    assert "not divisible by mesh size 8" in res["indivisible"]


@pytest.mark.parametrize("n_real", [240, 250])  # even-D gate + odd sizes
def test_half_ring_matches_direct(world8, n_real):
    cases, res = world8
    _check_step(cases[f"half {n_real}"], res[f"half {n_real}"], 8, STEP_TOL)


def test_half_ring_odd_device_count(world5):
    cases, res = world5
    _check_step(cases["odd"], res["odd"], 5, STEP_TOL, vel=False)


@pytest.mark.parametrize("strategy", ["ring", "half_ring"])
def test_single_device_mesh(world1, strategy):
    cases, res = world1
    _check_step(cases[strategy], res[strategy], 1, STEP_TOL, vel=False)


def test_sharded_simulation_wrapper(world8):
    cases, res = world8
    got = res["wrapper"]
    ref = Simulation(LEAPFROG, from_numpy(cases["wrapper"]["state"]), device="cpu")
    ref.run(10)
    np.testing.assert_allclose(got["pos"], ref.state.pos.numpy(), **RUN_TOL)
    assert got["diag"]["step"] == 10 and got["diag"]["overspeed"] == 0


@pytest.mark.parametrize("strategy", ["ring", "half_ring"])
def test_pallas_local_solver_matches_xla(world8, strategy):
    """The kernel's plain twin as the stage solver (the JAX package's
    interpret mode) against the plain broadcast."""
    _, res = world8
    np.testing.assert_allclose(res[f"pallas {strategy}"]["pos"], res[f"xla {strategy}"]["pos"],
                               **STEP_TOL)


def test_uneven_real_count_straddles_shards(world8):
    """130 real bodies padded to 136 over 8 shards: the padding crosses a
    shard boundary and stays inert over three steps."""
    cases, res = world8
    got = res["straddle"]
    assert got["pos"].shape == (136, 3)
    _check_step(cases["straddle"], got, 8, RUN_TOL, vel=False)
    assert np.all(np.isfinite(got["vel"][130:]))


@pytest.mark.parametrize("strategy", ["ring", "half_ring"])
def test_sharded_leapfrog_prime_matches_single_chip(world8, strategy):
    cases, res = world8
    got = res[f"prime {strategy}"]
    ref = Simulation(LEAPFROG, from_numpy(cases[f"prime {strategy}"]["state"]), device="cpu")
    np.testing.assert_allclose(got["acc0"], ref.state.acc.numpy(), **STEP_TOL)
    ref.run(4)
    np.testing.assert_allclose(got["pos"], ref.state.pos.numpy(), **RUN_TOL)


@pytest.mark.parametrize("strategy", ["ring", "half_ring"])
def test_rank_by_rank_equals_the_world(world8, strategy):
    """``ring_acc_ranks`` (every rank in one process, the visiting tiles
    sliced) computes bitwise what the world's collectives deliver: the form
    the smoke run checks on one card."""
    _, res = world8
    got = res[f"ranks {strategy}"]
    np.testing.assert_array_equal(got["ranks"], got["world"])
