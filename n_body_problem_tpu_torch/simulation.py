"""Step loop: build a step function and run it on a device.

Counterpart of ``n_body_problem_tpu.simulation``. Where the JAX package
jits a run into one device program (``lax.scan`` over the steps, the
movie's and the trajectory's frames inside it), :class:`Simulation` runs
on the static buffers of ``graphs.StaticRun``: on ``cuda`` each step (and
each treecode resort and acceptance build, and each frame) is the replay
of a CUDA graph captured on the first call, on the CPU the same function
called directly. Only the end of a call waits for the device.
:func:`run_trajectory` and :func:`run_with_frames`, the JAX package's
free functions of a step function, replay the same graphs of a run of
their own. :func:`run_steps`, :func:`make_treecode_run`,
:func:`eager_movie` and :func:`eager_trajectory` are the eager loop, a
Python loop of the same functions, kept as the reference.
"""

from __future__ import annotations

import dataclasses
import functools
import time as _time
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from n_body_problem_tpu_torch.config import SimConfig, resolve_vip_tiles
from n_body_problem_tpu_torch.graphs import (StaticRun, chunk_lengths, clone_state, frame_program,
                                             replay_chunks, step_program, tree_programs)
from n_body_problem_tpu_torch.ops import cuda_build, treecode
from n_body_problem_tpu_torch.ops.forces import required_padding
from n_body_problem_tpu_torch.ops.integrators import make_integrator, prime_leapfrog
from n_body_problem_tpu_torch.ops.registry import (
    make_force_fn,
    resolve_solver,
    tree_fns,
    tree_path,
)
from n_body_problem_tpu_torch.state import SimState, pad_state_to, unpad_state
from n_body_problem_tpu_torch.utils import profiling
from n_body_problem_tpu_torch.utils.morton import (
    apply_permutation,
    device_resort,
    morton_argsort,
)

StepFn = Callable[[SimState], SimState]


def make_step_fn(cfg: SimConfig, device_type: str = "cpu",
                 n: int | None = None) -> StepFn:
    """One simulation step ``state -> state`` (force + integrate)."""
    force_fn = make_force_fn(cfg, device_type, n)
    return make_integrator(cfg.integrator, force_fn, cfg.dt)


def run_steps(state: SimState, step_fn: StepFn, n_steps: int) -> SimState:
    """Advance ``n_steps`` steps."""
    for _ in range(n_steps):
        state = step_fn(state)
    return state


def _spans(n_steps: int, every: int, name: str) -> int:
    """The frames of a span of ``n_steps`` taken every ``every`` steps."""
    if n_steps % every:
        raise ValueError(f"n_steps must be a multiple of {name}")
    return n_steps // every


def run_frames(
    state: SimState,
    advance: Callable[[SimState, int], SimState],
    n_steps: int,
    every: int,
    name: str,
    frame_shape: tuple[int, ...],
    record: Callable[[torch.Tensor, SimState], object],
) -> tuple[SimState, torch.Tensor]:
    """Advance ``n_steps`` in spans of ``every`` steps (``advance(state,
    every)``); after span i, ``record(frames[i], state)`` fills frame i.
    Returns ``(state, frames[n_steps // every, *frame_shape])``, on the
    state's device: the movie's rendered frames (the reference's step+draw
    frame loop, kernel.cu:1191-1282, without its per-frame host
    round-trips) or the trajectory's positions."""
    frames = state.pos.new_empty((_spans(n_steps, every, name), *frame_shape))
    for i in range(len(frames)):
        state = advance(state, every)
        record(frames[i], state)
    return state, frames


def replay_frames(run: StaticRun, advance: Callable[[int], None], frame, key: str,
                  n_steps: int, every: int, name: str) -> torch.Tensor:
    """:func:`run_frames` on the loaded buffers of ``run``: each span
    ``advance(every)`` (replays of the run's step programs), then the replay
    of the ``frame`` program and one copy of its buffer ``key`` into the
    frames. No host sync."""
    out = run.buffers[key]

    def span(state: SimState, k: int) -> SimState:
        advance(k)
        return state

    def record(f: torch.Tensor, state: SimState) -> None:
        frame(run)
        f.copy_(out)

    return run_frames(run.state, span, n_steps, every, name, tuple(out.shape), record)[1]


def _step_frames(state: SimState, step_fn: StepFn, n_steps: int, every: int, name: str,
                 key: str, frame_shape: tuple[int, ...], record: Callable,
                 inputs: dict) -> tuple[SimState, torch.Tensor]:
    """:func:`run_trajectory`'s and :func:`run_with_frames`' run: a
    ``StaticRun`` of its own with the programs ``step`` (``step_fn``) and
    the frame ``key``, captured once on ``cuda``, then
    :func:`replay_frames`. Returns ``(state, frames)``."""
    _spans(n_steps, every, name)
    run = StaticRun(state)
    step = run.program("step", step_program(step_fn))
    frame = frame_program(run, key, frame_shape, record, inputs, False)
    if n_steps:
        run.capture(step, frame)
    run.load(state)
    frames = replay_frames(run, lambda k: run.repeat(step, k), frame, key, n_steps, every,
                           name)
    return run.unload(), frames


def run_trajectory(state: SimState, step_fn: StepFn, n_steps: int,
                   save_every: int = 1) -> tuple[SimState, torch.Tensor]:
    """Advance ``n_steps`` of ``step_fn``, stacking positions every
    ``save_every`` steps.

    Returns ``(final_state, pos_history[n_steps // save_every, N, 3])``, on
    the state's device. Where the JAX package scans (one device program),
    on ``cuda`` every step and every frame here is the replay of a CUDA
    graph captured in this call (``graphs``), with no host sync between
    frames; on the CPU the same functions are called directly, the eager
    loop. ``state`` is not changed.
    """
    return _step_frames(state, step_fn, n_steps, save_every, "save_every", "trajectory",
                        (state.n, 3), trajectory_frame, {})


def run_with_frames(state: SimState, step_fn: StepFn, n_steps: int, render_every: int,
                    view_projection, scale_factors, width: int,
                    height: int) -> tuple[SimState, torch.Tensor]:
    """Advance ``n_steps`` of ``step_fn``, rendering a frame of every body
    (``render.splat.splat_frame``) every ``render_every`` steps.

    Returns ``(state, frames[F, H, W, 3])``, on the state's device: the
    reference's step+draw frame loop, kernel.cu:1191-1282, without its
    per-frame host round-trips. The camera's ``view_projection`` (4, 4) and
    the ``scale_factors`` (3,) may be arrays or tensors; they are loaded
    into the run's buffers once a call. On ``cuda`` the steps and frames
    are replays of CUDA graphs, as in :func:`run_trajectory`.
    """
    return _step_frames(state, step_fn, n_steps, render_every, "render_every",
                        f"movie {width}x{height}", (height, width, 3),
                        functools.partial(movie_frame, width=width, height=height),
                        frame_inputs(state, view_projection, scale_factors))


class TreeParts(NamedTuple):
    """The pieces of a treecode run: ``resort(state, ids) -> (state, ids)``,
    ``build(state) -> aux``, ``step(state, aux) -> state`` (the force and the
    update of one step) and ``finish(state, n_steps) -> state`` (the time and
    step counter of the hierarchical and flat paths, set once at the end)."""
    rebuild_every: int
    resort: Callable
    build: Callable
    step: Callable
    finish: Callable


def tree_parts(cfg: SimConfig) -> TreeParts:
    """The :class:`TreeParts` of ``cfg``'s treecode path. The hierarchical
    and flat paths update positions in the loop and the time once at the
    end, as the JAX package's columnar run does; the dense path steps
    through the generic integrator, as the JAX package's dense run does."""
    dt = cfg.dt
    dense = tree_path(cfg) == "dense"
    build_fn, force = tree_fns(cfg)
    leapfrog = cfg.integrator == "leapfrog"

    def build(state: SimState):
        return build_fn(state.pos, state.mass)

    def step(state: SimState, aux) -> SimState:
        if dense:
            return make_integrator(cfg.integrator,
                                   lambda pos, mass: force(pos, mass, aux), dt)(state)
        st = profiling.stamper(state.device)   # the force stamps its own phases
        pos, vel, acc = state.pos, state.vel, state.acc
        if leapfrog:  # KDK, stored-acceleration form
            st.begin("update")
            vel = vel + acc * (0.5 * dt)
            pos = pos + vel * dt
            st.end()
            acc = force(pos, state.mass, aux)
            st.begin("update")
            vel = vel + acc * (0.5 * dt)
        else:
            acc = force(pos, state.mass, aux)
            st.begin("update")
            vel = vel + acc * dt
            pos = pos + vel * dt
        st.end()
        return dataclasses.replace(state, pos=pos, vel=vel, acc=acc)

    def finish(state: SimState, n_steps: int) -> SimState:
        if dense:
            return state
        return dataclasses.replace(
            state, time=state.time + torch.full_like(state.time, dt) * n_steps,
            step=state.step + n_steps)

    return TreeParts(cfg.tree_rebuild_every, device_resort, build, step, finish)


def make_treecode_run(cfg: SimConfig):
    """The treecode run as an eager loop, the reference of the graphs that
    ``Simulation.run`` replays (``graphs.tree_programs``): every
    ``cfg.tree_rebuild_every`` steps, Z-order the bodies on the device and
    rebuild the acceptance lists of the config's path
    (``ops.registry.tree_path``), then run the steps with both kept
    (:func:`tree_parts`).

    The resort is load-bearing: Morton tile locality decays as bodies move,
    and once open counts outgrow the static capacities the leaked tiles'
    multipole errors heat the core. Nothing in the loop waits for the host.
    The resort and the build are labelled for ``torch.profiler``
    (``treecode.resort``, ``treecode.build``).

    Returns ``run(state, n_steps) -> (state, ids, aux)``, where ``ids[i]``
    is the input slot of the body now at slot i and ``aux`` the acceptance
    lists the last chunk stepped with (in the returned state's slot order;
    None when ``n_steps`` is 0). ``cfg`` must carry the resolved tile, VIP
    count and capacities (``Simulation`` resolves them). ``run`` is
    ``finish(advance(state, start(state), n_steps))``, and carries the
    three as ``run.start``, ``run.advance`` and ``run.finish``: the
    movie and the trajectory take the same chunks between their frames
    (the cadence restarts at every frame).
    """
    parts = tree_parts(cfg)

    def advance(state: SimState, ids: torch.Tensor, n_steps: int):
        return chunk_loop(parts, state, ids, n_steps)

    def start(state: SimState):
        return torch.arange(state.n, dtype=torch.int32, device=state.device)

    def run(state: SimState, n_steps: int):
        state, ids, aux = advance(state, start(state), n_steps)
        return parts.finish(state, n_steps), ids, aux

    run.start, run.advance, run.finish = start, advance, parts.finish
    return run


def chunk_loop(parts: TreeParts, state: SimState, ids: torch.Tensor, n_steps: int):
    """The eager chunk loop of a treecode run (:class:`TreeParts`, one
    device's or a sharded strategy's): ``(state, ids, aux)`` after
    ``n_steps``, ``aux`` the lists of the last chunk (None for no steps)."""
    aux = None
    for length in chunk_lengths(n_steps, parts.rebuild_every):
        with record_function("treecode.resort"):
            state, ids = parts.resort(state, ids)
        with record_function("treecode.build"):
            aux = parts.build(state)
        for _ in range(length):
            state = parts.step(state, aux)
    return state, ids, aux


# ------------------------------------------------------------ the frames
def trajectory_frame(out: torch.Tensor, state: SimState, ids: torch.Tensor | None) -> None:
    """The trajectory's frame: the positions, scattered into the call-entry
    order by ``ids`` (the chunks' body permutation) on the chunked treecode
    paths, as they are elsewhere (``ids`` None)."""
    if ids is None:
        out.copy_(state.pos)
    else:
        out.index_copy_(0, ids.long(), state.pos)


def movie_frame(out: torch.Tensor, state: SimState, ids, *, mask, view_projection,
                scale_factors, width: int, height: int) -> None:
    """The movie's frame: the bodies splatted in their current slot order
    (``render.splat.splat_frame``)."""
    from n_body_problem_tpu_torch.render.splat import splat_frame

    out.copy_(splat_frame(state.pos, state.mass, mask, view_projection, scale_factors,
                          width=width, height=height))


def frame_inputs(state: SimState, view_projection, scale_factors) -> dict:
    """:func:`movie_frame`'s inputs on the state's device: the real mask,
    the view-projection and the scale factors (float32)."""
    as_dev = lambda a: torch.as_tensor(a, dtype=torch.float32, device=state.device)  # noqa: E731
    return dict(mask=state.real_mask(), view_projection=as_dev(view_projection),
                scale_factors=as_dev(scale_factors))


def _eager_frames(sim: "Simulation", n_steps: int, every: int, name: str,
                  frame_shape: tuple[int, ...], record, inputs: dict):
    """The movie's and the trajectory's eager loop on a copy of ``sim``'s
    state: each span through :func:`make_treecode_run`'s chunks (the
    hierarchical and flat paths) or :func:`run_steps` of ``sim.step_fn``,
    the frame recorded eagerly. Returns ``(frames, state, sort_perm)``;
    ``sim`` is unchanged."""
    state = clone_state(sim.state)
    if not sim._chunked():
        state, frames = run_frames(state, lambda s, k: run_steps(s, sim.step_fn, k), n_steps,
                                   every, name, frame_shape,
                                   lambda f, s: record(f, s, None, **inputs))
        return frames, state, sim.sort_perm
    ref = make_treecode_run(sim.cfg)
    ids = ref.start(state)

    def advance(s: SimState, k: int) -> SimState:
        nonlocal ids
        s, ids, _ = ref.advance(s, ids, k)
        return s

    state, frames = run_frames(state, advance, n_steps, every, name, frame_shape,
                               lambda f, s: record(f, s, ids, **inputs))
    return frames, ref.finish(state, n_steps), sim.sort_perm[ids[: state.n_real].cpu().numpy()]


def eager_trajectory(sim: "Simulation", n_steps: int, save_every: int = 1):
    """The eager loop of ``sim.trajectory(n_steps, save_every)``, the
    reference its replays are held to: ``(frames, state, sort_perm)`` of a
    copy of ``sim``'s state; ``sim`` is unchanged."""
    sim._guard_dense_tree_span(n_steps)
    return _eager_frames(sim, n_steps, save_every, "save_every", (sim.state.n, 3),
                         trajectory_frame, {})


def eager_movie(sim: "Simulation", n_steps: int, render_every: int, camera,
                scale_factors=(0.0, 0.0, 0.0), *, width: int = 1024, height: int = 768):
    """The eager loop of ``sim.movie(...)`` with the same arguments, the
    reference its replays are held to: ``(frames, state, sort_perm)`` of a
    copy of ``sim``'s state; ``sim`` is unchanged."""
    sim._guard_dense_tree_span(n_steps)
    return _eager_frames(sim, n_steps, render_every, "render_every", (height, width, 3),
                         functools.partial(movie_frame, width=width, height=height),
                         frame_inputs(sim.state, camera.view_projection(), scale_factors))


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device a ``Simulation`` runs on: ``"cuda"`` unless the caller
    asks for another; never a quiet fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: Simulation runs on the GPU by default; pass "
            'device="cpu" (--device cpu on the command line) to run on the CPU')
    return dev


# Solvers whose forces come from the hand-written kernels on the card.
KERNEL_SOLVERS = ("pallas", "pallas_symmetric", "treecode")


def require_card_softening(solver: str, eps2: float, device_type: str) -> None:
    """Raise, once and before anything runs, if ``solver`` on ``device_type``
    reaches a kernel and ``eps2`` is below the smallest normal float32: the
    pair kernels take the bare rsqrt instruction, which flushes a denormal
    argument (``cuda_build.MIN_EPS2``). The plain solvers and the CPU take
    any softening."""
    if device_type == "cuda" and solver in KERNEL_SOLVERS and not eps2 >= cuda_build.MIN_EPS2:
        raise ValueError(
            f"eps2={eps2} is below {cuda_build.MIN_EPS2}, the smallest softening the CUDA "
            f'kernels of solver "{solver}" take; raise it, or pass device="cpu" '
            "(--device cpu on the command line)")


class Simulation:
    """Stateful convenience wrapper.

    >>> sim = Simulation(SimConfig(), models.plummer(1024, seed=0), device="cuda")
    >>> sim.run(100)
    >>> sim.state.pos

    ``device`` defaults to ``"cuda"``; without a GPU the constructor raises
    unless ``device="cpu"`` is given. On ``"cuda"`` a solver that reaches a
    kernel needs a normal float32 ``eps2`` (:func:`require_card_softening`),
    and the first ``run``, ``movie`` or ``trajectory`` captures the CUDA
    graphs that every later step replays (``graphs``; ``capture_seconds``).
    The state is padded
    with zero-mass bodies to the solver's multiple, exactly as the JAX
    package pads it, and leapfrog runs are primed with one force
    evaluation. With ``solver="treecode"`` the bodies are Morton-sorted at
    init and re-sorted on the device as the run goes; ``sort_perm[i]`` is
    the input index of the body now at slot i, and ``tree_lists`` holds the
    acceptance lists the last steps were taken with (in ``state``'s slot
    order): those of ``ops.treecode.build_tree_hier_cols``,
    ``build_tree_flat`` or ``build_tree``, by the path
    (``ops.registry.tree_path(sim.cfg)``).
    """

    def __init__(self, cfg: SimConfig, state: SimState,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        dev_type = self.device.type
        state = state.to(self.device)
        solver = resolve_solver(cfg.solver, dev_type, state.n)
        require_card_softening(solver, cfg.eps2, dev_type)
        if solver == "treecode":
            cfg = self._treecode_config(cfg, state.n)
        elif cfg.tree_tile == 0:
            cfg = cfg.replace(tree_tile=32)
        self.cfg = cfg
        self.solver = solver
        self.sort_perm = None
        self.state = state
        if cfg.morton_sort or cfg.resort_every > 0:
            if state.n != state.n_real:
                self.state = unpad_state(state)
            self._resort()
        state = self.state
        need = required_padding(
            solver, state.n, cfg.block_size, cfg.pallas_tile_i,
            cfg.pallas_tile_j, cfg.pallas_sym_tile, cfg.tree_tile,
            cfg.tree_src_tile,
        )
        if state.n < need:
            state = pad_state_to(state, need)
        self._tree = self.tree_lists = self._static = None
        if solver == "treecode":
            cfg = self._plan_treecode(cfg, state)
            self._tree = tree_parts(cfg)
        self.cfg = cfg
        if cfg.integrator == "leapfrog":
            state = prime_leapfrog(state, make_force_fn(cfg, dev_type, state.n))
        self.state = state
        self._step_fn = make_step_fn(cfg, dev_type, state.n)
        self.wall_seconds = 0.0

    def _treecode_config(self, cfg: SimConfig, n: int) -> SimConfig:
        """The JAX package's treecode defaults: the auto target-row tile,
        resolved before padding (128 where the hierarchical path will run,
        32 otherwise), and the Morton sort the acceptance needs. The GPU
        plays the TPU's part in the rule."""
        if cfg.tree_tile == 0:
            hier = (cfg.tree_hier
                    and n >= max(treecode.CHUNK_LANES,
                                 treecode.FAR_ENTRIES * cfg.tree_src_tile)
                    and ((cfg.tree_flat_cap == 0 and self.device.type == "cuda")
                         or (cfg.tree_flat_cap > 0 and cfg.tree_far_cap > 0)))
            cfg = cfg.replace(tree_tile=treecode.DEFAULT_HIER_TILE if hier else 32)
        if not (cfg.morton_sort or cfg.resort_every):
            cfg = cfg.replace(morton_sort=True)
        return cfg

    @staticmethod
    def _plan_treecode(cfg: SimConfig, state: SimState) -> SimConfig:
        """Resolve the VIP count and plan the static capacities on the
        (sorted, padded) initial bodies, as the JAX package does: on the
        GPU with ``tree_flat_cap`` at 0, the flat lists from 2,048 bodies
        and the hierarchy from ``FAR_ENTRIES`` source tiles; otherwise the
        capacities given, or the dense path. Margins absorb drift between
        re-sorts."""
        n, src = state.n, cfg.tree_src_tile
        if cfg.tree_vip_tiles == -1:
            cfg = cfg.replace(tree_vip_tiles=resolve_vip_tiles(-1, n))
        use_flat = (cfg.tree_flat_cap == 0 and state.device.type == "cuda"
                    and n >= treecode.CHUNK_LANES and n % src == 0)
        use_hier = (cfg.tree_hier and n >= treecode.FAR_ENTRIES * src
                    and (use_flat or (cfg.tree_flat_cap > 0 and cfg.tree_far_cap > 0)))
        sel = dict(tile=cfg.tree_tile, theta=cfg.tree_theta,
                   vip_tiles=cfg.tree_vip_tiles, eps2=cfg.eps2,
                   compensate=cfg.compensate)
        if use_hier:
            caps = treecode.suggest_hier(
                state.pos, state.mass, src_tile=src, slack=cfg.tree_near_slack,
                mac_tau=cfg.tree_hier_tau, mac_tau0=cfg.tree_mac_tau,
                union_coarse=cfg.tree_hier_union, **sel)
            for field, key in (("tree_max_near", "max_near"),
                               ("tree_flat_cap", "flat_cap"),
                               ("tree_far_max", "far_max"),
                               ("tree_far_cap", "far_cap")):
                if getattr(cfg, field) == 0:
                    cfg = cfg.replace(**{field: caps[key]})
            return cfg
        # The flat path counts the near capacity in source tiles, the
        # dense path in target tiles.
        flat_src = src if use_flat or cfg.tree_flat_cap > 0 else None
        if cfg.tree_max_near == 0:
            cfg = cfg.replace(tree_max_near=treecode.suggest_max_near(
                state.pos, state.mass, src_tile=flat_src, mac_tau=cfg.tree_mac_tau,
                **sel))
        if use_flat:
            cfg = cfg.replace(tree_flat_cap=treecode.suggest_flat_cap(
                state.pos, state.mass, src_tile=src, slack=cfg.tree_near_slack,
                mac_tau=cfg.tree_mac_tau, **sel))
        return cfg

    @property
    def step_fn(self) -> StepFn:
        return self._step_fn

    @property
    def capture_seconds(self) -> float:
        """Seconds this simulation spent warming up and capturing its CUDA
        graphs (``graphs.StaticRun.capture``; 0 on the CPU). They fall in
        the first ``run``, ``movie`` or ``trajectory`` call that needs them."""
        return 0.0 if self._static is None else self._static.capture_seconds

    def run(self, n_steps: int) -> SimState:
        """Advance ``n_steps``; returns when the device has finished them.

        On ``cuda`` the steps are replays of CUDA graphs captured on the
        first call (``graphs``): a treecode chunk is one replay of the
        resort, one of the acceptance build and one a step; every other
        solver replays one step, and with ``cfg.resort_every = r`` runs in
        chunks of r steps with a host Morton sort between them. The returned
        state, ``tree_lists`` and ``sort_perm`` are copies that no later call
        rewrites. While a ``torch.profiler`` records, the call is the host
        span ``sim.run`` and the label of that name (``utils.profiling``)."""
        t0 = _time.perf_counter()
        with profiling.span("sim.run", label=True, steps=n_steps, solver=self.solver):
            if n_steps == 0:
                if self._tree is not None:
                    self.state = self._tree.finish(self.state, 0)
            elif self._tree is not None:
                g, programs = self._prepare(True, n_steps)
                self._chunks(programs, n_steps)
                self._unload_tree(n_steps)
            else:
                g, (step,) = self._prepare(False, n_steps)
                r = self.cfg.resort_every or n_steps
                done = 0
                while done < n_steps:
                    todo = min(r, n_steps - done)
                    g.repeat(step, todo)
                    done += todo
                    if done < n_steps:  # no sort after the last chunk
                        self.state = g.state
                        self._resort()
                        g.load(self.state)
                self.state = g.unload()
            self._finish(t0)
        return self.state

    def _static_run(self) -> StaticRun:
        if self._static is None:
            self._static = StaticRun(self.state)
        return self._static

    def _prepare(self, chunked: bool, n_steps: int, *extra):
        """``(static run, programs)`` with the state loaded: the treecode's
        ``(resort, build, step)`` when ``chunked``, else the one step of
        ``step_fn``; captured (on first use, before the load) with the
        ``extra`` programs (a frame) when the call has steps to take."""
        g = self._static_run()
        programs = (tree_programs(g, self._tree) if chunked
                    else (g.program("step", step_program(self._step_fn)),))
        if n_steps:
            g.capture(*programs, *extra)
        g.load(self.state)
        if chunked:
            g.ids.copy_(torch.arange(g.state.n, dtype=torch.int32, device=self.device))
        return g, programs

    def _chunks(self, programs, n_steps: int) -> None:
        """``n_steps`` treecode steps on the loaded buffers, in chunks of
        ``tree_rebuild_every``: replays only, no host sync."""
        replay_chunks(self._static, programs, n_steps, self._tree.rebuild_every)

    def _chunked(self) -> bool:
        """Whether a movie's or a trajectory's spans take the treecode's
        chunks (the hierarchical and flat paths), not ``step_fn``'s steps."""
        return self._tree is not None and tree_path(self.cfg) != "dense"

    def _unload_tree(self, n_steps: int) -> None:
        """After ``n_steps`` treecode steps: the state copied out and
        finished, the chunks' body permutation composed into ``sort_perm``,
        and a copy of the lists the last steps were taken with."""
        g = self._static
        self.state = self._tree.finish(g.unload(), n_steps)
        self._track_ids(g.ids)
        self.tree_lists = g.unload_aux()

    def _finish(self, t0: float) -> None:
        """Wait for the device; add the call's wall time."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall_seconds += _time.perf_counter() - t0

    def _track_ids(self, ids: torch.Tensor) -> None:
        """Compose a device run's body permutation into ``sort_perm``."""
        ids = ids[: self.state.n_real].cpu().numpy()
        self.sort_perm = ids if self.sort_perm is None else self.sort_perm[ids]

    def _resort(self) -> None:
        """Re-Morton-order the real bodies on the host (padding stays last);
        ``sort_perm`` follows, so callers can map back to the input order."""
        k = self.state.n_real
        perm_real = morton_argsort(self.state.pos[:k])
        perm = np.concatenate([perm_real, np.arange(k, self.state.n)])
        self.state = apply_permutation(self.state, perm)
        self.sort_perm = (perm_real if self.sort_perm is None
                          else self.sort_perm[perm_real])

    def _guard_dense_tree_span(self, n_steps: int) -> None:
        """Refuse long movies and trajectories on the dense treecode path.

        That path runs the generic per-step loop: no Morton re-sort fires
        inside it, tile locality decays, and once open counts outgrow the
        static near capacity the leaked multipole errors heat the core
        (the JAX package measured dE/E ~ 1e3 over a long un-resorted run).
        The hierarchical and flat paths re-sort in chunks and have no limit.
        """
        if self._tree is not None and tree_path(self.cfg) == "dense":
            limit = 4 * self.cfg.tree_rebuild_every
            if n_steps > limit:
                raise ValueError(
                    f"movie/trajectory of {n_steps} steps on the dense "
                    f"treecode path would run without mid-span Morton "
                    f"re-sorts (locality decay corrupts long runs; "
                    f"measured dE/E ~ 1e3). Use run(), split the span "
                    f"into chunks of <= {limit} steps, or use the flat or "
                    f"hierarchical treecode path (the GPU default).")

    def _frames(self, n_steps: int, every: int, name: str, key: str,
                frame_shape: tuple[int, ...], record: Callable, inputs: dict) -> torch.Tensor:
        """The movie's and the trajectory's loop (:func:`run_frames`) on
        the same replays as :meth:`run`, each frame the replay of the frame
        program ``key`` (``graphs.frame_program``: ``record(out, state, ids,
        **inputs)``) and one copy of its buffer. On the treecode's
        hierarchical and flat paths each span takes the run's chunks, and
        ``record`` gets the chunks' body permutation (``ids[i]``: the
        call-entry slot of the body at slot i); elsewhere each span is
        ``every`` steps of ``step_fn`` and ``ids`` is None. The ``inputs``
        are loaded into buffers of their names on every call: a new camera
        replays the same graph."""
        self._guard_dense_tree_span(n_steps)
        _spans(n_steps, every, name)
        t0 = _time.perf_counter()
        chunked = self._chunked()
        frame = frame_program(self._static_run(), key, frame_shape, record, inputs, chunked)
        g, programs = self._prepare(chunked, n_steps, frame)
        frames = self._replay_frames(programs, frame, key, n_steps, every, name)
        if chunked and n_steps:
            self._unload_tree(n_steps)
        else:
            self.state = g.unload()
        self._finish(t0)
        return frames

    def _replay_frames(self, programs, frame, key: str, n_steps: int, every: int,
                       name: str) -> torch.Tensor:
        """:func:`replay_frames` of ``n_steps`` on the loaded buffers, each
        span the treecode's chunks or ``every`` replays of the step. No
        host sync."""
        g = self._static
        if self._chunked():
            advance = lambda k: self._chunks(programs, k)  # noqa: E731
        else:
            advance = lambda k: g.repeat(programs[0], k)  # noqa: E731
        return replay_frames(g, advance, frame, key, n_steps, every, name)

    def trajectory(self, n_steps: int, save_every: int = 1) -> torch.Tensor:
        """Advance ``n_steps``; positions every ``save_every`` steps, (F, N,
        3) on the device. On the treecode's hierarchical and flat paths
        every frame is in the call-entry body order (scattered by the
        chunks' permutation): the chunks re-sort the bodies, so raw frames
        would each be in another Morton order."""
        return self._frames(n_steps, save_every, "save_every", "trajectory",
                            (self.state.n, 3), trajectory_frame, {})

    def movie(
        self,
        n_steps: int,
        render_every: int,
        camera,
        scale_factors=(0.0, 0.0, 0.0),
        *,
        width: int = 1024,
        height: int = 768,
    ) -> torch.Tensor:
        """Simulate and render on the device: (F, H, W, 3) float32 frames,
        one every ``render_every`` steps, the bodies drawn in their current
        slot order. On ``cuda`` a frame is the replay of the frame graph of
        this (width, height), captured on its first call; the camera and the
        scale factors are loaded into its buffers on every call (on the
        device once a call, not a host copy every frame)."""
        return self._frames(n_steps, render_every, "render_every", f"movie {width}x{height}",
                            (height, width, 3),
                            functools.partial(movie_frame, width=width, height=height),
                            frame_inputs(self.state, camera.view_projection(), scale_factors))

    # ------------------------------------------------------------ metrics
    def pairs_per_step(self) -> int:
        """Physical directed pair interactions per step: n_real*(n_real-1)."""
        k = self.state.n_real
        return k * (k - 1)

    def padded_pairs_per_step(self) -> int:
        """Directed pair evaluations of an all-pairs step (padded N^2)."""
        return self.state.n * self.state.n

    def diagnostics(self) -> dict:
        from n_body_problem_tpu_torch import diagnostics as diag

        return diag.summary(self.state, self.cfg)
