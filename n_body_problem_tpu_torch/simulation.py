"""Step loop: build a step function and run it on a device.

Counterpart of ``n_body_problem_tpu.simulation``. A Python loop takes the
place of ``lax.scan``: PyTorch runs eagerly, each step enqueues its kernels
on the device's stream, and only the end of :meth:`Simulation.run` waits
for the device.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from n_body_problem_tpu_torch.config import SimConfig, resolve_vip_tiles
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


def make_treecode_run(cfg: SimConfig):
    """The treecode run: every ``cfg.tree_rebuild_every`` steps, Z-order the
    bodies on the device and rebuild the acceptance lists of the config's
    path (``ops.registry.tree_path``), then run the steps with both kept.

    The resort is load-bearing: Morton tile locality decays as bodies move,
    and once open counts outgrow the static capacities the leaked tiles'
    multipole errors heat the core. Nothing in the loop waits for the host.
    The resort and the build are labelled for ``torch.profiler``
    (``treecode.resort``, ``treecode.build``). The hierarchical and flat
    paths update positions in the loop and the time once at the end, as
    the JAX package's columnar run does; the dense path steps through the
    generic integrator, as the JAX package's dense run does.

    Returns ``run(state, n_steps) -> (state, ids, aux)``, where ``ids[i]``
    is the input slot of the body now at slot i and ``aux`` the acceptance
    lists the last chunk stepped with (in the returned state's slot order;
    None when ``n_steps`` is 0). ``cfg`` must carry the resolved tile, VIP
    count and capacities (``Simulation`` resolves them). ``run`` is
    ``finish(advance(state, start(state), n_steps))``, and carries the
    three as ``run.start``, ``run.advance`` and ``run.finish``: the
    movie and the trajectory take the same chunks between their frames
    (the cadence restarts at every frame), so that long treecode movies
    are as safe as ``run`` on the hierarchical and flat paths.
    """
    r = cfg.tree_rebuild_every
    dt = cfg.dt
    dense = tree_path(cfg) == "dense"
    build, force = tree_fns(cfg)
    leapfrog = cfg.integrator == "leapfrog"

    def chunk(state: SimState, ids: torch.Tensor, length: int):
        with record_function("treecode.resort"):
            state, ids = device_resort(state, ids)
        with record_function("treecode.build"):
            aux = build(state.pos, state.mass)
        if dense:
            step = make_integrator(cfg.integrator,
                                   lambda pos, mass: force(pos, mass, aux), dt)
            return run_steps(state, step, length), ids, aux
        pos, vel, acc, mass = state.pos, state.vel, state.acc, state.mass
        for _ in range(length):
            if leapfrog:  # KDK, stored-acceleration form
                vel = vel + acc * (0.5 * dt)
                pos = pos + vel * dt
                acc = force(pos, mass, aux)
                vel = vel + acc * (0.5 * dt)
            else:
                acc = force(pos, mass, aux)
                vel = vel + acc * dt
                pos = pos + vel * dt
        return dataclasses.replace(state, pos=pos, vel=vel, acc=acc), ids, aux

    def advance(state: SimState, ids: torch.Tensor, n_steps: int):
        aux = None
        full, rem = divmod(n_steps, r)
        for length in [r] * full + ([rem] if rem else []):
            state, ids, aux = chunk(state, ids, length)
        return state, ids, aux

    def start(state: SimState):
        return torch.arange(state.n, dtype=torch.int32, device=state.device)

    def finish(state: SimState, n_steps: int) -> SimState:
        if dense:
            return state
        return dataclasses.replace(
            state, time=state.time + torch.full_like(state.time, dt) * n_steps,
            step=state.step + n_steps)

    def run(state: SimState, n_steps: int):
        state, ids, aux = advance(state, start(state), n_steps)
        return finish(state, n_steps), ids, aux

    run.start, run.advance, run.finish = start, advance, finish
    return run


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
    kernel needs a normal float32 ``eps2`` (:func:`require_card_softening`).
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
        self._tree_run = self.tree_lists = None
        if solver == "treecode":
            cfg = self._plan_treecode(cfg, state)
            self._tree_run = make_treecode_run(cfg)
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

    def run(self, n_steps: int) -> SimState:
        """Advance ``n_steps``; returns when the device has finished them.

        The treecode re-sorts on the device inside its run; every other
        solver with ``cfg.resort_every = r`` runs in chunks of r steps with
        a host Morton sort between them."""
        t0 = _time.perf_counter()
        if self._tree_run is not None:
            self.state, ids, aux = self._tree_run(self.state, n_steps)
            self._tree_moved(ids, aux)
        else:
            r = self.cfg.resort_every or n_steps
            done = 0
            while done < n_steps:
                todo = min(r, n_steps - done)
                self.state = run_steps(self.state, self._step_fn, todo)
                done += todo
                if done < n_steps:  # no sort after the last chunk
                    self._resort()
        self._finish(t0)
        return self.state

    def _finish(self, t0: float) -> None:
        """Wait for the device; add the call's wall time."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall_seconds += _time.perf_counter() - t0

    def _tree_moved(self, ids: torch.Tensor, aux) -> None:
        """After a treecode run: compose its body permutation into
        ``sort_perm`` and keep the lists it last stepped with."""
        self._track_ids(ids)
        if aux is not None:
            self.tree_lists = aux

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
        if self._tree_run is not None and tree_path(self.cfg) == "dense":
            limit = 4 * self.cfg.tree_rebuild_every
            if n_steps > limit:
                raise ValueError(
                    f"movie/trajectory of {n_steps} steps on the dense "
                    f"treecode path would run without mid-span Morton "
                    f"re-sorts (locality decay corrupts long runs; "
                    f"measured dE/E ~ 1e3). Use run(), split the span "
                    f"into chunks of <= {limit} steps, or use the flat or "
                    f"hierarchical treecode path (the GPU default).")

    def _frames(self, n_steps: int, every: int, name: str, frame_shape: tuple[int, ...],
                record: Callable[[torch.Tensor, SimState, torch.Tensor | None], object]
                ) -> torch.Tensor:
        """The movie's and the trajectory's loop (:func:`run_frames`): on the
        treecode's hierarchical and flat paths each span takes the run's
        chunks, and ``record(frame, state, ids)`` gets the chunks' body
        permutation (``ids[i]``: the call-entry slot of the body at slot
        i); elsewhere each span is ``every`` plain steps and ``ids`` is
        None."""
        self._guard_dense_tree_span(n_steps)
        t0 = _time.perf_counter()
        tree = self._tree_run
        if tree is not None and tree_path(self.cfg) != "dense":
            ids, aux = tree.start(self.state), None

            def advance(state: SimState, k: int) -> SimState:
                nonlocal ids, aux
                state, ids, aux = tree.advance(state, ids, k)
                return state

            state, frames = run_frames(self.state, advance, n_steps, every, name,
                                       frame_shape, lambda f, s: record(f, s, ids))
            self.state = tree.finish(state, n_steps)
            self._tree_moved(ids, aux)
        else:
            self.state, frames = run_frames(
                self.state, lambda s, k: run_steps(s, self._step_fn, k), n_steps, every,
                name, frame_shape, lambda f, s: record(f, s, None))
        self._finish(t0)
        return frames

    def trajectory(self, n_steps: int, save_every: int = 1) -> torch.Tensor:
        """Advance ``n_steps``; positions every ``save_every`` steps, (F, N,
        3) on the device. On the treecode's hierarchical and flat paths
        every frame is in the call-entry body order (scattered by the
        chunks' permutation): the chunks re-sort the bodies, so raw frames
        would each be in another Morton order."""
        def record(frame, state, ids):
            if ids is None:
                frame.copy_(state.pos)
            else:
                frame.index_copy_(0, ids.long(), state.pos)

        return self._frames(n_steps, save_every, "save_every", (self.state.n, 3), record)

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
        slot order."""
        from n_body_problem_tpu_torch.render.splat import splat_frame

        # on the device once, not a host copy every frame
        vp = torch.as_tensor(camera.view_projection(), device=self.device)
        scale_factors = torch.as_tensor(np.asarray(scale_factors, np.float32),
                                        device=self.device)
        mask = self.state.real_mask()

        def record(frame, state, ids):
            frame.copy_(splat_frame(state.pos, state.mass, mask, vp, scale_factors,
                                    width=width, height=height))

        return self._frames(n_steps, render_every, "render_every", (height, width, 3),
                            record)

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
