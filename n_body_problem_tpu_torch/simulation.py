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
from n_body_problem_tpu_torch.ops import treecode
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
    count and capacities (``Simulation`` resolves them).
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

    def run(state: SimState, n_steps: int):
        ids = torch.arange(state.n, dtype=torch.int32, device=state.device)
        aux = None
        full, rem = divmod(n_steps, r)
        for length in [r] * full + ([rem] if rem else []):
            state, ids, aux = chunk(state, ids, length)
        if not dense:
            state = dataclasses.replace(
                state, time=state.time + torch.full_like(state.time, dt) * n_steps,
                step=state.step + n_steps)
        return state, ids, aux

    return run


def _resolve_device(device: str | torch.device | None) -> torch.device:
    """The device a ``Simulation`` runs on: ``"cuda"`` unless the caller
    asks for another; never a quiet fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: Simulation runs on the GPU by default; pass "
            'device="cpu" (--device cpu on the command line) to run on the CPU')
    return dev


class Simulation:
    """Stateful convenience wrapper.

    >>> sim = Simulation(SimConfig(), models.plummer(1024, seed=0), device="cuda")
    >>> sim.run(100)
    >>> sim.state.pos

    ``device`` defaults to ``"cuda"``; without a GPU the constructor raises
    unless ``device="cpu"`` is given. The state is padded
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
        self.device = _resolve_device(device)
        dev_type = self.device.type
        state = state.to(self.device)
        solver = resolve_solver(cfg.solver, dev_type, state.n)
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
            self._track_ids(ids)
            if aux is not None:
                self.tree_lists = aux
        else:
            r = self.cfg.resort_every or n_steps
            done = 0
            while done < n_steps:
                todo = min(r, n_steps - done)
                self.state = run_steps(self.state, self._step_fn, todo)
                done += todo
                if done < n_steps:  # no sort after the last chunk
                    self._resort()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall_seconds += _time.perf_counter() - t0
        return self.state

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

    def trajectory(self, n_steps: int, save_every: int = 1):
        raise NotImplementedError(
            "Simulation.trajectory is not ported yet (ROADMAP §1 item 6)")

    def movie(self, *args, **kwargs):
        raise NotImplementedError(
            "Simulation.movie is not ported yet (ROADMAP §1 item 6: rendering)")

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
