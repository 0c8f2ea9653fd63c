"""ShardedSimulation: the multi-GPU counterpart of ``Simulation``.

Counterpart of ``n_body_problem_tpu.parallel.sharded``. Bodies are sharded
over the ranks of a :class:`~n_body_problem_tpu_torch.parallel.mesh.RingMesh`
(BASELINE.json configs 4-5: 262,144 bodies over 4 devices, 1,048,576 and
up). Every rank builds the same ``ShardedSimulation`` from the same whole
state and keeps only its own shard; ``gather_state`` (a collective) gives
the whole state back on every rank.

- ``"ring"`` / ``"half_ring"``: the exact ring (``parallel/ring.py``), the
  tile rotation or the half ring's packets between ranks every force.
- ``"treecode"``: the sharded Barnes-Hut (``parallel/tree.py``), replicated
  sources and sharded target rows, on the path the JAX package takes for
  the same configuration (the card plays the TPU's part in the rule).
- ``"treecode_staged"``: the staged Barnes-Hut (``parallel/stream.py``),
  replicated source summaries and the near sources streamed round the ring,
  on the flat-list paths on any device.

As ``Simulation`` does, ``run`` steps the static buffers of a
``graphs.StaticRun``: on ``cuda`` every step (and every treecode resort
and build) is the replay of a CUDA graph captured on the first call,
collectives included; on the CPU (gloo) the same functions are called
directly. :func:`eager_run` is the eager loop of the same run, the
reference the replays are held to.

>>> sim = ShardedSimulation(cfg, state, mesh, strategy="half_ring")  # on each rank
>>> sim.run(1000)
>>> sim.diagnostics()["energy"]                                      # on each rank
"""

from __future__ import annotations

import dataclasses
import math
import time as _time

import numpy as np
import torch

from n_body_problem_tpu_torch.config import SimConfig
from n_body_problem_tpu_torch.graphs import (StaticRun, clone_state, replay_chunks,
                                             step_program, tree_programs)
from n_body_problem_tpu_torch.ops import registry, treecode
from n_body_problem_tpu_torch.parallel.mesh import RingMesh, make_ring_mesh
from n_body_problem_tpu_torch.parallel.ring import make_sharded_step, ring_force, shard_state
from n_body_problem_tpu_torch.parallel.stream import make_staged_force, staged_parts
from n_body_problem_tpu_torch.parallel.tree import (chunked_run, make_sharded_treecode_force,
                                                    rank_ids, replicated_parts)
from n_body_problem_tpu_torch.simulation import require_card_softening
from n_body_problem_tpu_torch.state import SimState, pad_state, unpad_state
from n_body_problem_tpu_torch.utils.morton import apply_permutation, morton_argsort

STRATEGIES = ("ring", "half_ring", "treecode", "treecode_staged")
TREE_STRATEGIES = ("treecode", "treecode_staged")


def _plans_lists(strategy: str, device_type: str) -> bool:
    """Whether the run plans its list capacities as on the card: on the
    card, and the staged strategy, built on the flat lists, on any device."""
    return device_type == "cuda" or strategy == "treecode_staged"


def auto_tile(cfg: SimConfig, strategy: str, n: int, device_type: str) -> SimConfig:
    """``cfg`` with the auto target row (``tree_tile`` 0) resolved: by
    ``Simulation``'s rule (``registry.tree_tile``) for the treecode
    strategies, 32 for the exact ring, which has no rows."""
    if strategy not in TREE_STRATEGIES:
        return cfg if cfg.tree_tile else cfg.replace(tree_tile=32)
    return registry.tree_tile(cfg, n, _plans_lists(strategy, device_type))


def plan_treecode(cfg: SimConfig, state: SimState, n_dev: int, device_type: str,
                  strategy: str = "treecode"):
    """The distributed Barnes-Hut's set-up on the whole state:
    ``(cfg, state, init_perm)``. Bodies Morton-sorted on the host (``init_perm``
    the input index of each sorted real body), padded to ``lcm(D tile,
    src_tile, 256)`` so that every rank holds whole target rows, then the
    VIP count and one rank's capacities planned as ``Simulation`` plans
    them (``registry.plan_tree``), with a rank's margins. The staged
    strategy is built on the flat lists, so it raises ``ValueError`` where
    it has none."""
    cfg = auto_tile(cfg, strategy, state.n, device_type)
    real = unpad_state(state) if state.n != state.n_real else state
    init_perm = morton_argsort(real.pos)
    state = apply_permutation(real, init_perm)
    state = pad_state(state, multiple=math.lcm(n_dev * cfg.tree_tile, cfg.tree_src_tile, 256))
    cfg = registry.plan_tree(cfg, state.pos, state.mass, _plans_lists(strategy, device_type),
                             n_dev, margin=treecode.SHARDED_MARGIN,
                             far_margin=treecode.SHARDED_FAR_MARGIN,
                             flat_margin=treecode.SHARDED_MARGIN)
    if strategy == "treecode_staged" and cfg.tree_flat_cap <= 0:
        raise ValueError(
            "treecode_staged needs the flat-list machinery: N must "
            f"be >= {treecode.CHUNK_LANES}, a multiple of src_tile="
            f"{cfg.tree_src_tile}, with K_t divisible by "
            f"n_dev={n_dev} (or pass an explicit tree_flat_cap)")
    return cfg, state, init_perm


class ShardedSimulation:
    """Stateful wrapper of one rank's shard; every rank of the mesh makes
    one, from the same config and whole state, and calls its methods in
    the same order (``run``, ``gather_state`` and ``diagnostics`` are
    collectives).

    ``local_solver`` picks the exact strategies' stage solver
    (``parallel.ring``: on the card always the all-pairs kernel). With
    ``strategy="treecode"`` or ``"treecode_staged"`` ``sort_perm[i]`` is the
    input index of the body now at global slot i, as in ``Simulation``.
    On ``cuda`` the first ``run`` captures the CUDA graphs every later step
    replays (``capture_seconds``); the leapfrog prime stays eager and runs
    once, at construction.
    """

    def __init__(self, cfg: SimConfig, state: SimState, mesh: RingMesh | None = None, *,
                 strategy: str = "ring", local_solver: str = "xla"):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; expected one of {STRATEGIES}")
        self.mesh = mesh if mesh is not None else make_ring_mesh()
        self.strategy = strategy
        dev_type = self.mesh.device.type
        require_card_softening("treecode" if strategy in TREE_STRATEGIES else "pallas",
                               cfg.eps2, dev_type)
        self.cfg = cfg = auto_tile(cfg, strategy, state.n, dev_type)
        self.sort_perm = None
        self.wall_seconds = 0.0
        self._step = self._tree = self._static = None
        state = state.to(self.mesh.device)
        if strategy in TREE_STRATEGIES:
            self._init_treecode(cfg, state)
            return
        if cfg.morton_sort:
            real = unpad_state(state) if state.n != state.n_real else state
            state = apply_permutation(real, morton_argsort(real.pos))
        if state.n % self.mesh.size:
            state = pad_state(state, multiple=self.mesh.size)
        self.n = state.n
        self.state = shard_state(state, self.mesh)
        if cfg.integrator == "leapfrog":
            # Leapfrog's first half-kick needs the force at the start.
            force = ring_force(strategy, self.mesh, cfg, local_solver)
            self.state = dataclasses.replace(
                self.state, acc=force(self.state.pos, self.state.mass))
        self._step = make_sharded_step(cfg, self.mesh, strategy, local_solver)

    def _init_treecode(self, cfg: SimConfig, state: SimState) -> None:
        """The distributed Barnes-Hut (:func:`plan_treecode`), primed for
        leapfrog with the sharded force: the dense one for ``"treecode"``,
        the staged one for ``"treecode_staged"``, each on lists built
        afresh, as in the JAX package."""
        cfg, state, self.sort_perm = plan_treecode(cfg, state, self.mesh.size,
                                                   self.mesh.device.type, self.strategy)
        self.cfg, self.n = cfg, state.n
        self.state = shard_state(state, self.mesh)
        staged = self.strategy == "treecode_staged"
        if cfg.integrator == "leapfrog":
            force = (make_staged_force if staged else make_sharded_treecode_force)(cfg,
                                                                                   self.mesh)
            self.state = dataclasses.replace(
                self.state, acc=force(self.state.pos, self.state.mass))
        self._tree = (staged_parts if staged else replicated_parts)(cfg, self.mesh)

    @property
    def capture_seconds(self) -> float:
        """Seconds this rank spent warming up and capturing its CUDA graphs
        (0 on the CPU), in the first ``run`` call."""
        return 0.0 if self._static is None else self._static.capture_seconds

    def run(self, n_steps: int) -> SimState:
        """Advance ``n_steps``; returns this rank's shard when its device has
        finished them. A collective: every rank calls it.

        On ``cuda`` the steps are replays of the CUDA graphs captured on the
        first call: a treecode chunk is one replay of the global resort, one
        of the build of the rank's lists and one a step; the exact ring one
        a step. A capture that fails raises. After a treecode run the
        ranks' body permutations are gathered (one ``all_gather``) into
        ``sort_perm`` on the host. The returned state is a copy that no
        later call rewrites."""
        t0 = _time.perf_counter()
        if n_steps:
            g, programs = self._prepare()
            if self._tree is not None:
                replay_chunks(g, programs, n_steps, self._tree.rebuild_every)
                self.state = self._tree.finish(g.unload(), n_steps)
                self.sort_perm = self._composed(g.ids)
            else:
                g.repeat(programs[0], n_steps)
                self.state = g.unload()
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        self.wall_seconds += _time.perf_counter() - t0
        return self.state

    def _prepare(self):
        """``(static run, programs)``, captured on first use (every rank in
        the same order) and loaded with the state: the treecode's ``(resort,
        build, step)``, or the exact ring's step."""
        if self._static is None:
            self._static = StaticRun(self.state)
        g = self._static
        programs = (tree_programs(g, self._tree) if self._tree is not None
                    else (g.program("step", step_program(self._step)),))
        g.capture(*programs)
        g.load(self.state)
        if self._tree is not None:
            g.ids.copy_(rank_ids(self.state, self.mesh))
        return g, programs

    def _composed(self, ids: torch.Tensor) -> np.ndarray:
        """``sort_perm`` after a treecode run whose rows' ids (global input
        slots) are ``ids``: the ranks' ids gathered (a collective) and
        composed with it on the host."""
        ids = self.mesh.all_gather(ids)[:self.state.n_real].cpu().numpy()
        return ids if self.sort_perm is None else self.sort_perm[ids]

    def step(self) -> SimState:
        """One step (``run(1)``)."""
        return self.run(1)

    def gather_state(self) -> SimState:
        """The whole state, every rank's rows in rank order, on every rank
        (one ``all_gather``; a collective)."""
        s = self.state
        cols = self.mesh.all_gather(torch.cat([s.pos, s.vel, s.acc, s.mass[:, None],
                                               s.eps[:, None]], 1))
        return dataclasses.replace(
            s, pos=cols[:, 0:3].contiguous(), vel=cols[:, 3:6].contiguous(),
            acc=cols[:, 6:9].contiguous(), mass=cols[:, 9].contiguous(),
            eps=cols[:, 10].contiguous())

    # ------------------------------------------------------------ metrics
    def pairs_per_step(self) -> int:
        """Physical directed pair interactions per step (real bodies only)."""
        k = self.state.n_real
        return k * (k - 1)

    def padded_pairs_per_step(self) -> int:
        return self.n * self.n

    def diagnostics(self) -> dict:
        """``diagnostics.summary`` of the gathered state (a collective)."""
        from n_body_problem_tpu_torch import diagnostics as diag

        return diag.summary(self.gather_state(), self.cfg)


def eager_run(sim: ShardedSimulation, n_steps: int) -> tuple[SimState, np.ndarray | None]:
    """The eager loop of ``sim.run(n_steps)`` on a copy of this rank's shard
    (``tree.chunked_run`` of the strategy's pieces, or the exact ring's
    ``make_sharded_step`` a step), the reference its replays are held to:
    ``(state, sort_perm)``; ``sim`` is unchanged. A collective: every rank
    calls it."""
    state = clone_state(sim.state)
    if sim._tree is None:
        for _ in range(n_steps):
            state = sim._step(state)
        return state, sim.sort_perm
    state, ids = chunked_run(sim._tree, sim.mesh)(state, n_steps)
    return state, sim._composed(ids)
