"""Drive the sharded entry points in a ring and bring numpy results home.

:func:`run_cases` is a :func:`~n_body_problem_tpu_torch.parallel.mesh.spawn_ring`
target: every rank runs the same list of cases, each through the public
entry points (``shard_state`` with ``make_sharded_step``,
``sharded_kinetic_energy``, ``make_staged_force``, ``ShardedSimulation``
and its eager reference ``sharded.eager_run``), and rank 0 returns
their results as numpy arrays, gathered from every rank. It lives in the
package so that a spawned rank imports nothing but the port.

A case is ``{"kind": ..., **keywords}``; states travel as the dicts of
``state.to_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch

from n_body_problem_tpu_torch.config import SimConfig
from n_body_problem_tpu_torch.parallel.mesh import RingMesh
from n_body_problem_tpu_torch.parallel.ring import (make_sharded_step, ring_acc_ranks,
                                                    ring_force, shard_state,
                                                    sharded_kinetic_energy)
from n_body_problem_tpu_torch.parallel.sharded import ShardedSimulation, eager_run
from n_body_problem_tpu_torch.parallel.stream import make_staged_force
from n_body_problem_tpu_torch.state import from_numpy


def _gathered(mesh: RingMesh, *tensors: torch.Tensor) -> list[np.ndarray]:
    return [mesh.all_gather(t).cpu().numpy() for t in tensors]


def _step(mesh: RingMesh, *, cfg: SimConfig, state: dict, steps: int,
          strategy: str = "ring", local_solver: str = "xla") -> dict:
    """``steps`` sharded steps of a (padded) state: positions, velocities,
    accelerations and the step count."""
    s = shard_state(from_numpy(state), mesh)
    step = make_sharded_step(cfg, mesh, strategy, local_solver)
    for _ in range(steps):
        s = step(s)
    pos, vel, acc = _gathered(mesh, s.pos, s.vel, s.acc)
    return dict(pos=pos, vel=vel, acc=acc, step=int(s.step))


def _kinetic(mesh: RingMesh, *, state: dict) -> float:
    return float(sharded_kinetic_energy(shard_state(from_numpy(state), mesh), mesh))


def _shard_error(mesh: RingMesh, *, state: dict) -> str | None:
    """``shard_state``'s ``ValueError`` message, None if it shards."""
    try:
        shard_state(from_numpy(state), mesh)
    except ValueError as e:
        return str(e)
    return None


def _ranks(mesh: RingMesh, *, cfg: SimConfig, state: dict, strategy: str,
           local_solver: str = "xla") -> dict:
    """One force through the ring's collectives and the same force of every
    rank computed in one process (``ring_acc_ranks``)."""
    whole = from_numpy(state)
    s = shard_state(whole, mesh)
    world = mesh.all_gather(ring_force(strategy, mesh, cfg, local_solver)(s.pos, s.mass))
    alone = ring_acc_ranks(whole.pos, whole.mass, mesh.size, strategy=strategy,
                           eps2=cfg.eps2, compensate=cfg.compensate, G=cfg.G,
                           local_solver=local_solver)
    return dict(world=world.cpu().numpy(), ranks=alone.cpu().numpy())


def _staged(mesh: RingMesh, *, cfg: SimConfig, pos: np.ndarray, mass: np.ndarray):
    """One staged force of the rows ``pos`` (N, 3) sharded over the ring,
    gathered; or the message of the ``ValueError`` it raises."""
    b = pos.shape[0] // mesh.size
    mine = slice(mesh.rank * b, (mesh.rank + 1) * b)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a[mine])).to(mesh.device)  # noqa: E731
    try:
        acc = make_staged_force(cfg, mesh)(to(pos), to(mass))
    except ValueError as e:
        return str(e)
    return _gathered(mesh, acc)[0]


def _sim(mesh: RingMesh, *, cfg: SimConfig, state: dict, steps: int, strategy: str,
         local_solver: str = "xla") -> dict:
    """``ShardedSimulation``: the gathered state after construction (the
    leapfrog prime) and after ``steps``, the resolved config, ``sort_perm``
    and the diagnostics."""
    sim = ShardedSimulation(cfg, from_numpy(state), mesh, strategy=strategy,
                            local_solver=local_solver)
    acc0 = sim.gather_state().acc.cpu().numpy()
    sim.run(steps)
    whole = sim.gather_state()
    return dict(acc0=acc0, pos=whole.pos.cpu().numpy(), vel=whole.vel.cpu().numpy(),
                cfg=sim.cfg, sort_perm=sim.sort_perm, diag=sim.diagnostics(),
                n=sim.n)


def _replay(mesh: RingMesh, *, cfg: SimConfig, state: dict, steps: int, strategy: str,
            calls: int = 2) -> list[dict]:
    """``ShardedSimulation.run(steps)`` and its eager loop (``eager_run``)
    from the same state, ``calls`` times in a row: each call's gathered
    positions, velocities, accelerations, time, step and ``sort_perm`` of
    both, as ``{"eager": ..., "run": ...}``."""
    sim = ShardedSimulation(cfg, from_numpy(state), mesh, strategy=strategy)
    out = []
    for _ in range(calls):
        ref, perm = eager_run(sim, steps)
        sim.run(steps)
        out.append({name: dict(zip(("pos", "vel", "acc"), _gathered(mesh, s.pos, s.vel, s.acc)),
                               time=s.time.cpu().numpy(), step=s.step.cpu().numpy(),
                               sort_perm=p)
                    for name, s, p in (("eager", ref, perm), ("run", sim.state, sim.sort_perm))})
    return out


CASES = {"step": _step, "kinetic": _kinetic, "shard_error": _shard_error,
         "ranks": _ranks, "staged": _staged, "sim": _sim, "replay": _replay}


def run_cases(mesh: RingMesh, cases: list[dict]) -> list:
    """Each case's result, in order (every rank runs every case)."""
    return [CASES[c["kind"]](mesh, **{k: v for k, v in c.items() if k != "kind"})
            for c in cases]
