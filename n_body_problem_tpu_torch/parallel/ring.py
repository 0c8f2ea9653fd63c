"""Ring-decomposed all-pairs force over the ranks of a :class:`RingMesh`.

Counterpart of ``n_body_problem_tpu.parallel.ring``. Bodies are sharded
over the ring. Each force evaluation runs ``D`` stages: every rank computes
the pull of a *visiting* (pos, mass) tile on its own bodies, then passes
the tile on to the next rank (:meth:`RingMesh.shift`). After ``D`` stages
every body has felt every shard. The half ring takes each unordered pair of
shards on one rank only and carries the reaction home with the tile.

The stage's pair work is the all-pairs kernel's block form on the card
(``cuda_force.block_acc``, kernel 1), whatever ``local_solver`` says; on
the CPU ``"xla"`` and ``"auto"`` take the plain ``pair_accel_tile`` (one
evaluation for both halves of a half-ring stage) and ``"pallas"`` the
kernel's plain twin, twice a half-ring stage, as the JAX package's
interpret mode computes. The card's wrappers refuse a denormal ``eps2``.

:func:`ring_acc_ranks` computes the same forces for every rank in one
process, the visiting tiles sliced from the whole arrays as the ring would
deliver them, in the same order of sums.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from n_body_problem_tpu_torch.config import SimConfig
from n_body_problem_tpu_torch.ops import cuda_force
from n_body_problem_tpu_torch.ops.forces import pair_accel_tile, pair_accel_tile_symmetric
from n_body_problem_tpu_torch.parallel.mesh import RingMesh
from n_body_problem_tpu_torch.state import SimState

RING_PALLAS_TILE = 256
STRATEGIES = ("ring", "half_ring")


def _resolve_local_solver(local_solver: str, device_type: str = "cpu") -> str:
    """``"auto"`` is ``"pallas"`` on the card and ``"xla"`` elsewhere."""
    if local_solver == "auto":
        return "pallas" if device_type == "cuda" else "xla"
    if local_solver not in ("xla", "pallas"):
        raise ValueError(f"unknown local_solver {local_solver!r}")
    return local_solver


def _block_force(local_solver: str, device_type: str = "cpu") -> Callable:
    """``(pos_i, pos_j, mass_j, **fkw) -> acc_i`` of one ring stage.

    On the card every solver is the all-pairs kernel's block form; with
    ``"pallas"`` (and off the card too) the shard size must be a multiple
    of :data:`RING_PALLAS_TILE`, the JAX kernel's tiling; otherwise the
    kernel takes any shard. ``"xla"`` on the CPU is the plain broadcast."""
    solver = _resolve_local_solver(local_solver, device_type)
    if solver == "pallas" or device_type == "cuda":
        tile = RING_PALLAS_TILE if solver == "pallas" else 1
        return lambda pos_i, pos_j, mass_j, **fkw: cuda_force.block_acc(
            pos_i, pos_j, mass_j, tile_i=tile, tile_j=tile, **fkw)
    return lambda pos_i, pos_j, mass_j, **fkw: pair_accel_tile(pos_i, pos_j, mass_j, **fkw)


def _half_stage(local_solver: str, device_type: str = "cpu") -> Callable:
    """``(pos_l, mass_l, pos_v, mass_v, **fkw) -> (a_local, a_visit)``: both
    halves of a local x visiting block pair. With the kernel, two block calls
    (action and reaction), as the JAX package's Pallas branch makes; the
    plain broadcast shares one pair evaluation between the halves."""
    solver = _resolve_local_solver(local_solver, device_type)
    if solver == "pallas" or device_type == "cuda":
        block = _block_force(solver, device_type)
        return lambda pos_l, mass_l, pos_v, mass_v, **fkw: (
            block(pos_l, pos_v, mass_v, **fkw), block(pos_v, pos_l, mass_l, **fkw))
    return pair_accel_tile_symmetric


def _half_active(s: int, rank: int, size: int) -> bool:
    """Whether a rank computes stage ``s`` of the half ring: for an even
    ring the last diagonal pairs every block twice, so only the lower half
    of the ranks takes it."""
    return size % 2 == 1 or s < size // 2 or rank < size // 2


def _split(packet: torch.Tensor, *widths: int) -> list[torch.Tensor]:
    """The columns of a packed packet, each contiguous (what the kernels take)."""
    out, c = [], 0
    for w in widths:
        part = packet[:, c:c + w]
        out.append((part[:, 0] if w == 1 else part).contiguous())
        c += w
    return out


def ring_acc(pos_local: torch.Tensor, mass_local: torch.Tensor, *, mesh: RingMesh,
             eps2: float, compensate: float = 0.1, G: float = 1.0,
             local_solver: str = "xla") -> torch.Tensor:
    """Acceleration (B, 3) of this rank's bodies from every shard: stage 0
    on the local tile, then ``D - 1`` rotate-then-compute stages (no
    rotation wasted after the last), the stages' results added in order."""
    force = _block_force(local_solver, mesh.device.type)
    fkw = dict(eps2=eps2, compensate=compensate, G=G)
    acc = force(pos_local, pos_local, mass_local, **fkw)
    visit = torch.cat([pos_local, mass_local[:, None]], 1)
    for _ in range(1, mesh.size):
        visit = mesh.shift(visit, 1)
        pos_v, mass_v = _split(visit, 3, 1)
        acc = acc + force(pos_local, pos_v, mass_v, **fkw)
    return acc


def half_ring_acc(pos_local: torch.Tensor, mass_local: torch.Tensor, *, mesh: RingMesh,
                  eps2: float, compensate: float = 0.1, G: float = 1.0,
                  local_solver: str = "xla") -> torch.Tensor:
    """The symmetric ring (Newton's third law): each unordered pair of
    shards is evaluated on one rank only.

    The visiting packet carries ``(pos, mass, reaction)``; at each of
    ``floor(D/2)`` stages the rank adds the action to its own bodies and the
    reaction to the packet. For even D only ranks ``< D/2`` compute the last
    stage, but every rank takes part in its exchange. After the sweep one
    hop of ``floor(D/2)`` ranks back sends each packet's reaction home.
    """
    dev_type = mesh.device.type
    block = _block_force(local_solver, dev_type)
    both = _half_stage(local_solver, dev_type)
    fkw = dict(eps2=eps2, compensate=compensate, G=G)
    acc = block(pos_local, pos_local, mass_local, **fkw)   # self-pairs add zero
    if mesh.size == 1:
        return acc
    s_last = mesh.size // 2
    packet = torch.cat([pos_local, mass_local[:, None], torch.zeros_like(pos_local)], 1)
    for s in range(1, s_last + 1):
        packet = mesh.shift(packet, 1)   # now shard (rank - s)'s
        if _half_active(s, mesh.rank, mesh.size):
            pos_v, mass_v, react_v = _split(packet, 3, 1, 3)
            a_local, a_visit = both(pos_local, mass_local, pos_v, mass_v, **fkw)
            acc = acc + a_local
            packet = torch.cat([packet[:, :4], (react_v + a_visit)], 1)
    react = _split(packet, 4, 3)[1]
    return acc + mesh.shift(react, -s_last)


def ring_acc_ranks(pos: torch.Tensor, mass: torch.Tensor, size: int, *,
                   strategy: str = "ring", eps2: float, compensate: float = 0.1,
                   G: float = 1.0, local_solver: str = "xla") -> torch.Tensor:
    """:func:`ring_acc` or :func:`half_ring_acc` of every rank of a ring of
    ``size``, in this process, one rank after another: each stage's
    visiting tile is the shard the ring would deliver, sliced from ``pos``
    and ``mass``, and every sum is taken in the ring's order (a packet's
    reaction in stage order). Returns the ranks' accelerations in rank
    order, (N, 3)."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown ring strategy {strategy!r}")
    if pos.shape[0] % size:
        raise ValueError(f"N={pos.shape[0]} not divisible by {size} ranks; pad first")
    dev_type = pos.device.type
    block = _block_force(local_solver, dev_type)
    fkw = dict(eps2=eps2, compensate=compensate, G=G)
    shards = [(p.contiguous(), m.contiguous())
              for p, m in zip(pos.chunk(size), mass.chunk(size))]
    acc = [block(p, p, m, **fkw) for p, m in shards]
    if strategy == "ring":
        for r, (p, _) in enumerate(shards):
            for s in range(1, size):
                pos_v, mass_v = shards[(r - s) % size]
                acc[r] = acc[r] + block(p, pos_v, mass_v, **fkw)
        return torch.cat(acc)
    if size == 1:
        return acc[0]
    both = _half_stage(local_solver, dev_type)
    react = [torch.zeros_like(p) for p, _ in shards]
    for s in range(1, size // 2 + 1):
        for r, (p, m) in enumerate(shards):
            if _half_active(s, r, size):
                q = (r - s) % size
                a_local, a_visit = both(p, m, *shards[q], **fkw)
                acc[r] = acc[r] + a_local
                react[q] = react[q] + a_visit
    return torch.cat([a + rv for a, rv in zip(acc, react)])


def shard_state(state: SimState, mesh: RingMesh) -> SimState:
    """This rank's rows of a whole state (the scalars and ``n_real`` as they
    are), on the rank's device. N must be divisible by the ring's size; pad
    first (``state.pad_state``)."""
    if state.n % mesh.size:
        raise ValueError(f"N={state.n} not divisible by mesh size {mesh.size}; pad first")
    b = state.n // mesh.size
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    return dataclasses.replace(
        state.to(mesh.device),
        **{k: getattr(state, k)[rows].to(mesh.device) for k in ("pos", "vel", "mass", "eps", "acc")})


def ring_force(strategy: str, mesh: RingMesh, cfg: SimConfig,
               local_solver: str = "xla") -> Callable:
    """``(pos_local, mass_local) -> acc_local`` of the strategy."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown ring strategy {strategy!r}")
    force = ring_acc if strategy == "ring" else half_ring_acc
    fkw = dict(mesh=mesh, eps2=cfg.eps2, compensate=cfg.compensate, G=cfg.G,
               local_solver=local_solver)
    return lambda pos, mass: force(pos, mass, **fkw)


def make_sharded_step(cfg: SimConfig, mesh: RingMesh, strategy: str = "ring",
                      local_solver: str = "xla") -> Callable[[SimState], SimState]:
    """One integration step of this rank's shard: ``state -> state``, the
    force by the ring (``"ring"``: every rank sweeps every tile;
    ``"half_ring"``: each pair of shards once). Both integrators; leapfrog
    uses the carried ``state.acc``."""
    force = ring_force(strategy, mesh, cfg, local_solver)
    dt = cfg.dt
    leapfrog = cfg.integrator == "leapfrog"

    def step(state: SimState) -> SimState:
        if leapfrog:
            v_half = state.vel + state.acc * (0.5 * dt)
            pos = state.pos + v_half * dt
            acc = force(pos, state.mass)
            vel = v_half + acc * (0.5 * dt)
        else:
            acc = force(state.pos, state.mass)
            vel = state.vel + acc * dt
            pos = state.pos + vel * dt
        return dataclasses.replace(state, pos=pos, vel=vel, acc=acc,
                                   time=state.time + dt, step=state.step + 1)

    return step


def sharded_kinetic_energy(state: SimState, mesh: RingMesh) -> torch.Tensor:
    """Kinetic energy of the real bodies of every shard (one all-reduce)."""
    b = state.n
    rows = torch.arange(mesh.rank * b, (mesh.rank + 1) * b, device=state.device)
    mask = (rows < state.n_real).to(state.pos.dtype)
    local = 0.5 * torch.sum(mask * state.mass * torch.sum(state.vel * state.vel, dim=-1))
    return mesh.all_reduce(local)
