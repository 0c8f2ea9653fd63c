"""The ring of ranks the bodies are sharded over, on ``torch.distributed``.

Counterpart of ``n_body_problem_tpu.parallel.mesh``. The JAX package lays a
1-D mesh over the TPU's chips and runs one program on all of them; here
every rank is a process of its own, which holds its shard of the bodies on
its device (``cuda:<rank>`` on the card, the CPU otherwise), and the JAX
collectives become ``torch.distributed`` calls:

- ``lax.ppermute``: :meth:`RingMesh.shift`, paired ``isend``/``irecv``
  through ``batch_isend_irecv`` (send to rank ``(r + k) % D``, receive from
  ``(r - k) % D``);
- ``lax.all_gather(tiled=True)``: :meth:`RingMesh.all_gather`
  (``all_gather_into_tensor``);
- ``lax.psum``: :meth:`RingMesh.all_reduce`.

Each collective takes one contiguous tensor of one dtype (gloo reduces no
``bool``). The backend follows the device: NCCL on ``cuda``, gloo on the
CPU, and nothing switches from one to the other. NCCL runs one rank a GPU,
so a ring on the card has at most ``torch.cuda.device_count()`` ranks.

:func:`spawn_ring` starts a ring of processes on one host and returns rank
0's result; the CLI and the tests start their rings with it.
"""

from __future__ import annotations

import dataclasses
import datetime
import pathlib
import pickle
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# How long a rank waits in a collective for the others before it fails
# (rather than the backend's 30 minutes): far above any step or set-up.
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class RingMesh:
    """This process's place in the ring: the process group, its ``rank``,
    the ring's ``size`` and the ``device`` its shard lives on."""

    group: Any
    rank: int
    size: int
    device: torch.device

    def shift(self, t: torch.Tensor, k: int = 1) -> torch.Tensor:
        """``t`` sent ``k`` ranks on around the ring: returns what rank
        ``(rank - k) % size`` sent (``lax.ppermute`` by ``k``)."""
        if k % self.size == 0:
            return t
        t = t.contiguous()
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, (self.rank + k) % self.size, self.group),
               dist.P2POp(dist.irecv, out, (self.rank - k) % self.size, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked along the first axis in rank order."""
        if self.size == 1:
            return t
        t = t.contiguous()
        out = t.new_empty((self.size * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=self.group)
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` (a new tensor)."""
        if self.size == 1:
            return t
        out = t.contiguous().clone()
        dist.all_reduce(out, group=self.group)
        return out


def ring_devices(n_devices: int, device_type: str) -> None:
    """Raise ``ValueError`` unless a ring of ``n_devices`` ranks can run on
    ``device_type``: on ``cuda`` one GPU a rank, as NCCL requires."""
    if device_type not in BACKENDS:
        raise ValueError(f"no ring backend for device {device_type!r}; "
                         f"expected one of {sorted(BACKENDS)}")
    if n_devices < 1:
        raise ValueError(f"requested {n_devices} devices")
    if device_type == "cuda":
        have = torch.cuda.device_count()
        if n_devices > have:
            raise ValueError(f"requested {n_devices} devices, have {have}")


def make_ring_mesh(n_devices: int | None = None, *, device: str | None = None) -> RingMesh:
    """The ring over the world this process already belongs to
    (``torch.distributed`` initialised, :func:`spawn_ring` does it).

    ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"``; the
    world's backend must be the device's (NCCL for ``cuda``, gloo for the
    CPU). ``n_devices`` defaults to the world's size and must equal it.
    """
    device_type = device or "cuda"
    size = dist.get_world_size() if dist.is_initialized() else 1
    n_devices = size if n_devices is None else n_devices
    ring_devices(n_devices, device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_ring_mesh: torch.distributed is not initialised; "
                           "start the ranks with spawn_ring")
    if n_devices != size:
        raise ValueError(f"requested {n_devices} devices, the world has {size} ranks")
    backend = dist.get_backend()
    if backend != BACKENDS[device_type]:
        raise ValueError(f"a ring on {device_type} needs the {BACKENDS[device_type]} "
                         f"backend, the world runs {backend}")
    rank = dist.get_rank()
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    return RingMesh(dist.group.WORLD, rank, size, dev)


def _rank_main(rank: int, job: str, size: int, device_type: str, init: str,
               result: str, threads: int) -> None:
    """One rank of :func:`spawn_ring`: take its share of the ``threads`` of
    the process that spawned the ring, join the world, run the job's
    ``fn(mesh, *args)``, and on rank 0 write its result."""
    torch.set_num_threads(max(1, threads // size))
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    fn, args = pickle.loads(pathlib.Path(job).read_bytes())
    dist.init_process_group(BACKENDS[device_type], init_method=init, world_size=size,
                            rank=rank, timeout=COLLECTIVE_TIMEOUT)
    try:
        out = fn(make_ring_mesh(size, device=device_type), *args)
        if rank == 0:
            pathlib.Path(result).write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


def spawn_ring(fn: Callable, n_devices: int, *, device_type: str = "cuda",
               args: tuple = ()) -> Any:
    """Run ``fn(mesh, *args)`` on each of ``n_devices`` new processes (the
    ``spawn`` start method), joined into one world over a ``file://``
    rendezvous in a temporary directory; return rank 0's result, which
    must pickle (host data, not device tensors).

    ``fn`` must be importable by name in a fresh interpreter (a module
    function). ``fn`` and ``args`` reach the ranks through a file in the
    same directory: through the start method's pipe, whose buffer a large
    argument overflows, the processes would start one after another. The
    rendezvous takes no TCP port, so rings may run side by side. The ranks
    share this process's CPU threads (``torch.get_num_threads()``), each
    taking ``threads // n_devices`` and at least one, so that a ring
    started from a process pinned to its share of the CPU stays inside it.
    A rank that raises stops the others; the error is raised here as a
    ``RuntimeError`` carrying the rank's traceback."""
    ring_devices(n_devices, device_type)
    with tempfile.TemporaryDirectory(prefix="nbody_ring_") as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "job.pkl").write_bytes(pickle.dumps((fn, args)))
        try:
            torch.multiprocessing.spawn(
                _rank_main, args=(str(tmp / "job.pkl"), n_devices, device_type,
                                  (tmp / "rendezvous").as_uri(), str(tmp / "result.pkl"),
                                  torch.get_num_threads()),
                nprocs=n_devices, join=True, start_method="spawn")
        except torch.multiprocessing.ProcessRaisedException as e:
            raise RuntimeError(f"a rank of the ring failed:\n{e}") from None
        except torch.multiprocessing.ProcessExitedException as e:
            raise RuntimeError(f"a rank of the ring exited: {e}") from None
        return pickle.loads((tmp / "result.pkl").read_bytes())
