"""The run as one device program: CUDA graphs replayed over static buffers.

Counterpart of the JAX package's ``jax.jit`` + ``lax.scan``: there
``Simulation`` jits ``run``, the trajectory and the movie
(``n_body_problem_tpu/simulation.py:472-477``), the steps are a
``lax.scan`` (``run_steps``), a treecode chunk (resort, acceptance
build, ``tree_rebuild_every`` steps) is one scanned body, a frame is
drawn inside the scan (``run_with_frames``, ``run_trajectory``), and
``ShardedSimulation`` jits its sharded runs the same way
(``n_body_problem_tpu/parallel/sharded.py:107-118, 252-255``). Here each
piece of the run is a :class:`Program`, a function that reads and writes
only the buffers of one :class:`StaticRun`; on ``cuda`` it is captured
once into a CUDA graph and replayed, so that a step costs one graph
launch on the host instead of one launch a kernel, and a frame one
replay and one copy. On the CPU the same function is called directly, so
that the CPU run is bitwise the eager loop's (``simulation.run_steps``,
``simulation.make_treecode_run``, ``simulation.eager_movie`` and
``eager_trajectory``, ``parallel.sharded.eager_run``), which stays as
the reference.

- **Static buffers.** ``StaticRun`` holds the columns the run carries (a
  :class:`~n_body_problem_tpu_torch.state.SimState`: pos, vel, mass, eps,
  acc, time, step), the body ids and the acceptance lists (``aux``),
  allocated outside any graph's memory pool. A program's temporaries come
  from the pool the run's graphs share (each program ends with every
  result copied into the buffers, so no temporary lives from one replay
  to the next and the graphs may replay in any order). A frame's inputs
  (the camera's matrix, the scale factors, the real mask) and its output
  are named buffers (:meth:`StaticRun.buffer`), loaded on every call, so
  that a new camera replays the graph a first one captured.
- **Collectives.** A sharded run's programs hold its collectives
  (``parallel.mesh.RingMesh``): the warm-up makes each rank's first call
  of each (NCCL builds its communicators lazily), every rank captures the
  same collectives in the same order on its run's stream, and their
  outputs come from the pool. A world of one rank issues none (its
  ``shift``, ``all_gather`` and ``all_reduce`` return their input); gloo,
  on the CPU, is never captured.
- **Capture** (:meth:`StaticRun.capture`): a warm-up call on the buffers,
  which then hold a copy of the state (the kernel library's build and
  load, cub's workspace and every lazy initialisation happen there), then
  the capture, on a stream of the run's own. A capture that fails raises;
  nothing falls back to the eager loop. Every run loads its state into the
  buffers after the capture, so the warm-up does not change its result.
- **Launch counters.** The wrappers count their kernels' launches in
  Python (``COUNTED`` of ``ops.cuda_force``, ``ops.cuda_symmetric`` and
  ``ops.cuda_treecode``), which a replay does not run. A capture records
  what each counter gained while it was captured and puts back what the
  warm-up and the capture added; every replay then adds the recorded gain.
  The counts are those of the run's steps, as they were in the eager loop.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable

import torch
from torch.profiler import record_function

from n_body_problem_tpu_torch.state import _ARRAYS, SimState


def counted() -> tuple:
    """Every kernel wrapper with a ``.launches`` counter."""
    from n_body_problem_tpu_torch.ops import cuda_force, cuda_symmetric, cuda_treecode

    return cuda_force.COUNTED + cuda_symmetric.COUNTED + cuda_treecode.COUNTED


def store(dst: SimState, src: SimState) -> None:
    """Copy every array of ``src`` that is not already ``dst``'s own into
    ``dst``'s buffers."""
    for k in _ARRAYS:
        s, d = getattr(src, k), getattr(dst, k)
        if s is not d:
            d.copy_(s)


def clone_state(state: SimState) -> SimState:
    """A state whose arrays are fresh copies of ``state``'s."""
    return dataclasses.replace(state, **{k: getattr(state, k).clone() for k in _ARRAYS})


class Program:
    """``fn(run)``, a region of the run that reads and writes only the
    buffers of the :class:`StaticRun` it is called with: called directly on
    the CPU, replayed from its CUDA graph on ``cuda``."""

    def __init__(self, fn: Callable[["StaticRun"], None]):
        self.fn = fn
        self.graph = None
        self.added: tuple = ()   # (wrapper, launches a replay)

    def __call__(self, run: "StaticRun") -> None:
        if run.device.type != "cuda":
            self.fn(run)
            return
        if self.graph is None:
            raise RuntimeError("Program replayed before StaticRun.capture")
        self.graph.replay()
        for wrapper, count in self.added:
            wrapper.launches += count


class StaticRun:
    """The static buffers of one ``Simulation`` (or one rank of a
    ``ShardedSimulation``) and the programs that step them (see the
    module's docstring). ``state``, ``ids``, ``aux`` and ``buffers`` are
    the buffers themselves: read them between replays, and copy them
    (:meth:`unload`) before handing them out."""

    def __init__(self, state: SimState):
        self.device = state.device
        self.state = clone_state(state)
        self.ids = torch.arange(state.n, dtype=torch.int32, device=self.device)
        self.aux: tuple | None = None     # allocated by the first build
        self.buffers: dict[str, torch.Tensor] = {}
        self.capture_seconds = 0.0
        self._programs: dict[str, Program] = {}
        self._pool = self._stream = None
        if self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

    def buffer(self, name: str, shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        """The run's buffer ``name``, allocated (zeroed, outside any graph's
        pool) on first request: request it before the capture of a program
        that reads or writes it."""
        if name not in self.buffers:
            self.buffers[name] = torch.zeros(shape, dtype=dtype, device=self.device)
        return self.buffers[name]

    def program(self, name: str, fn: Callable[["StaticRun"], None]) -> Program:
        """The run's program ``name``, made from ``fn`` on first request."""
        if name not in self._programs:
            self._programs[name] = Program(fn)
        return self._programs[name]

    def capture(self, *programs: Program) -> None:
        """Warm up and capture, in order, each of ``programs`` not yet
        captured (on ``cuda``; nothing to do on the CPU). Call before
        :meth:`load`: the warm-up steps the buffers."""
        todo = [p for p in programs if p.graph is None]
        if self.device.type != "cuda" or not todo:
            return
        t0 = _time.perf_counter()
        wrappers = counted()
        start = [w.launches for w in wrappers]
        main = torch.cuda.current_stream(self.device)
        try:
            for p in todo:
                self._stream.wait_stream(main)
                with torch.cuda.stream(self._stream):
                    p.fn(self)
                main.wait_stream(self._stream)
                before = [w.launches for w in wrappers]
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                      capture_error_mode="thread_local"):
                    p.fn(self)
                p.added = tuple((w, w.launches - b) for w, b in zip(wrappers, before)
                                if w.launches != b)
                p.graph = graph
        finally:
            for w, s in zip(wrappers, start):
                w.launches = s
        torch.cuda.synchronize(self.device)
        self.capture_seconds += _time.perf_counter() - t0

    def load(self, state: SimState) -> None:
        """Copy ``state`` into the buffers."""
        store(self.state, state)

    def unload(self) -> SimState:
        """A copy of the buffers' state that no later replay rewrites."""
        return clone_state(self.state)

    def unload_aux(self) -> tuple:
        """A copy of the acceptance lists in the buffers."""
        return tuple(None if a is None else a.clone() for a in self.aux)

    def repeat(self, program: Program, count: int) -> None:
        for _ in range(count):
            program(self)


def chunk_lengths(n_steps: int, every: int) -> list[int]:
    """The chunks of a treecode run of ``n_steps``: whole chunks of
    ``every`` steps, then the remainder."""
    full, rem = divmod(n_steps, every)
    return [every] * full + ([rem] if rem else [])


def replay_chunks(run: StaticRun, programs, n_steps: int, every: int) -> None:
    """``n_steps`` treecode steps on the loaded buffers, in chunks of
    ``every``: replays only, no host sync. The resort and the build are
    labelled for ``torch.profiler`` (``treecode.resort``,
    ``treecode.build``)."""
    resort, build, step = programs
    for length in chunk_lengths(n_steps, every):
        with record_function("treecode.resort"):
            resort(run)
        with record_function("treecode.build"):
            build(run)
        run.repeat(step, length)


# ------------------------------------------------------------ the programs
def step_program(step_fn: Callable[[SimState], SimState]) -> Callable[[StaticRun], None]:
    """One step of ``step_fn`` (force and integration), written back."""
    def fn(run: StaticRun) -> None:
        store(run.state, step_fn(run.state))

    return fn


def tree_programs(run: StaticRun, parts) -> tuple[Program, Program, Program]:
    """``(resort, build, step)`` of a treecode run (``simulation.tree_parts``,
    or a sharded strategy's, ``parallel.tree.sharded_tree_parts``): the
    resort permutes the columns and the ids through temporaries and copies
    them back; the build writes the acceptance lists (an entry a path does
    not have stays None); the step is the force and the update of one step
    on the lists in the buffers."""
    def resort(r: StaticRun) -> None:
        state, ids = parts.resort(r.state, r.ids)
        store(r.state, state)
        r.ids.copy_(ids)

    def build(r: StaticRun) -> None:
        aux = parts.build(r.state)
        if r.aux is None:   # the warm-up (or the CPU's first call): no graph pool
            r.aux = tuple(None if a is None else
                          torch.empty(a.shape, dtype=a.dtype, device=a.device) for a in aux)
        for dst, src in zip(r.aux, aux):
            if dst is not None:
                dst.copy_(src)

    def step(r: StaticRun) -> None:
        store(r.state, parts.step(r.state, r.aux))

    return (run.program("treecode.resort", resort), run.program("treecode.build", build),
            run.program("treecode.step", step))


def frame_program(run: StaticRun, name: str, shape: tuple[int, ...], record: Callable,
                  inputs: dict, chunked: bool) -> Program:
    """The frame of a movie or a trajectory, ``record(out, state, ids,
    **inputs)``: from the state buffers (and the ids, on the chunked
    treecode paths) and the input buffers named as the keys of ``inputs``
    into the buffer ``name`` of ``shape``. Call it before the capture, on
    every call of the run: it allocates the buffers on first use and loads
    the values of ``inputs`` into theirs, so that a new camera replays the
    graph an earlier one captured."""
    run.buffer(name, shape, run.state.pos.dtype)
    for k, v in inputs.items():
        run.buffer(k, tuple(v.shape), v.dtype).copy_(v)
    names = tuple(inputs)

    def frame(r: StaticRun) -> None:
        record(r.buffers[name], r.state, r.ids if chunked else None,
               **{k: r.buffers[k] for k in names})

    return run.program(name, frame)
