"""The run as one device program: CUDA graphs replayed over static buffers.

Counterpart of the JAX package's ``jax.jit`` + ``lax.scan``: there
``Simulation`` jits ``run``, the trajectory and the movie
(``n_body_problem_tpu/simulation.py:472-477``), the steps are a
``lax.scan`` (``run_steps``) and a treecode chunk (resort, acceptance
build, ``tree_rebuild_every`` steps) is one scanned body. Here each piece
of the run is a :class:`Program`, a function that reads and writes only
the buffers of one :class:`StaticRun`; on ``cuda`` it is captured once
into a CUDA graph and replayed, so that a step costs one graph launch on
the host instead of one launch a kernel. On the CPU the same function is
called directly, so that the CPU run is bitwise the eager loop's
(``simulation.run_steps``, ``simulation.make_treecode_run``), which stays
as the reference.

- **Static buffers.** ``StaticRun`` holds the columns the run carries (a
  :class:`~n_body_problem_tpu_torch.state.SimState`: pos, vel, mass, eps,
  acc, time, step), the body ids and the acceptance lists (``aux``),
  allocated outside any graph's memory pool. A program's temporaries come
  from the pool the run's graphs share (each program ends with every
  result copied into the buffers, so no temporary lives from one replay
  to the next and the graphs may replay in any order).
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
    """The static buffers of one ``Simulation`` and the programs that step
    them (see the module's docstring). ``state``, ``ids`` and ``aux`` are
    the buffers themselves: read them between replays, and copy them
    (:meth:`unload`) before handing them out."""

    def __init__(self, state: SimState):
        self.device = state.device
        self.state = clone_state(state)
        self.ids = torch.arange(state.n, dtype=torch.int32, device=self.device)
        self.aux: tuple | None = None     # allocated by the first build
        self.capture_seconds = 0.0
        self._programs: dict[str, Program] = {}
        self._pool = self._stream = None
        if self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

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
        return tuple(a.clone() for a in self.aux)

    def repeat(self, program: Program, count: int) -> None:
        for _ in range(count):
            program(self)


# ------------------------------------------------------------ the programs
def step_program(step_fn: Callable[[SimState], SimState]) -> Callable[[StaticRun], None]:
    """One step of ``step_fn`` (force and integration), written back."""
    def fn(run: StaticRun) -> None:
        store(run.state, step_fn(run.state))

    return fn


def tree_programs(run: StaticRun, parts) -> tuple[Program, Program, Program]:
    """``(resort, build, step)`` of a treecode run (``simulation.tree_parts``):
    the device resort permutes the columns and the ids through temporaries
    and copies them back; the build writes the acceptance lists; the step is
    the force and the update of one step on the lists in the buffers."""
    def resort(r: StaticRun) -> None:
        state, ids = parts.resort(r.state, r.ids)
        store(r.state, state)
        r.ids.copy_(ids)

    def build(r: StaticRun) -> None:
        aux = parts.build(r.state)
        if r.aux is None:   # the warm-up (or the CPU's first call): no graph pool
            r.aux = tuple(torch.empty(a.shape, dtype=a.dtype, device=a.device)
                          for a in aux)
        for dst, src in zip(r.aux, aux):
            dst.copy_(src)

    def step(r: StaticRun) -> None:
        store(r.state, parts.step(r.state, r.aux))

    return (run.program("treecode.resort", resort), run.program("treecode.build", build),
            run.program("treecode.step", step))
