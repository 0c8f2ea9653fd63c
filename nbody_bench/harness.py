"""One run of one cell: inputs, set-up, the measured window, the per-layer
readings, the comparison with the plain reference, and the result line.

The steps, in order:

1. **Inputs** from ``--seed`` by the configuration's generator
   (``nbody_bench/inputs/``), the same arrays for the program and the
   reference.
2. **Set-up**: the system under test (``port.Port``) and one warm call of
   the cell's loop, in which the program builds or loads its kernels'
   library (``n_body_problem_tpu_torch/_build/<hash>/``, inside the checkout)
   and captures its CUDA graphs. ``setup_s`` runs from the process's start to
   the end of the warm call. The warm call is judged with the window's.
3. **Window**: the loop's calls back to back until ``--seconds`` have passed
   (no call starts after that), closed by a synchronize; with ``--trace 1``
   its first ``traced_calls`` (the traffic file's) under ``torch.profiler``,
   so that a trace of hundreds of kernels a step stays readable in time. A sample of the calls, drawn from
   the seed, and the last call keep their states for the comparison; where
   the traffic file names ``judged_within_steps``, the sample and the last
   call are of the window's first that many steps, so that the states judged
   are as old in a fast run as in a slow one.
4. **Per-layer readings** (``--trace 1``), with the program still alive. A
   reader whose work needs the card's memory returns a function of no
   arguments instead, with what it took from the program: the harness
   calls it once the program, its CUDA graphs and their memory pools are
   freed.
5. **Comparison** (``judge``), after the program is freed.
6. **Result**: one JSON line on standard output, the numbers compared and
   their limits last on standard error.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import pathlib
import sys
import time

import numpy as np
import torch

from nbody_bench import judge, spec
from nbody_bench.reference.gravity import Physics
from nbody_bench.snapshot import Call, Snapshot
from nbody_bench.trace import Recorder

FOREIGN = ("jax", "jaxlib", "flax", "n_body_problem_tpu")


def log(*a) -> None:
    print("nbody_bench:", *a, file=sys.stderr, flush=True)


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, the names compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FOREIGN)


class Run:
    """What the readers of a run see: the cell, the window's calls and
    timings, the final state, the numbers of the final call, and (for the
    per-layer readers) the trace and the system under test."""

    def __init__(self, cell: spec.Cell, seed: int):
        self.cell, self.seed = cell, seed
        self.n = cell.config["n"]
        self.durations: list[float] = []
        self.steps = self.calls = self.frames = 0
        self.window_s = self.setup_s = float("nan")
        self.final = None          # the last judged call's Call
        self.window_gap = 0.0          # the window's steps counted, less those asked
        self.final_numbers: dict = {}
        self.warm_numbers: dict = {}   # the warm call's, a fixed 50 steps from the seed
        self.trace = None
        self.system = None
        self.mass = None
        self.phys = Physics.of(cell.config)


def _keep(prev: Snapshot, c: Call) -> tuple[Snapshot, Call]:
    """A kept call and the state before it; the frame is copied, since a
    loop may reuse its buffer."""
    return prev, (c if c.frame is None else dataclasses.replace(c, frame=c.frame.clone()))


def drive(loop, seconds: float, prev: Snapshot, rng: np.random.Generator, run: Run,
          judged_calls: int, traced_calls: int = 0, horizon: int | None = None) -> list:
    """The window: the loop's calls until ``seconds`` have passed. Returns
    ``[(prev, call), ...]`` of the sampled calls and the last one. With
    ``horizon``, only the calls that end within the window's first
    ``horizon`` steps are judged, so that the states judged are of the same
    age whatever the program's speed; the last one is then the last call
    within the horizon. Each call is kept with the chance ``judged_calls``
    over the calls that the first call's length says the window holds (or
    the horizon, if it holds fewer), at most four times ``judged_calls`` of
    them. With ``traced_calls``, the first that many calls run under
    ``torch.profiler`` (``run.trace``). ``run.steps`` is the system's own
    count of the window's steps, read once the window has closed."""
    kept = []
    rec = Recorder().__enter__() if traced_calls else None
    start, last = prev, None
    t0 = time.perf_counter()
    deadline = t0 + seconds
    p_judge = None
    try:
        while True:
            c = loop.call()
            run.durations.append(c.end - c.start)
            run.calls += 1
            run.steps += c.steps
            run.frames += c.frame is not None
            if p_judge is None:
                calls = seconds / max(c.end - c.start, 1e-9)
                if horizon is not None:
                    calls = min(calls, horizon / c.steps)
                p_judge = min(1.0, judged_calls / max(calls, 1.0))
            if horizon is None or run.steps <= horizon:
                last = (prev, c)
                if rng.random() < p_judge and len(kept) < 4 * judged_calls:
                    kept.append(_keep(prev, c))
                    last = None
            prev = c.snap
            if rec is not None and run.calls == traced_calls:
                rec.__exit__(None, None, None)
                run.trace, rec = _traced(rec, run, loop), None
            if time.perf_counter() >= deadline:
                break
    finally:
        if rec is not None:
            rec.__exit__(None, None, None)
    if rec is not None:
        run.trace = _traced(rec, run, loop)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    run.window_s = time.perf_counter() - t0
    if last is not None:
        kept.append(_keep(*last))
    run.final = kept[-1][1]
    asked, run.steps = run.steps, int(prev.step) - int(start.step)
    run.window_gap = float(abs(run.steps - asked))
    return kept


def _traced(rec: Recorder, run: Run, loop):
    """The recorder's trace with the counts of the calls it holds."""
    tr = rec.trace()
    tr.calls, tr.steps, tr.frames = run.calls, run.steps, run.frames
    tr.tree_lists = getattr(getattr(loop.system, "sim", None), "tree_lists", None)
    return tr


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: pathlib.Path = spec.ROOT, device: str = "cuda", system_cls=None,
             warm: bool = True, t_start: float | None = None) -> dict:
    """One run; returns the result object. ``system_cls`` stands in for the
    program (the control, or a planted fault); ``warm=False`` skips the warm
    call."""
    t_begin = time.perf_counter()
    t_start = t_begin if t_start is None else t_start
    cell = spec.load(workload, root)
    run = Run(cell, seed)
    # The process's start up to here: the interpreter, torch and CUDA's
    # first use, the program's import.
    parts = {"start_s": t_begin - t_start}
    t = time.perf_counter()
    if system_cls is None:
        from nbody_bench.port import Port as system_cls
    parts["import_s"] = time.perf_counter() - t

    t = time.perf_counter()
    gen = spec._module(root / spec.PACKAGE / "inputs" / f"{cell.config['generator']}.py")
    pos, vel, mass = gen.generate(run.n, seed % 2**64, **cell.config.get("generator_params", {}))
    run.mass = mass
    parts["inputs_s"] = time.perf_counter() - t

    t = time.perf_counter()
    system = system_cls(cell.config, cell.traffic, pos, vel, mass, device)
    parts["system_s"] = time.perf_counter() - t
    t = time.perf_counter()
    loop = cell.loop.Loop(system, cell.traffic)
    prev = Snapshot(*(torch.as_tensor(a, device=device) for a in (pos, vel, np.zeros_like(pos))),
                    step=0)
    warmed = []
    if warm:
        c = loop.warm()
        warmed, prev = [_keep(prev, c)], c.snap
    if device != "cpu":
        torch.cuda.synchronize()
    parts["warm_s"] = time.perf_counter() - t
    sim = getattr(system, "sim", None)
    if sim is not None:
        parts["capture_s"] = sim.capture_seconds
    run.setup_s = time.perf_counter() - t_start
    log(f"{workload} seed {seed}: set-up {run.setup_s:.3f} s",
        " ".join(f"{k}={v:.3f}" for k, v in parts.items()))

    rng = np.random.default_rng([seed % 2**64, 1])
    kept = warmed + drive(loop, seconds, prev, rng, run, cell.traffic["judged_calls"],
                          cell.traffic["traced_calls"] if trace else 0,
                          cell.traffic.get("judged_within_steps"))
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    d = np.asarray(run.durations) * 1e3
    quarters = [float(q.mean()) for q in np.array_split(d, 4) if len(q)]
    log(f"window {run.window_s:.3f} s, {run.calls} calls, {run.steps} steps, "
        f"{len(kept)} judged; peak device memory {peak} B; call ms p5/p50/p95/max "
        f"{np.percentile(d, 5):.3f}/{np.median(d):.3f}/{np.percentile(d, 95):.3f}/{d.max():.3f}"
        f", by quarter {' '.join(f'{q:.3f}' for q in quarters)}")

    metrics = {}
    if trace:
        run.system = system
        for m in cell.per_layer:
            v = m["reader"].read(run.trace, run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        run.system = None
    del system, sim, loop, prev
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    for name, m in list(metrics.items()):
        if callable(m["value"]):            # a reader's work once the program is freed
            v = m["value"]()
            if v is None:
                del metrics[name]
            else:
                m["value"] = v

    t = time.perf_counter()
    numbers = []
    rng = np.random.default_rng([seed % 2**64, 2])
    for prev_snap, c in kept:
        slots = judge.sample_slots(run.n, cell.config["probe_bodies"], rng)
        nums = judge.judge_call(prev_snap, c.snap, c.steps, mass, run.phys, slots, c.frame,
                                cell.traffic.get("frame"))
        numbers.append(nums)
        log("judged call:", " ".join(f"{k}={v:.4g}" for k, v in nums.items()))
        if c is run.final:
            run.final_numbers = nums
        if warmed and c is warmed[0][1]:
            run.warm_numbers = nums
    # The window's step count is held with the last judged call's.
    numbers[-1]["steps_gap"] = max(numbers[-1]["steps_gap"], run.window_gap)
    log(f"the window's steps: steps_gap={run.window_gap:.4g}")
    checks, failed = judge.verdict(numbers, cell.limits)
    log(f"comparison {time.perf_counter() - t:.3f} s over {len(numbers)} calls")

    if not trace:
        for m in cell.end_to_end:
            v = m["reader"].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name() if device != "cpu" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": failed == 0, "attempted": len(numbers), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_us() / 1e6
        dev["window_s"] = run.trace.wall_us / 1e6
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": _num(v["value"]), "limit": v["limit"]}
                     for k, v in checks.items()}
    return out


def _num(v: float):
    return float(v) if np.isfinite(v) else None


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python3 -m nbody_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    import n_body_problem_tpu_torch as port

    here = pathlib.Path(os.getcwd()).resolve()
    if here not in pathlib.Path(port.__file__).resolve().parents:
        log(f"the program imported from {port.__file__}, not from {here}: no result")
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    foreign = foreign_modules()
    if foreign:
        log("modules of JAX or the JAX package were loaded:", ", ".join(foreign),
            ": no result")
        return 3
    checks = out.pop("checks")
    out["card"] = power_limit()
    out["checks"] = checks          # the numbers compared come last
    for k, v in checks.items():
        log(f"check {k} = {v['value']} (limit {v['limit']})")
    print(json.dumps(out), flush=True)
    return 0
