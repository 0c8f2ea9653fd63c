"""Where the time of a treecode step goes, on one GPU.

    python -m n_body_problem_tpu_torch.treecode_profile [--sizes 20480t,65536,524288]
        [--steps 16] [--staleness 20480t,65536 [--ages 0,8,16,24,31]]
        [--decompose 20480t,65536] [--json PATH]

For each size, a Plummer sphere (seed 0) goes through
``Simulation(SimConfig(solver="treecode"))`` on the path that N takes, or
with a suffix: ``t`` applies ``tuned_tree_overrides``, ``f`` the
single-level flat path (``tree_hier=False``), ``d`` the dense path
(``tree_flat_cap=-1``). Then 8 primed steps, and:

- ``build_ms``, ``resort_ms``, ``force_ms``: one acceptance build, one
  device resort and one force evaluation, by CUDA events (mean of 5/10/10);
- ``force_enqueue_ms``: the host's time to enqueue one force evaluation;
- ``launches_per_force``: host kernel launches (``cudaLaunchKernel`` in a
  ``torch.profiler`` trace) and device kernels of one force evaluation;
- ``step_ms``: ``Simulation.run`` over ``--steps`` steps, no profiler (the
  replays of its CUDA graphs; ``capture_s``: their warm-up and capture, in
  the primed steps); ``eager_step_ms``: the eager loop
  (``simulation.make_treecode_run``) over as many steps from a copy of the
  state;
- a ``torch.profiler`` trace of another ``--steps`` steps (``profile_ms``;
  ``eager_profile_ms`` the eager loop's): device ms of
  each treecode kernel (the VIP sweep's pair kernel as ``vip``, its summing
  kernel as ``vip_sum``), the ``treecode.build`` and
  ``treecode.resort`` spans and everything else, device busy time, the
  window's wall time and the device's idle share of it.

With ``--staleness``, first the force error against the all-pairs kernel
(p99 and median, all bodies up to 65,536, else 2,048 sampled) on lists
built once and then stepped with, at each age in ``--ages``.

With ``--decompose``, the JAX tool ``tools/decompose_step.py``'s legs on
the replays of the run's CUDA graphs (``graphs``), each the best of three
windows of 256 replays (the resort 64, the build 32, as the JAX tool
takes them), host clock to a synchronize, in ms a replay:

- ``floor``: a trivial program (one multiply of an (N, 3) buffer);
- ``force``: the force alone, on the lists of the loaded state;
- ``force_euler``: the run's step (force and update), no rebuild;
- ``resort``, ``build``: the run's resort and acceptance build;
- ``full_step``: the run's chunks (a resort, a build and
  ``tree_rebuild_every`` = r steps) divided by r;

and from them, by the tool's own arithmetic (:func:`decompose_split`),
``integrator_ms``, ``amortized_rebuild_ms`` and ``glue_ms``. ``busy_ms``
holds each leg's device busy ms a replay from a ``torch.profiler`` trace of
another window, ``busy_split`` the same arithmetic on them, and
``force_kernels_ms`` the treecode kernels' share of the force's.

One line a size (a JSON line a decomposed size), then one JSON object with
every number and the card's ``nvidia-smi`` name and power limit (also
written to ``--json``). To compare two trees, run this module from each
checkout in one call, alternating: host-paced steps vary between machines
and calls.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

PRIME = 8
DECOMPOSE_STEPS = 256   # the JAX tool's default window
_KERNELS = {"near_field_kernel": "near", "far_field_kernel": "far",
            "vip_both_kernel": "vip", "vip_sum_kernel": "vip_sum",
            "far_single_kernel": "far_single", "gather_panels_kernel": "gather",
            "near_panel_kernel": "near_panel"}


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def force_error(tree, pos, mass, n_real: int, cfg,
                sample: int | None = None) -> tuple[float, float]:
    """(p99, median) relative error of the force ``tree`` on the bodies
    ``pos``/``mass`` against the all-pairs kernel's exact force, on
    ``sample`` random real bodies (seed 0) or on all ``n_real``."""
    from n_body_problem_tpu_torch.ops import cuda_force

    if sample is None:
        idx = torch.arange(n_real, device=pos.device)
    else:
        gen = torch.Generator(device="cpu").manual_seed(0)
        idx = torch.randperm(n_real, generator=gen)[:sample].sort().values.to(pos.device)
    rows = pos[idx]
    rows = torch.cat([rows, rows.new_zeros((-rows.shape[0] % 256, 3))])
    exact = cuda_force.block_acc(rows, pos, mass, tile_i=256, tile_j=256,
                                 eps2=cfg.eps2, compensate=cfg.compensate,
                                 G=cfg.G)[:idx.shape[0]]
    err = (tree[idx] - exact).norm(dim=1) / torch.clamp(exact.norm(dim=1), min=1e-12)
    return float(torch.quantile(err, 0.99)), float(err.median())


def kernel_inputs(n: int, device, seed: int = 0, **overrides) -> dict:
    """The treecode kernels' arguments at the shapes the main path gives
    them: a Plummer sphere through ``Simulation``'s sort, padding and
    capacity planning, then the acceptance build of the path it takes.
    ``kernels`` maps each kernel the path launches to ``(args, kw)``; the
    near-panel kernel takes the plain gather's panels, so that its check
    does not rest on the gather kernel."""
    from n_body_problem_tpu_torch import SimConfig, Simulation, models
    from n_body_problem_tpu_torch.ops import cuda_treecode as ct
    from n_body_problem_tpu_torch.ops import treecode
    from n_body_problem_tpu_torch.ops.registry import tree_fns, tree_path

    sim = Simulation(SimConfig(solver="treecode", **overrides),
                     models.plummer(n, seed=seed), device=device)
    cfg, s = sim.cfg, sim.state
    path, tile, src = tree_path(cfg), cfg.tree_tile, cfg.tree_src_tile
    aux = tree_fns(cfg)[0](s.pos, s.mass)
    phys = dict(eps2=cfg.eps2, c2=cfg.compensate ** 2)
    far_kw = dict(n=s.n, tile=tile, G=cfg.G, **phys)
    if path == "dense":
        k, max_near, vip = treecode._static_args(s.n, tile, cfg.tree_theta,
                                                 cfg.tree_max_near, cfg.tree_vip_tiles)
        ops = treecode.kernel_operands(s.pos, s.mass, aux[2], compensate=cfg.compensate,
                                       G=cfg.G, src_tile=tile, vip_src=vip,
                                       plan=(k,) if max_near < k else None)
        b = ops["bodies"]
        kernels = {"gather": ((b, aux[0]), dict(tile=tile)),
                   "near_panel": ((b, ct.gather_panels_plain(b, aux[0], tile=tile)),
                                  dict(tile=tile, **phys))}
        if max_near < k:
            kernels["far_single"] = ((b, ops["summ"], aux[1]), far_kw)
    else:
        hier = path == "hier"
        st = (treecode._hier_static(s.n, tile, src, cfg.tree_theta, cfg.tree_max_near,
                                    cfg.tree_vip_tiles, cfg.tree_far_max, treecode.HIER_BRANCH)
              if hier else treecode._flat_static(s.n, tile, src, cfg.tree_theta,
                                                 cfg.tree_max_near, cfg.tree_vip_tiles))
        ops = treecode.kernel_operands(s.pos, s.mass, aux[-1], compensate=cfg.compensate,
                                       G=cfg.G, src_tile=src, vip_src=st[4],
                                       plan=st[5] if hier else (st[1],))
        b = ops["bodies"]
        kernels = {"near": ((b, b, aux[0], aux[1]),
                            dict(n=s.n, n_s=s.n, tile=tile, src_tile=src, entries=st[2],
                                 **phys))}
        if hier:
            kernels["far"] = ((b, ops["summ"], aux[2], aux[3]), far_kw)
        else:
            kernels["far_single"] = ((b, ops["summ"], aux[2]), far_kw)
    if ops["rows"] is not None:
        kernels["vip"] = ((ops["rows"], ops["panel"]), phys)
    return dict(n=s.n, cfg=cfg, path=path, ops=ops, aux=aux, kernels=kernels)


def _size(tok: str):
    """(N, overrides) of a ``--sizes`` token such as ``20480t``."""
    from n_body_problem_tpu_torch.config import tuned_tree_overrides

    n = int(tok.rstrip("tfd"))
    return n, {"t": tuned_tree_overrides(n), "f": dict(tree_hier=False),
               "d": dict(tree_flat_cap=-1)}.get(tok[-1], {})


def _sim(tok: str):
    from n_body_problem_tpu_torch import SimConfig, Simulation, models

    n, over = _size(tok)
    sim = Simulation(SimConfig(solver="treecode", **over), models.plummer(n, seed=0),
                     device="cuda")
    sim.run(PRIME)
    return sim


def staleness(tok: str, ages: tuple[int, ...], sample: int | None = None) -> dict:
    """Force error against the all-pairs kernel on acceptance lists
    ``age`` Euler steps old: after ``PRIME`` steps, resort and build once,
    then step with those lists (as a run's chunk does) and probe at each
    age. Returns ``{age: (p99, median)}``."""
    from n_body_problem_tpu_torch.ops.registry import tree_fns
    from n_body_problem_tpu_torch.utils.morton import device_resort

    sim = _sim(tok)
    cfg = sim.cfg
    s, _ = device_resort(sim.state, torch.arange(sim.state.n, device=sim.state.device))
    build, force = tree_fns(cfg)
    pos, vel, mass = s.pos, s.vel, s.mass
    aux = build(pos, mass)
    out = {}
    for age in range(max(ages) + 1):
        acc = force(pos, mass, aux)
        if age in ages:
            out[age] = force_error(acc, pos, mass, s.n_real, cfg, sample)
        vel = vel + acc * cfg.dt
        pos = pos + vel * cfg.dt
    return out


def _trace(fn) -> tuple[list, float]:
    """(chrome-trace events, wall µs) of ``fn()`` under ``torch.profiler``."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"], wall_us


def _device_events(events: list) -> list:
    return [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def _busy_us(gpu: list) -> float:
    """µs the device was busy: the union of the device events' intervals."""
    covered, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in gpu):
        if b > end:
            covered += b - max(a, end)
            end = b
    return covered


def profile_tree_step(sim, steps: int = 16, eager: bool = False) -> dict:
    """Device time by kernel over ``steps`` steps of a treecode run, from a
    ``torch.profiler`` trace: each treecode kernel, the resort and the build
    (their ``record_function`` labels, around the eager calls or the graph
    replays), everything else, and the device's idle share of the wall time
    of the window. ``sim.run`` (the graphs' replays), or with ``eager`` the
    eager loop (``make_treecode_run``) on a copy of ``sim``'s state."""
    if eager:
        from n_body_problem_tpu_torch.graphs import clone_state
        from n_body_problem_tpu_torch.simulation import make_treecode_run

        run, state = make_treecode_run(sim.cfg), clone_state(sim.state)
        events, wall_us = _trace(lambda: run(state, steps))
    else:
        events, wall_us = _trace(lambda: sim.run(steps))
    gpu = _device_events(events)
    if not gpu:
        raise RuntimeError("profiler: the trace holds no device activity")
    spans: dict[str, list] = {}
    for e in events:
        if e.get("cat") == "gpu_user_annotation":
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    out = {"wall_ms": wall_us / 1e3}
    for e in gpu:
        key = next((v for k, v in _KERNELS.items() if k in e["name"]), None)
        if key is None:
            key = next((label.split(".")[-1] for label, iv in spans.items()
                        if label.startswith("treecode.")
                        and any(a <= e["ts"] < b for a, b in iv)), "other")
        out[key] = out.get(key, 0.0) + e["dur"] / 1e3
    covered = _busy_us(gpu)
    out["busy_ms"] = covered / 1e3
    out["idle_share"] = 1.0 - covered / wall_us
    return out


def profile_size(tok: str, steps: int) -> dict:
    from n_body_problem_tpu_torch.ops.registry import tree_fns, tree_path
    from n_body_problem_tpu_torch.utils.morton import device_resort

    sim = _sim(tok)
    s = sim.state
    build_fn, force_fn = tree_fns(sim.cfg)
    ids = torch.arange(s.n, device=s.device)
    build = lambda: build_fn(s.pos, s.mass)  # noqa: E731
    aux = build()
    force = lambda: force_fn(s.pos, s.mass, aux)  # noqa: E731
    out = {"size": tok, "n": s.n_real, "path": tree_path(sim.cfg),
           "build_ms": time_ms(build, 5),
           "resort_ms": time_ms(lambda: device_resort(s, ids), 10),
           "force_ms": time_ms(force, 10)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        force()
    out["force_enqueue_ms"] = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    events, _ = _trace(force)
    out["launches_per_force"] = sum("LaunchKernel" in e.get("name", "") for e in events
                                    if e.get("cat") == "cuda_runtime")
    out["device_kernels_per_force"] = sum(e.get("cat") == "kernel" for e in events)
    wall0 = sim.wall_seconds
    sim.run(steps)
    out["step_ms"] = (sim.wall_seconds - wall0) / steps * 1e3
    out["eager_step_ms"] = eager_step_ms(sim, steps)
    out["capture_s"] = sim.capture_seconds
    out["rebuild_every"] = sim.cfg.tree_rebuild_every
    out["profile_steps"] = steps
    out["profile_ms"] = profile_tree_step(sim, steps)
    out["eager_profile_ms"] = profile_tree_step(sim, steps, eager=True)
    return out


def decompose_split(legs: dict, rebuild_every: int) -> dict:
    """``tools/decompose_step.py``'s arithmetic on its legs (ms a step):
    the integrator's share of a step, the resort and the build less a floor
    each amortized over the ``rebuild_every`` steps of a chunk, and the
    chunk's residual glue."""
    rebuild = (legs["resort"] + legs["build"] - 2 * legs["floor"]) / rebuild_every
    return {"integrator_ms": legs["force_euler"] - legs["force"],
            "amortized_rebuild_ms": rebuild,
            "glue_ms": legs["full_step"] - legs["force_euler"] - rebuild}


def best_window_ms(fn, count: int, reps: int = 3) -> float:
    """Best ms a call of ``fn()`` over ``reps`` windows of ``count`` calls,
    host clock to a synchronize, after one warm call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(count):
            fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best / count * 1e3


def decompose(tok: str) -> dict:
    """The legs of ``tools/decompose_step.py`` at the size ``tok``, on the
    replays of a primed ``Simulation``'s graphs (see the module's
    docstring). Every window starts from the same loaded state and the
    lists built on it."""
    from n_body_problem_tpu_torch.graphs import replay_chunks
    from n_body_problem_tpu_torch.ops.registry import tree_fns, tree_path

    sim = _sim(tok)
    cfg, r, steps = sim.cfg, sim.cfg.tree_rebuild_every, DECOMPOSE_STEPS
    g, programs = sim._prepare(True, r)
    resort, build, step = programs
    state0 = g.unload()
    force_fn = tree_fns(cfg)[1]
    acc = g.buffer("decompose.acc", tuple(state0.acc.shape), state0.acc.dtype)
    bump = g.buffer("decompose.floor", tuple(state0.pos.shape), state0.pos.dtype)
    force = g.program("decompose.force",
                      lambda run: acc.copy_(force_fn(run.state.pos, run.state.mass, run.aux)))
    floor = g.program("decompose.floor", lambda run: bump.mul_(1.0000001))
    g.capture(force, floor)
    bump.fill_(1.0)
    # leg: (program, calls a window, steps a call)
    legs = {"floor": (floor, steps, 1), "force": (force, steps, 1),
            "force_euler": (step, steps, 1), "resort": (resort, max(steps // 4, 16), 1),
            "build": (build, max(steps // 8, 8), 1),
            "full_step": (lambda run: replay_chunks(run, programs, r, r), steps // r, r)}
    out = {"size": tok, "n": state0.n, "path": tree_path(cfg), "steps": steps,
           "rebuild_every": r}
    busy, kernels = {}, 0.0
    for name, (prog, count, per) in legs.items():
        g.load(state0)
        build(g)
        out[name] = best_window_ms(lambda: prog(g), count) / per  # noqa: B023
        g.load(state0)
        build(g)
        torch.cuda.synchronize()
        events, _ = _trace(lambda: [prog(g) for _ in range(count)])  # noqa: B023
        gpu = _device_events(events)
        busy[name] = _busy_us(gpu) / 1e3 / (count * per)
        if name == "force":
            kernels = sum(e["dur"] for e in gpu
                          if any(k in e["name"] for k in _KERNELS)) / 1e3 / count
    out.update(decompose_split(out, r))
    out["busy_ms"] = busy
    out["busy_split"] = decompose_split(busy, r)
    out["force_kernels_ms"] = kernels
    return out


def eager_step_ms(sim, steps: int) -> float:
    """ms/step of the eager loop (``make_treecode_run``, the reference of the
    graphs) over ``steps`` steps from a copy of ``sim``'s state, after one
    warm call of the same length; host clock to a synchronize."""
    from n_body_problem_tpu_torch.graphs import clone_state
    from n_body_problem_tpu_torch.simulation import make_treecode_run

    run = make_treecode_run(sim.cfg)
    state = run(clone_state(sim.state), steps)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(state, steps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="20480t,65536,524288",
                    help="comma-separated N; suffix 't' for tuned_tree_overrides, "
                         "'f' for the flat path, 'd' for the dense path")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--staleness", default="",
                    help="sizes, as --sizes, whose force error to probe on lists "
                         "of each age in --ages")
    ap.add_argument("--ages", default="0,8,16,24,31")
    ap.add_argument("--decompose", default="",
                    help="sizes, as --sizes, whose step to split into the legs of "
                         "tools/decompose_step.py")
    ap.add_argument("--json", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("treecode_profile: needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    card = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    ages = tuple(int(a) for a in args.ages.split(","))
    stale = []
    for tok in filter(None, args.staleness.split(",")):
        errs = staleness(tok, ages, sample=2048 if _size(tok)[0] > 65536 else None)
        stale.append({"size": tok, "p99_median_by_age": {str(a): e for a, e in errs.items()}})
        print(f"staleness {tok}: " + "; ".join(
            f"age {a} p99 {p:.3e} median {m:.3e}" for a, (p, m) in errs.items()),
            flush=True)
        torch.cuda.empty_cache()
    rows = []
    for tok in filter(None, args.sizes.split(",")):
        row = profile_size(tok, args.steps)
        rows.append(row)
        prof, eager = row.pop("profile_ms"), row.pop("eager_profile_ms")
        print(" ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                       for k, v in row.items()) + " | profile ms: " + " ".join(
                  f"{k} {v:.4f}" for k, v in prof.items()) + " | eager: " + " ".join(
                  f"{k} {v:.4f}" for k, v in eager.items()), flush=True)
        row["profile_ms"], row["eager_profile_ms"] = prof, eager
        torch.cuda.empty_cache()
    split = []
    for tok in filter(None, args.decompose.split(",")):
        split.append({**decompose(tok), **card})
        print(json.dumps(split[-1]), flush=True)
        torch.cuda.empty_cache()
    record = {**card, "sizes": rows, "staleness": stale, "decompose": split}
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
