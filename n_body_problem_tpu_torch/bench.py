"""Flagship benchmark: effective pairwise interactions/sec on one card.

Counterpart of the root ``bench.py`` (the JAX package's harness), with the
same legs, step counts, chunks, windows, record keys and ``BASELINE``:

    python -m n_body_problem_tpu_torch.bench                # headline suite
    python -m n_body_problem_tpu_torch.bench --full         # + secondary legs
    python -m n_body_problem_tpu_torch.bench --n 65536 --solver treecode
    python -m n_body_problem_tpu_torch.bench --device cpu --n 4096

Default (no args) runs the HEADLINE suite, four sustained treecode legs:
N=524,288 and N=1,048,576 first, then N=20,480 with
``tuned_tree_overrides(20480)`` (the reference's own workload: 1.6 ms/step
on an RTX 4090 at N=20,225, ``kernel.cu:73``) and N=65,536. Each leg runs
hundreds of steps through ``Simulation.run`` (every rebuild, resort and
capacity effect inside the timed window, the first calls' costs excluded
by a same-length warmup) and measures its force-error envelope against an
exact oracle on 2,048 stride-sampled bodies of the post-warmup state
(fixed probe depth), so every effective-throughput claim carries its
accuracy alongside.

Output protocol: two phases. Phase 1 runs only the timings, printing the
full cumulative report as one JSON line (``flush=True``) after every leg.
Phase 2 runs the deferred error probes, cheapest first, and prints the
report again after each. The last JSON line on stdout is therefore always
the most complete record. ``legs_done``/``legs_total`` mark partial
snapshots.

``--full`` appends the secondary legs (N=262,144 sustained, the windowed
variants, the 24k/32k crossover-bracket legs, the exact
``pallas_symmetric`` legs at 20,480 and 65,536, and the step-plus-render
leg, ``ms_per_step_with_render_65k``: ``pallas_symmetric`` at 65,536 with a
1024x1024 frame rendered after every step). ``vs_baseline`` compares the headline
(the sustained rate of the largest completed treecode leg) to the
reference's derived RTX 4090 throughput of 2.6e11 directed interactions/s
(BASELINE.md). With ``--n``/``--solver`` it benchmarks that single
configuration instead (one JSON line).

A failed leg or probe prints its error on stderr; the other legs and
probes still run and flush, and the process then exits 1. It exits 0 only
when every leg and probe ran.

Timing: each timed window ends with ``torch.cuda.synchronize()`` on the
card. ``backend`` is the device type (``"cuda"`` or ``"cpu"``) and
``device`` the card's name. Every entry point runs on ``--device cuda``
unless ``--device cpu`` is given; without a GPU that is an error. On the
card ``Simulation.run`` replays CUDA graphs that its first call captures
(``graphs``): the capture falls in the warm-up, and its seconds go to
stderr on a line of their own. Each leg's wall time and, on the card, its
peak device memory (``torch.cuda.max_memory_allocated``) go to stderr too,
not into the record.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

BASELINE = 2.6e11  # derived 4090 directed interactions/s (BASELINE.md)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    """The card's name, or the device type off the card."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def card(device: torch.device) -> dict:
    """``{"device": name, "power_limit": limit}`` for a record: the card's
    name and its power limit as ``nvidia-smi --query-gpu=name,power.limit``
    reports it (``"700.00 W"``; a card set below its maximum runs slower
    under load); off the card the device type and ``None``."""
    if device.type != "cuda":
        return {"device": device.type, "power_limit": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    line = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout
    return {"device": device_name(device), "power_limit": line.strip().rsplit(",", 1)[1].strip()}


def time_config(n: int, solver: str, steps: int, warmup: int = 1,
                probe_error: bool | None = None, windows: int = 3,
                chunks: int = 1, device: str | torch.device = "cuda", **cfg_kw):
    """Time one configuration; returns ``(record, probe_fn)``.

    ``record`` carries the timing; ``probe_fn`` (or ``None``) is a
    deferred closure that runs the exact-oracle error probe and mutates
    ``record`` in place with the ``probe_depth_steps`` and ``force_err_*``
    fields, so the suite can flush a finished timing before it spends
    anything on the probe.

    Extra kwargs are SimConfig overrides. ``chunks`` > 1 times that many
    sequential ``run(steps)`` calls per window (total steps = ``steps *
    chunks``). The best of ``windows`` windows is kept."""
    from n_body_problem_tpu_torch import SimConfig, Simulation, models
    from n_body_problem_tpu_torch.simulation import resolve_device

    cfg = SimConfig(solver=solver, **cfg_kw)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_leg = time.perf_counter()
    sim = Simulation(cfg, models.plummer(n, seed=0), device=dev)
    print(f"bench: n={n} padded={sim.state.n} solver={solver} "
          f"steps={steps}", file=sys.stderr)

    # Warm up with the same step count (first-call costs: the kernel
    # library's load, the allocator's pools).
    for _ in range(max(warmup, 1)):
        sim.run(steps)
    _sync(dev)
    print(f"bench: capture {sim.capture_seconds:.3f} s (the CUDA graphs' warm-up and "
          f"capture, in the warm-up)", file=sys.stderr)

    # Snapshot the post-warmup state for the error probe before the timed
    # windows evolve it further: the probe depth is a fixed function of the
    # leg (warmup * steps), not of how many timed windows follow (force
    # error grows as the Plummer core collapses). Host copies, so that the
    # probe does not hold device memory through the timed windows.
    probe_pos = sim.state.pos.cpu().numpy()
    probe_mass = sim.state.mass.cpu().numpy()
    rcfg = sim.cfg  # resolved config (auto caps filled in)

    dt = float("inf")
    total = steps * max(chunks, 1)
    for _ in range(max(windows, 1)):
        t0 = time.perf_counter()
        for _ in range(max(chunks, 1)):
            sim.run(steps)
        _sync(dev)
        dt = min(dt, time.perf_counter() - t0)

    out = {
        "solver": solver,
        "n": n,
        "n_padded": sim.state.n,
        "steps_timed": total,
        "ms_per_step": dt / total * 1e3,
        "pairs_per_sec": sim.pairs_per_step() * total / dt,
        "padded_pairs_per_sec": sim.padded_pairs_per_step() * total / dt,
    }
    peak = (f", peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB"
            if dev.type == "cuda" else "")
    print(f"bench: {out['ms_per_step']:.3f} ms/step, "
          f"{out['pairs_per_sec']:.3e} pairs/s; leg wall "
          f"{time.perf_counter() - t_leg:.1f} s{peak}", file=sys.stderr)
    del sim
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    if probe_error is None:
        probe_error = solver == "treecode"
    if not probe_error:
        return out, None

    def probe() -> dict:
        # Exact oracle on bodies of the post-warmup state, stride-sampled
        # over the Morton-sorted order (a spatially stratified sample:
        # core and halo covered proportionally). 2,048 samples put the
        # empirical p99 between the true p98.3 and p99.7 (95 % CI) at any N.
        from n_body_problem_tpu_torch.ops import cuda_force
        from n_body_problem_tpu_torch.ops.registry import make_force_fn

        n_pad = probe_pos.shape[0]
        out["probe_depth_steps"] = steps * max(warmup, 1)
        sub = np.arange(0, n_pad, max(n_pad // 2048, 1))
        pos = torch.from_numpy(probe_pos).to(dev)
        mass = torch.from_numpy(probe_mass).to(dev)
        force_fn = make_force_fn(rcfg, dev.type, n_pad)
        approx = force_fn(pos, mass).cpu().numpy()[sub]
        # The oracle's rows in chunks of the JAX probe's budget (~1.5 GB of
        # (rows, N, 3) transient in its plain form): the all-pairs kernel's
        # block form on the card, its plain twin on the CPU.
        rows = min(512, max(64, int(1.5e9 // (12 * n_pad))))
        sub_t = torch.from_numpy(sub).to(dev)
        exact = np.concatenate([
            cuda_force.block_acc(pos[sub_t[a:a + rows]], pos, mass, tile_i=1, tile_j=1,
                                 eps2=cfg.eps2, compensate=cfg.compensate,
                                 G=cfg.G).cpu().numpy()
            for a in range(0, len(sub), rows)
        ])
        err = (np.linalg.norm(approx - exact, axis=1)
               / np.maximum(np.linalg.norm(exact, axis=1), 1e-12))
        out["force_err_median"] = float(np.median(err))
        out["force_err_p99"] = float(np.percentile(err, 99))
        print(f"bench: force err median {out['force_err_median']:.2e} "
              f"p99 {out['force_err_p99']:.2e}", file=sys.stderr)
        return out

    return out, probe


def bench_config(n: int, solver: str, steps: int, warmup: int = 1,
                 probe_error: bool | None = None, windows: int = 3,
                 chunks: int = 1, device: str | torch.device = "cuda",
                 **cfg_kw) -> dict:
    """Time one configuration and run its error probe immediately
    (single-config mode; the suite uses :func:`time_config` to defer
    probes past the timing flushes)."""
    out, probe = time_config(n, solver, steps, warmup=warmup,
                             probe_error=probe_error, windows=windows,
                             chunks=chunks, device=device, **cfg_kw)
    if probe is not None:
        probe()
    return out


def bench_render(n: int, solver: str, device: str | torch.device = "cuda") -> float:
    """ms/step including a rendered frame (the reference integrates once
    per rendered frame): ``Simulation.movie`` of 10 steps with a 1024x1024
    frame after each, timed after a warm movie of the same length."""
    from n_body_problem_tpu_torch import SimConfig, Simulation, models
    from n_body_problem_tpu_torch.render import OrbitCamera
    from n_body_problem_tpu_torch.simulation import resolve_device

    dev = resolve_device(device)
    sim = Simulation(SimConfig(solver=solver), models.plummer(n, seed=0), device=dev)
    cam = OrbitCamera(distance=2.0)
    sim.movie(10, render_every=1, camera=cam, width=1024, height=1024)
    _sync(dev)
    t0 = time.perf_counter()
    sim.movie(10, render_every=1, camera=cam, width=1024, height=1024)
    _sync(dev)
    return (time.perf_counter() - t0) / 10 * 1e3


def run_single(n: int, solver: str, steps: int = 0, chunks: int = 1,
               windows: int = 3, device: str | torch.device = "cuda") -> dict:
    """Benchmark one configuration; returns (and prints) the JSON record.

    The CLI's ``bench`` subcommand calls this."""
    from n_body_problem_tpu_torch.simulation import resolve_device

    dev = resolve_device(device)
    n = n or 65536
    solver = solver or "pallas_symmetric"
    steps = steps or (8 if n > 131072 else 16)
    r = bench_config(n, solver, steps, chunks=chunks, windows=windows, device=dev)
    r.update({
        "metric": f"pairwise interactions/sec/chip ({solver}, N={n})",
        "value": r["pairs_per_sec"],
        "unit": "pairs/s",
        "vs_baseline": r["pairs_per_sec"] / BASELINE,
        "backend": dev.type,
        "device": device_name(dev),
    })
    print(json.dumps(r))
    return r


def suite_legs(full: bool) -> list[tuple[str, dict]]:
    """The suite's legs, ``(tag, time_config kwargs)``, as the JAX harness
    has them: the headline four, then with ``full`` the secondary legs."""
    from n_body_problem_tpu_torch.config import tuned_tree_overrides

    legs: list[tuple[str, dict]] = [
        ("sustained_524k", dict(n=524288, solver="treecode", steps=128,
                                chunks=1, windows=1)),
        ("sustained_1m", dict(n=1048576, solver="treecode", steps=48,
                              chunks=2, windows=1)),
        # The reference's own workload with the small-N tuned config.
        ("sustained_20k", dict(n=20480, solver="treecode", steps=1024,
                               chunks=1, windows=1,
                               **tuned_tree_overrides(20480))),
        ("sustained_65k", dict(n=65536, solver="treecode", steps=512,
                               chunks=1, windows=1)),
    ]
    if full:
        legs += [
            ("sustained_262k", dict(n=262144, solver="treecode", steps=256,
                                    chunks=2, windows=1)),
            # Windowed variants: short windows pay proportionally more
            # rebuild overhead than the sustained legs.
            ("20k", dict(n=20480, solver="treecode", steps=256, windows=2,
                         **tuned_tree_overrides(20480))),
            ("524k", dict(n=524288, solver="treecode", steps=32)),
            ("262k", dict(n=262144, solver="treecode", steps=32)),
            ("65k", dict(n=65536, solver="treecode", steps=128)),
            ("1m", dict(n=1048576, solver="treecode", steps=16)),
            # Crossover-bracket legs: tuned configs at the first sizes past
            # the reference's own workload.
            ("24k", dict(n=24576, solver="treecode", steps=256,
                         **tuned_tree_overrides(24576))),
            ("32k", dict(n=32768, solver="treecode", steps=256,
                         **tuned_tree_overrides(32768))),
        ]
    return legs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m n_body_problem_tpu_torch.bench")
    ap.add_argument("--n", type=int, default=0,
                    help="single-config mode: body count")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--solver", type=str, default="")
    ap.add_argument("--chunks", type=int, default=1,
                    help="sequential run(steps) calls per timed window")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--full", action="store_true",
                    help="append the secondary legs (windowed variants, "
                         "262k, 24k/32k bracket, exact brute-force, "
                         "render) after the headline suite")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; give cpu to run on the CPU)")
    args = ap.parse_args(argv)

    from n_body_problem_tpu_torch.simulation import resolve_device

    dev = resolve_device(args.device)
    backend = dev.type

    if args.n or args.solver:
        run_single(args.n, args.solver, args.steps, chunks=args.chunks,
                   windows=args.windows, device=dev)
        return 0

    if args.steps:
        print("bench: --steps is ignored in suite mode (leg step counts "
              "are fixed); use --n for single-config mode", file=sys.stderr)
    legs = suite_legs(args.full)

    done: dict[str, dict] = {}

    def snapshot(total: int, exact20=None, exact65=None, ms_render=None):
        """Cumulative report over completed legs; printed after every leg
        so that a cut run keeps every finished timing."""
        # Largest sustained leg first; the 20k legs are the fallback
        # headline only when nothing bigger has completed.
        order = ("sustained_1m", "sustained_524k", "sustained_262k",
                 "sustained_65k", "1m", "524k", "262k", "65k",
                 "sustained_20k", "20k", "24k", "32k")
        head_tag = next((t for t in order if t in done), None)
        if head_tag is None:
            return
        head = done[head_tag]
        kind = "sustained" if head_tag.startswith("sustained") else "windowed"
        report = {
            "metric": "effective pairwise interactions/sec/chip "
                      f"(treecode {kind}, N={head['n']})",
            "value": head["pairs_per_sec"],
            "unit": "pairs/s",
            "vs_baseline": head["pairs_per_sec"] / BASELINE,
            "ms_per_step": head["ms_per_step"],
            "force_err_p99": head.get("force_err_p99"),
            "force_err_median": head.get("force_err_median"),
            "n": head["n"],
            "solver": "treecode",
            "backend": backend,
            "device": device_name(dev),
            "legs_done": len(done),
            "legs_total": total,
        }
        for tag, leg in done.items():
            report[f"tree_pairs_per_sec_{tag}"] = leg["pairs_per_sec"]
            report[f"tree_ms_per_step_{tag}"] = leg["ms_per_step"]
            report[f"tree_vs_baseline_{tag}"] = leg["pairs_per_sec"] / BASELINE
            report[f"tree_force_err_p99_{tag}"] = leg.get("force_err_p99")
        if exact20 is not None:
            report["exact_pairs_per_sec_20k"] = exact20["pairs_per_sec"]
            report["exact_ms_per_step_20k"] = exact20["ms_per_step"]
            report["exact_vs_baseline_20k"] = exact20["pairs_per_sec"] / BASELINE
        if exact65 is not None:
            report["exact_pairs_per_sec_65k"] = exact65["pairs_per_sec"]
            report["exact_ms_per_step_65k"] = exact65["ms_per_step"]
            report["exact_vs_baseline"] = exact65["pairs_per_sec"] / BASELINE
        if ms_render is not None:
            report["ms_per_step_with_render_65k"] = ms_render
        print(json.dumps(report), flush=True)

    failed: list[str] = []

    def safe(what: str, fn, *a, **kw):
        try:
            return fn(*a, **kw)
        except Exception as e:
            print(f"bench: {what} failed: {e!r}", file=sys.stderr)
            failed.append(what)
            return None

    # Phase 1: timings only, flushing after each leg.
    total = len(legs)
    probes: list[tuple[int, str, callable]] = []
    for tag, kw in legs:
        r = safe(f"leg {tag}", time_config, device=dev, **kw)
        if r is not None:
            rec, probe = r
            done[tag] = rec
            if probe is not None:
                probes.append((kw["n"], tag, probe))
            snapshot(total)

    # Phase 2: deferred error probes, cheapest first. A probe mutates its
    # leg's record in place, so re-snapshotting publishes it.
    for _, tag, probe in sorted(probes, key=lambda p: p[0]):
        if safe(f"probe {tag}", probe) is not None:
            snapshot(total)

    exact20 = exact65 = ms_render = None
    if args.full:
        exact20 = safe("leg exact_20k", bench_config, 20480, "pallas_symmetric",
                       steps=64, device=dev)
        exact65 = safe("leg exact_65k", bench_config, 65536, "pallas_symmetric",
                       steps=16, device=dev)
        ms_render = safe("leg render_65k", bench_render, 65536, "pallas_symmetric",
                         device=dev)

    if not done:
        print("bench: every treecode leg failed; no headline to report",
              file=sys.stderr)
        return 1
    snapshot(total, exact20, exact65, ms_render)
    if failed:
        print(f"bench: {len(failed)} failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
