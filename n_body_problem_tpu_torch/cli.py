"""Command-line interface.

Counterpart of ``n_body_problem_tpu.cli``:

    python -m n_body_problem_tpu_torch run --steps 1000   # dataset 1
    python -m n_body_problem_tpu_torch run --dataset 0 --data-dir data \
        --steps 1000 --render-every 50 --gif
    python -m n_body_problem_tpu_torch run --dataset 0 --data-dir data \
        --solver treecode --tree-tuned --steps 100 --export-snap --profile
    python -m n_body_problem_tpu_torch run --model plummer --n 65536 --serve 8000
    python -m n_body_problem_tpu_torch run --model plummer --n 262144 --devices 4 \
        --strategy half_ring --steps 100
    python -m n_body_problem_tpu_torch run --model plummer --n 1048576 --devices 4 \
        --strategy treecode_staged --steps 100
    python -m n_body_problem_tpu_torch info
    python -m n_body_problem_tpu_torch convert data/galaxy_20K.bin out.csv
    python -m n_body_problem_tpu_torch render out/final.npz frame.png
    python -m n_body_problem_tpu_torch bench --n 65536 --steps 20

``run`` is headless: physics runs on ``--device`` (``cuda`` unless
``--device cpu`` is given; without a GPU that is an error) in
``--steps-per-block`` chunks; frames are rendered on that device and
written to ``--out``/frames by a background writer (``--render-every``,
``--gif``) or streamed to the live viewer (``--serve``, which renders every
block unless ``--render-every`` says otherwise); diagnostics, checkpoints,
the snap export and the profiler's trace land in ``--out``. With no
``--model`` or ``--resume`` it loads ``--dataset`` (default 1, as the
reference), whose procedural fallback runs when the file is absent.
``--gif`` and ``--serve`` need Pillow. ``--devices D > 1`` shards the
bodies over D ranks, one process each (``parallel.spawn_ring``), with the
``--strategy`` of ``ShardedSimulation``: NCCL on ``cuda``, where D is at
most the number of GPUs, and gloo with ``--device cpu``. Rank 0 alone
prints and writes; every output is of the state gathered from all ranks.
The staged treecode (``--strategy treecode_staged``) needs at least 2,048
bodies a rank; below, it exits 2 with ``ShardedSimulation``'s message.
"""

from __future__ import annotations

import argparse
import contextlib
import pathlib
import sys

# Physics flags default to None sentinels so _build_config can tell "user
# typed it" from "argparse default": a --config file's (or a resumed
# checkpoint's) physics is not clobbered by defaults.
_PHYSICS_FLAGS = ("dt", "eps2", "compensate", "G", "solver", "integrator")


def _add_physics_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dt", type=float, default=None, help="timestep (default 0.008)")
    p.add_argument("--eps2", type=float, default=None,
                   help="softening added to the scaled r^2 (default 1e-6)")
    p.add_argument("--compensate", type=float, default=None,
                   help="separation pre-scale (default 0.1)")
    p.add_argument("--g", type=float, default=None, dest="G",
                   help="gravitational constant (default 1)")
    p.add_argument("--solver", default=None,
                   help="force solver (default auto; see `info` for choices)")
    p.add_argument("--integrator", default=None,
                   choices=["semi_implicit_euler", "leapfrog"],
                   help="(default semi_implicit_euler)")
    p.add_argument("--config", help="JSON/TOML config file (flags override)")


def _add_camera_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--cam-theta", type=float, default=0.0)
    p.add_argument("--cam-phi", type=float, default=20.0)
    p.add_argument("--cam-zoom", type=float, default=1.0)


def _build_config(args, base=None):
    """Config precedence: checkpoint < --config file < explicit CLI flags."""
    from n_body_problem_tpu_torch.config import SimConfig

    if getattr(args, "config", None):
        base = SimConfig.from_file(args.config)
    if base is None:
        base = SimConfig()
    overrides = {
        k: getattr(args, k) for k in _PHYSICS_FLAGS
        if getattr(args, k, None) is not None
    }
    return base.replace(**overrides) if overrides else base


def _load_initial_state(args):
    """Returns (state, scale_factors, camera_distance, checkpoint_cfg|None);
    the state is on the CPU."""
    from n_body_problem_tpu_torch.io.datasets import load_dataset
    from n_body_problem_tpu_torch.models import make_model

    if args.resume:
        from n_body_problem_tpu_torch.io.checkpoint import load_checkpoint

        # The checkpoint's saved config is the base for resumed runs: the
        # run continues with the physics it was created with unless flags
        # explicitly override.
        state, ck_cfg = load_checkpoint(args.resume)
        return state, (0.0, 0.0, 0.0), 1.0, ck_cfg
    if args.model:
        state = make_model(args.model, args.n, seed=args.seed)
        return state, (0.0, 0.0, 0.0), 1.0, None
    state, spec = load_dataset(
        args.dataset, directory=args.data_dir, quirk_compat=args.quirk_compat,
        seed=args.seed,
    )
    return state, spec.scale_factors, spec.camera_distance, None


def cmd_run(args) -> int:
    from n_body_problem_tpu_torch.simulation import resolve_device

    device = resolve_device(args.device)  # before any data is read
    if args.devices > 1:
        from n_body_problem_tpu_torch.parallel import spawn_ring

        return spawn_ring(_run_rank, args.devices, device_type=device.type, args=(args,))
    return _run(args)


def _run_rank(mesh, args) -> int:
    """``run`` on one rank of a ring (:func:`parallel.spawn_ring`'s target)."""
    return _run(args, mesh)


def _run(args, mesh=None) -> int:
    """``run`` on one device, or as one rank of ``mesh``: then every rank
    steps its shard and gathers the whole state at the same steps, and rank
    0 alone prints, renders and writes."""
    import numpy as np

    from n_body_problem_tpu_torch import Simulation
    from n_body_problem_tpu_torch.io.checkpoint import export_snap, save_checkpoint
    from n_body_problem_tpu_torch.render import FrameWriter, OrbitCamera, render_state
    from n_body_problem_tpu_torch.utils.metrics import StepTimer
    from n_body_problem_tpu_torch.utils.profiling import trace

    lead = mesh is None or mesh.rank == 0
    log = (lambda *a: print(*a, file=sys.stderr)) if lead else (lambda *a: None)
    state, scales, cam_dist, ck_cfg = _load_initial_state(args)
    cfg = _build_config(args, base=ck_cfg)
    if args.morton_sort:
        cfg = cfg.replace(morton_sort=True)
    if args.tree_tuned:
        from n_body_problem_tpu_torch.config import tuned_tree_overrides
        from n_body_problem_tpu_torch.ops.forces import required_padding

        # Bracket on the padded body count, which the tuning table was
        # measured at (the treecode pads to a multiple of 256).
        padded = required_padding("treecode", state.n_real, cfg.block_size)
        cfg = cfg.replace(**tuned_tree_overrides(padded))
    out = pathlib.Path(args.out)
    if lead:
        out.mkdir(parents=True, exist_ok=True)

    if mesh is None:
        sim = Simulation(cfg, state, device=args.device)
        padded, whole = sim.state.n, lambda: sim.state
    else:
        from n_body_problem_tpu_torch.parallel import ShardedSimulation

        sim = ShardedSimulation(cfg, state, mesh, strategy=args.strategy)
        padded, whole = sim.n, sim.gather_state
    log(f"n={sim.state.n_real} (padded {padded})  solver={cfg.solver}  "
        f"integrator={cfg.integrator}  dt={cfg.dt}"
        + (f"  devices={mesh.size} strategy={args.strategy}" if mesh else ""))
    if args.diag_every:
        d = sim.diagnostics()
        e0 = d["energy"]
        log(f"E0={e0:.6e}  |p|={np.linalg.norm(d['momentum']):.3e}")

    camera = OrbitCamera(
        theta_deg=args.cam_theta, phi_deg=args.cam_phi,
        distance=cam_dist * args.cam_zoom, aspect=args.width / args.height,
    )
    render_every = args.render_every
    live = None
    if args.serve and lead:
        from n_body_problem_tpu_torch.render.server import LiveViewer

        live = LiveViewer(args.serve, camera, exposure=args.exposure,
                          host=args.serve_host)
        live.stats["n"] = sim.state.n_real
        print(f"live viewer: http://{args.serve_host}:{live.port}/",
              file=sys.stderr)
    if args.serve:
        render_every = render_every or args.steps_per_block
    viewer = (
        FrameWriter(out / "frames", exposure=args.exposure)
        if args.render_every and lead else None
    )
    timer = StepTimer(n_bodies=sim.state.n_real)

    # A block must not straddle any output interval, or events get skipped.
    intervals = [v for v in (render_every, args.diag_every,
                             args.checkpoint_every) if v > 0]
    block = min([args.steps_per_block] + intervals)
    done = 0
    frame_idx = 0
    try:
        with trace(out / "profile" if args.profile and lead else None):
            while done < args.steps:
                todo = min(block, args.steps - done)
                timer.start()
                sim.run(todo)
                timer.stop(todo)
                done += todo
                if timer.window_full and lead:
                    timer.report()
                if render_every and done % render_every < todo:
                    current = whole()   # every rank gathers; rank 0 renders
                    lock = live.camera_lock if live else contextlib.nullcontext()
                    with lock:  # /control mutates the camera concurrently
                        frame = render_state(
                            current, camera, scales,
                            width=args.width, height=args.height,
                        ) if lead else None
                    if live:
                        live.submit(frame)
                        live.stats.update(
                            step=done,
                            ms_per_step=timer.total_time
                            / max(timer.total_steps, 1) * 1e3,
                        )
                    if viewer:
                        viewer.submit(frame_idx, frame)
                        frame_idx += 1
                if args.diag_every and done % args.diag_every < todo:
                    d = sim.diagnostics()
                    drift = (d["energy"] - e0) / abs(e0) if e0 else 0.0
                    log(f"[step {done}] E={d['energy']:.6e} drift={drift:+.2e} "
                        f"overspeed={d['overspeed']}")
                if args.checkpoint_every and done % args.checkpoint_every < todo:
                    current = whole()
                    if lead:
                        save_checkpoint(out / f"ck_{done:08d}.npz", current, cfg)
    finally:
        if viewer:
            viewer.close()
        if live:
            live.close()

    if args.gif and viewer and viewer.frames_written:
        from n_body_problem_tpu_torch.render.viewer import assemble_gif

        n_frames = assemble_gif(out / "frames", out / "movie.gif", fps=args.gif_fps)
        print(f"assembled movie.gif ({n_frames} frames)", file=sys.stderr)

    final = whole()
    if not lead:
        return 0
    save_checkpoint(out / "final.npz", final, cfg)
    if args.export_snap:
        export_snap(out / "final.snap", final)
    wall = timer.total_time
    log(f"done: {args.steps} steps in {wall:.2f}s "
        f"({sim.pairs_per_step() * args.steps / max(wall, 1e-9):.3e} pairs/s); "
        f"outputs in {out}")
    return 0


def cmd_info(args) -> int:
    import torch

    from n_body_problem_tpu_torch import __version__
    from n_body_problem_tpu_torch.config import INTEGRATORS, SOLVERS
    from n_body_problem_tpu_torch.io import native
    from n_body_problem_tpu_torch.io.datasets import DATASETS
    from n_body_problem_tpu_torch.models import MODELS
    from n_body_problem_tpu_torch.ops import cuda_build

    print(f"n_body_problem_tpu_torch {__version__}")
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}")
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        print(f"devices: {names}")
    else:
        print("devices: cpu only (kernels run their plain PyTorch versions)")
    print(f"kernel sources: {', '.join(p.name for p in cuda_build.sources())}")
    print(f"kernel library: {cuda_build.library_path()}"
          f"{'' if cuda_build.library_path().is_file() else ' (built at first use)'}")
    print(f"native io: {'available' if native.available() else 'python fallback'}")
    print(f"solvers: {', '.join(SOLVERS)}")
    print(f"integrators: {', '.join(INTEGRATORS)}")
    print(f"models: {', '.join(sorted(MODELS))}")
    print("datasets:")
    for i, spec in sorted(DATASETS.items()):
        print(f"  {i}: {spec.name:<12} {spec.reader:<6} scales={spec.scale_factors}"
              f"  {spec.description}")
    return 0


def cmd_convert(args) -> int:
    from n_body_problem_tpu_torch.io.convert import tipsy_to_csv

    n = tipsy_to_csv(args.src, args.dst)
    print(f"wrote {n} bodies to {args.dst}", file=sys.stderr)
    return 0


def cmd_render(args) -> int:
    from n_body_problem_tpu_torch.io.checkpoint import load_checkpoint
    from n_body_problem_tpu_torch.render import OrbitCamera, render_state, tonemap, write_png
    from n_body_problem_tpu_torch.render.image import to_host
    from n_body_problem_tpu_torch.simulation import resolve_device

    state, _ = load_checkpoint(args.checkpoint, resolve_device(args.device))
    camera = OrbitCamera(
        theta_deg=args.cam_theta, phi_deg=args.cam_phi, distance=args.cam_zoom,
        aspect=args.width / args.height,
    )
    frame = render_state(
        state, camera, tuple(args.scales), width=args.width, height=args.height
    )
    write_png(args.output, tonemap(to_host(frame), exposure=args.exposure))
    print(f"wrote {args.output}", file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    from n_body_problem_tpu_torch import bench

    bench.run_single(args.n, args.solver, args.steps, device=args.device)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="n_body_problem_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run a simulation headlessly")
    src = r.add_argument_group("initial conditions")
    src.add_argument("--dataset", type=int, default=1,
                     help="dataset id 0-5 (default 1, as the reference)")
    src.add_argument("--data-dir", default=None,
                     help="dataset directory (default $NBODY_DATA_DIR, else ./data)")
    src.add_argument("--model", help="procedural model instead of a dataset (see `info`)")
    src.add_argument("--n", type=int, default=8192)
    src.add_argument("--seed", type=int, default=0)
    src.add_argument("--resume", help="checkpoint .npz to resume from")
    src.add_argument("--quirk-compat", action="store_true",
                     help="reproduce reference loader quirks (Q1)")
    _add_physics_flags(r)
    r.add_argument("--device", default="cuda",
                   help="torch device (default cuda; give cpu to run on the CPU)")
    r.add_argument("--steps", type=int, default=1000)
    r.add_argument("--steps-per-block", type=int, default=50)
    r.add_argument("--out", default="out")
    r.add_argument("--diag-every", type=int, default=0)
    r.add_argument("--checkpoint-every", type=int, default=0)
    r.add_argument("--render-every", type=int, default=0,
                   help="write a frame to <out>/frames every this many steps")
    r.add_argument("--serve", type=int, default=0, metavar="PORT",
                   help="live HTTP viewer (MJPEG + orbit/zoom controls; needs "
                        "Pillow); renders every --render-every steps (default: "
                        "every steps-per-block)")
    r.add_argument("--serve-host", default="127.0.0.1")
    r.add_argument("--gif", action="store_true",
                   help="assemble frames into movie.gif (needs Pillow)")
    r.add_argument("--gif-fps", type=float, default=25.0)
    _add_camera_flags(r)
    r.add_argument("--export-snap", action="store_true",
                   help="write the final state as <out>/final.snap")
    r.add_argument("--morton-sort", action="store_true",
                   help="Z-order bodies at init (tile locality)")
    r.add_argument("--tree-tuned", action="store_true",
                   help="apply the measured per-N treecode tuning table "
                        "(config.tuned_tree_overrides)")
    r.add_argument("--profile", action="store_true",
                   help="torch.profiler trace of the run in <out>/profile")
    r.add_argument("--devices", type=int, default=1,
                   help="shard bodies over a ring of this many devices, one rank "
                        "each: GPUs (NCCL) on cuda, CPU processes (gloo) with "
                        "--device cpu")
    r.add_argument("--strategy", default="ring",
                   choices=["ring", "half_ring", "treecode", "treecode_staged"],
                   help="distributed force strategy (with --devices > 1): "
                        "exact ring rotation, Newton's-3rd-law half ring, "
                        "the sharded Barnes-Hut treecode (replicated "
                        "sources - the throughput path), or the "
                        "ring-streamed staged treecode (replicated "
                        "summaries - the capacity path, N >= 2048 D)")
    r.set_defaults(fn=cmd_run)

    i = sub.add_parser("info", help="environment, kernels, solvers, datasets")
    i.set_defaults(fn=cmd_info)

    c = sub.add_parser("convert", help="tipsy binary -> csv")
    c.add_argument("src")
    c.add_argument("dst")
    c.set_defaults(fn=cmd_convert)

    rr = sub.add_parser("render", help="render one frame from a checkpoint")
    rr.add_argument("checkpoint")
    rr.add_argument("output")
    rr.add_argument("--scales", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    _add_camera_flags(rr)
    rr.add_argument("--device", default="cuda",
                    help="torch device (default cuda; give cpu to render on the CPU)")
    rr.set_defaults(fn=cmd_render)

    b = sub.add_parser("bench", help="throughput benchmark (one JSON line)")
    b.add_argument("--n", type=int, default=65536)
    b.add_argument("--steps", type=int, default=20)
    b.add_argument("--solver", default="auto")
    b.add_argument("--device", default="cuda",
                   help="torch device (default cuda; give cpu to run on the CPU)")
    b.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (FileNotFoundError, ValueError, NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
