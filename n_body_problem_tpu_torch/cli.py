"""Command-line interface.

Counterpart of ``n_body_problem_tpu.cli`` for the ported slice:

    python -m n_body_problem_tpu_torch run --model plummer --n 65536 --steps 100
    python -m n_body_problem_tpu_torch run --model galaxy_collision --n 20480 \
        --solver treecode --tree-tuned --steps 100
    python -m n_body_problem_tpu_torch info

``run`` is headless: physics runs on ``--device`` (``cuda`` unless
``--device cpu`` is given; without a GPU that is an error) in
``--steps-per-block`` chunks, with diagnostics and checkpoints in
``--out``. Flags of features this package does not have yet are accepted
and rejected with the ROADMAP item that will bring them.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

# Physics flags default to None sentinels so _build_config can tell "user
# typed it" from "argparse default": a --config file's (or a resumed
# checkpoint's) physics is not clobbered by defaults.
_PHYSICS_FLAGS = ("dt", "eps2", "compensate", "G", "solver", "integrator")

# Flag (argparse dest) -> the ROADMAP item that ports it. A flag counts as
# used when its value differs from the parser's default.
_NOT_PORTED = {
    "dataset": "ROADMAP §1 item 7 (dataset readers; use --model)",
    "data_dir": "ROADMAP §1 item 7 (dataset readers; use --model)",
    "quirk_compat": "ROADMAP §1 item 7 (dataset readers)",
    "render_every": "ROADMAP §1 item 6 (rendering)",
    "serve": "ROADMAP §1 item 6 (live viewer)",
    "gif": "ROADMAP §1 item 6 (rendering)",
    "export_snap": "ROADMAP §1 item 7 (export_snap)",
    "profile": "ROADMAP §1 item 8 (bench and profiling)",
}


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


def _reject_unported(args) -> None:
    defaults = vars(build_parser().parse_args(["run"]))
    for dest, item in _NOT_PORTED.items():
        if getattr(args, dest) != defaults[dest]:
            flag = "--" + dest.replace("_", "-")
            raise NotImplementedError(f"{flag} is not ported yet: {item}")
    if args.devices > 1:
        raise NotImplementedError(
            "--devices > 1 is not ported yet: ROADMAP §1 item 9 (multi-GPU)")
    if not (args.model or args.resume):
        raise NotImplementedError(
            "dataset files are not ported yet: ROADMAP §1 item 7; "
            "give --model or --resume")


def cmd_run(args) -> int:
    import numpy as np

    from n_body_problem_tpu_torch import Simulation
    from n_body_problem_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from n_body_problem_tpu_torch.models import make_model
    from n_body_problem_tpu_torch.utils.metrics import StepTimer

    _reject_unported(args)
    ck_cfg = None
    if args.resume:
        state, ck_cfg = load_checkpoint(args.resume)
    else:
        state = make_model(args.model, args.n, seed=args.seed)
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
    out.mkdir(parents=True, exist_ok=True)

    sim = Simulation(cfg, state, device=args.device)
    print(
        f"n={sim.state.n_real} (padded {sim.state.n})  solver={cfg.solver}  "
        f"integrator={cfg.integrator}  dt={cfg.dt}", file=sys.stderr,
    )
    if args.diag_every:
        d = sim.diagnostics()
        e0 = d["energy"]
        print(f"E0={e0:.6e}  |p|={np.linalg.norm(d['momentum']):.3e}", file=sys.stderr)
    timer = StepTimer(n_bodies=sim.state.n_real)

    # A block must not straddle any output interval, or events get skipped.
    intervals = [v for v in (args.diag_every, args.checkpoint_every) if v > 0]
    block = min([args.steps_per_block] + intervals)
    done = 0
    while done < args.steps:
        todo = min(block, args.steps - done)
        timer.start()
        sim.run(todo)
        timer.stop(todo)
        done += todo
        if timer.window_full:
            timer.report()
        if args.diag_every and done % args.diag_every < todo:
            d = sim.diagnostics()
            drift = (d["energy"] - e0) / abs(e0) if e0 else 0.0
            print(
                f"[step {done}] E={d['energy']:.6e} drift={drift:+.2e} "
                f"overspeed={d['overspeed']}", file=sys.stderr,
            )
        if args.checkpoint_every and done % args.checkpoint_every < todo:
            save_checkpoint(out / f"ck_{done:08d}.npz", sim.state, cfg)

    save_checkpoint(out / "final.npz", sim.state, cfg)
    wall = timer.total_time
    print(
        f"done: {args.steps} steps in {wall:.2f}s "
        f"({sim.pairs_per_step() * args.steps / max(wall, 1e-9):.3e} pairs/s); "
        f"outputs in {out}", file=sys.stderr,
    )
    return 0


def cmd_info(args) -> int:
    import torch

    from n_body_problem_tpu_torch import __version__
    from n_body_problem_tpu_torch.config import INTEGRATORS, SOLVERS
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
    print(f"solvers: {', '.join(SOLVERS)}")
    print(f"integrators: {', '.join(INTEGRATORS)}")
    print(f"models: {', '.join(sorted(MODELS))}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="n_body_problem_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run a simulation headlessly")
    src = r.add_argument_group("initial conditions")
    src.add_argument("--model", help="procedural model (see `info`)")
    src.add_argument("--n", type=int, default=8192)
    src.add_argument("--seed", type=int, default=0)
    src.add_argument("--resume", help="checkpoint .npz to resume from")
    src.add_argument("--dataset", type=int, default=None, help="not ported yet")
    src.add_argument("--data-dir", default=None, help="not ported yet")
    src.add_argument("--quirk-compat", action="store_true", help="not ported yet")
    _add_physics_flags(r)
    r.add_argument("--device", default="cuda",
                   help="torch device (default cuda; give cpu to run on the CPU)")
    r.add_argument("--steps", type=int, default=1000)
    r.add_argument("--steps-per-block", type=int, default=50)
    r.add_argument("--out", default="out")
    r.add_argument("--diag-every", type=int, default=0)
    r.add_argument("--checkpoint-every", type=int, default=0)
    r.add_argument("--render-every", type=int, default=0, help="not ported yet")
    r.add_argument("--serve", type=int, default=0, metavar="PORT", help="not ported yet")
    r.add_argument("--gif", action="store_true", help="not ported yet")
    r.add_argument("--export-snap", action="store_true", help="not ported yet")
    r.add_argument("--morton-sort", action="store_true",
                   help="Z-order bodies at init (tile locality)")
    r.add_argument("--tree-tuned", action="store_true",
                   help="apply the measured per-N treecode tuning table "
                        "(config.tuned_tree_overrides)")
    r.add_argument("--profile", action="store_true", help="not ported yet")
    r.add_argument("--devices", type=int, default=1, help="only 1 is ported")
    r.set_defaults(fn=cmd_run)

    i = sub.add_parser("info", help="environment, kernels, solvers")
    i.set_defaults(fn=cmd_info)
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
