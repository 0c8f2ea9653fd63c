"""Sharded runs at scale: ms/step by body count, ranks and strategy.

Counterpart of the JAX package's ``tools/mesh_scaling.py``: the half ring
at 16,384 and 32,768 bodies and the sharded treecode (the dense path,
``tree_flat_cap=-1``) at 65,536 and 262,144, over D = 8 ranks, each run
once to warm and once timed, with its positions checked finite. On the CPU
(gloo ranks) the times are the host's and say nothing of a GPU; the point
there is that the distributed paths run at these sizes. On ``cuda`` (NCCL,
one rank a GPU) D is at most the GPUs there are. ``--n`` runs every
strategy at one size instead, ``--devices`` sets D.

    python -m n_body_problem_tpu_torch.mesh_scaling --device cpu [--steps 1]
        [--out validation/torch_mesh_scaling.json]
"""

from __future__ import annotations

import argparse
import json
import sys

CONFIGS = ((16384, "half_ring"), (32768, "half_ring"), (65536, "treecode"),
           (262144, "treecode"))
DEVICES = 8


def config(strategy: str, steps: int):
    """The JAX tool's config of a strategy."""
    from n_body_problem_tpu_torch import SimConfig

    if strategy == "treecode":
        return SimConfig(solver="treecode", donate=False, tree_vip_tiles=32,
                         tree_rebuild_every=steps, tree_flat_cap=-1)
    return SimConfig(solver="direct", donate=False)


def scaling_rank(mesh, runs, steps: int) -> list[dict]:
    """Each ``(n, strategy)`` of ``runs`` on one rank (``spawn_ring``'s
    target): warm, then timed; rank 0's rows."""
    import torch

    from n_body_problem_tpu_torch import models
    from n_body_problem_tpu_torch.parallel import ShardedSimulation

    rows = []
    key = f"ms_per_step_{mesh.device.type}"
    for n, strategy in runs:
        sim = ShardedSimulation(config(strategy, steps), models.plummer(n, seed=0), mesh,
                                strategy=strategy)
        sim.run(steps)
        wall0 = sim.wall_seconds
        sim.run(steps)
        ms = (sim.wall_seconds - wall0) / steps * 1e3
        finite = bool(torch.isfinite(sim.gather_state().pos).all())
        if mesh.rank == 0:
            print(f"mesh_scaling: N={n} D={mesh.size} {strategy}: {ms:.1f} ms/step "
                  f"finite={finite}", file=sys.stderr, flush=True)
        rows.append(dict(n=n, devices=mesh.size, strategy=strategy, **{key: ms},
                         finite=finite))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--out", default="validation/torch_mesh_scaling.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (NCCL, default) or cpu (gloo)")
    ap.add_argument("--devices", type=int, default=None,
                    help=f"ranks (default {DEVICES}; on cuda at most the GPUs there are)")
    ap.add_argument("--n", type=int, default=None,
                    help="run every strategy at this many bodies instead")
    args = ap.parse_args(argv)
    import torch

    from n_body_problem_tpu_torch.parallel import spawn_ring

    d = args.devices
    if d is None:
        d = min(DEVICES, torch.cuda.device_count()) if args.device == "cuda" else DEVICES
    runs = CONFIGS if args.n is None else tuple(
        dict.fromkeys((args.n, s) for _, s in CONFIGS))
    try:
        rows = spawn_ring(scaling_rank, d, device_type=args.device, args=(runs, args.steps))
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    backend = {"cpu": "gloo-cpu", "cuda": "nccl-cuda"}[args.device]
    out = dict(backend=backend, steps=args.steps, results=rows)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0 if all(r["finite"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
