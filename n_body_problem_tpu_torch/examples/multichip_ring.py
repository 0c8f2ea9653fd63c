"""Particle sharding over a ring of devices: the half ring.

    python -m n_body_problem_tpu_torch.examples.multichip_ring [--devices D]
    python -m n_body_problem_tpu_torch.examples.multichip_ring --device cpu --devices 8

One process a rank (``parallel.spawn_ring``): NCCL with one rank a GPU on
``cuda`` (``--devices`` defaults to the GPU count), gloo ranks on the CPU
(default one). Each pair of shards is met once and both sides take the
force (Newton's third law across devices).
"""

from __future__ import annotations

import argparse


def ring_rank(mesh, n: int, blocks: int, steps: int) -> list[str]:
    """One rank's run (``spawn_ring``'s target); rank 0's lines are printed."""
    import n_body_problem_tpu_torch as nb
    from n_body_problem_tpu_torch.parallel import ShardedSimulation

    cfg = nb.SimConfig(solver="direct", integrator="leapfrog", dt=0.005)
    sim = ShardedSimulation(cfg, nb.models.plummer(n, seed=0), mesh, strategy="half_ring")
    lines = [f"mesh: {mesh.size} devices, strategy=half_ring "
             f"(Newton's 3rd law across chips)"]
    for _ in range(blocks):
        sim.run(steps)
        d = sim.diagnostics()
        lines.append(f"step {d['step']:>4d}  E={d['energy']:.6e}  overspeed={d['overspeed']}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m n_body_problem_tpu_torch.examples.multichip_ring")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks (0: every GPU on cuda, one on the CPU)")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--steps", type=int, default=100, help="steps a block")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (NCCL, default) or cpu (gloo)")
    args = ap.parse_args(argv)

    import torch

    from n_body_problem_tpu_torch.parallel import spawn_ring
    from n_body_problem_tpu_torch.simulation import resolve_device

    resolve_device(args.device)
    devices = args.devices or (torch.cuda.device_count() if args.device == "cuda" else 1)
    if devices == 1:
        print(f"note: only 1 device ({args.device}); a world of 1 "
              f"(--device cpu --devices 8 for a world of 8 gloo ranks)")
    for line in spawn_ring(ring_rank, devices, device_type=args.device,
                           args=(args.n, args.blocks, args.steps)):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
