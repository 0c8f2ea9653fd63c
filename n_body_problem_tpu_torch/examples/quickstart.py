"""Quickstart: simulate a Plummer sphere and track energy drift.

    python -m n_body_problem_tpu_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

import n_body_problem_tpu_torch as nb


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m n_body_problem_tpu_torch.examples.quickstart")
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--steps", type=int, default=200, help="steps a block")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; give cpu to run on the CPU)")
    args = ap.parse_args(argv)

    cfg = nb.SimConfig(dt=0.008)                 # the reference's physics defaults
    state = nb.models.plummer(args.n, seed=0)
    sim = nb.Simulation(cfg, state, device=args.device)

    d0 = sim.diagnostics()
    print(f"N={sim.state.n_real}  E0={d0['energy']:.6e}  solver={cfg.solver}")

    for _ in range(args.blocks):
        sim.run(args.steps)
        d = sim.diagnostics()
        drift = (d["energy"] - d0["energy"]) / abs(d0["energy"])
        print(f"step {d['step']:>5d}  E={d['energy']:.6e}  drift={drift:+.2e}  "
              f"|p|={np.linalg.norm(d['momentum']):.2e}")

    print(f"wall: {sim.wall_seconds:.2f}s "
          f"({sim.pairs_per_step() * args.blocks * args.steps / sim.wall_seconds:.3e} pairs/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
