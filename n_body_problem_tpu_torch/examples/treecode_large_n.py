"""Barnes-Hut treecode: past the brute-force wall.

The exact solvers evaluate N^2 pairs; the treecode's mass-aware MAC
acceptance runs the same physics at a fraction of the pair work (p99
relative force error near 1e-3 at the default ``tree_mac_tau=2e-4``).

    python -m n_body_problem_tpu_torch.examples.treecode_large_n --n 262144 --steps 64
"""

from __future__ import annotations

import argparse
import time

from n_body_problem_tpu_torch import SimConfig, Simulation, models
from n_body_problem_tpu_torch.bench import _sync


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m n_body_problem_tpu_torch.examples.treecode_large_n")
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--tau", type=float, default=0.0,
                    help="tree_mac_tau override (0 keeps the default)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; give cpu to run on the CPU)")
    args = ap.parse_args(argv)

    over = {"tree_mac_tau": args.tau} if args.tau else {}
    cfg = SimConfig(solver="treecode", **over)
    sim = Simulation(cfg, models.plummer(args.n, seed=0), device=args.device)
    print(f"n={sim.state.n_real}  mac_tau={cfg.tree_mac_tau}  "
          f"near capacity={sim.cfg.tree_max_near} tiles  "
          f"flat cap={sim.cfg.tree_flat_cap}")

    d0 = sim.diagnostics()
    sim.run(args.steps)          # warm-up
    _sync(sim.device)
    t0 = time.perf_counter()
    sim.run(args.steps)
    _sync(sim.device)
    dt = time.perf_counter() - t0

    d = sim.diagnostics()
    drift = (d["energy"] - d0["energy"]) / abs(d0["energy"])
    eff = sim.pairs_per_step() * args.steps / dt
    print(f"{dt / args.steps * 1e3:.2f} ms/step  "
          f"effective {eff:.3e} pairs/s  dE/E={drift:+.2e}  "
          f"overspeed={d['overspeed']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
