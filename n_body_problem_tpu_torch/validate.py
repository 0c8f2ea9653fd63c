"""Long-run physics validation: conserved-quantity drift and convergence.

Counterpart of the root ``validate.py`` (the JAX package's), with the same
flags and report keys. It runs the workload for many steps and reports the
energy drift, the momentum and angular-momentum errors and the overspeed
count, or (``--convergence``) the integrators' fitted orders and a float64
numpy oracle's trajectory deltas. Prints one JSON report on stdout and
writes no file:

    python -m n_body_problem_tpu_torch.validate --n 20000 --steps 2000 \
        --check-every 500 --solver pallas_symmetric
    python -m n_body_problem_tpu_torch.validate --convergence --n 4096 \
        --solver pallas_symmetric
    python -m n_body_problem_tpu_torch.validate --device cpu --n 256 --steps 20 \
        --check-every 10 --solver direct

Runs on ``--device cuda`` unless ``--device cpu`` is given; without a GPU
that is an error. ``backend`` in the report is the device type; the long
run's report also names the card and its power limit (``device``,
``power_limit``: the device type and ``null`` on the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _numpy_f64_trajectory(pos, vel, mass, *, dt, steps, eps2, compensate,
                          integrator):
    """Float64 oracle: direct-sum + integrator in numpy (chunked rows)."""
    import numpy as np

    pos = np.asarray(pos, np.float64).copy()
    vel = np.asarray(vel, np.float64).copy()
    mass = np.asarray(mass, np.float64)
    c2 = compensate * compensate
    gc3 = c2 * compensate
    n = pos.shape[0]

    def acc_of(p):
        out = np.empty_like(p)
        for a in range(0, n, 1024):
            d = p[None, :, :] - p[a:a + 1024, None, :]
            r2 = np.einsum("ijk,ijk->ij", d, d)
            w = (gc3 * mass)[None, :] * (c2 * r2 + eps2) ** -1.5
            out[a:a + 1024] = np.einsum("ij,ijk->ik", w, d)
        return out

    if integrator == "leapfrog":
        acc = acc_of(pos)
        for _ in range(steps):
            v_half = vel + acc * (0.5 * dt)
            pos = pos + v_half * dt
            acc = acc_of(pos)
            vel = v_half + acc * (0.5 * dt)
    else:
        for _ in range(steps):
            vel = vel + acc_of(pos) * dt
            pos = pos + vel * dt
    return pos, vel


def run_convergence(args) -> dict:
    """dt-scaling + f64-oracle study; prints and returns the report.

    The reference provides no drift number to match, so the criterion is:
    (a) energy drift scales with the integrator's formal order — O(dt) for
    semi-implicit Euler, O(dt^2) for KDK leapfrog — and (b) short f32
    trajectories track a float64 direct-sum oracle to f32-accumulation
    levels.
    """
    from n_body_problem_tpu_torch import SimConfig, Simulation, models

    n = args.n if args.n <= 8192 else 4096
    t_phys = 2.0
    dts = [0.032, 0.016, 0.008, 0.004]
    scaling = {}
    for integrator in ("semi_implicit_euler", "leapfrog"):
        drifts = []
        for dt in dts:
            cfg = SimConfig(dt=dt, solver=args.solver, integrator=integrator)
            sim = Simulation(cfg, models.plummer(n, seed=0), device=args.device)
            e0 = sim.diagnostics()["energy"]
            max_drift = 0.0
            steps = int(round(t_phys / dt))
            for _ in range(16):  # sample the oscillation, not one endpoint
                sim.run(max(steps // 16, 1))
                drift = abs((sim.diagnostics()["energy"] - e0) / e0)
                max_drift = max(max_drift, drift)
            drifts.append(max_drift)
            print(f"convergence: {integrator} dt={dt}: |dE/E| max {max_drift:.3e}",
                  file=sys.stderr)
        # log-log slope: drift ~ dt^p
        p = np.polyfit(np.log(dts), np.log(drifts), 1)[0]
        scaling[integrator] = {"dts": dts, "max_abs_drift": drifts,
                               "fitted_order": float(p)}

    # f64 oracle short-run trajectory deltas (CPU, numpy).
    cfg = SimConfig(dt=0.008, solver=args.solver, integrator="leapfrog")
    state0 = models.plummer(n, seed=0)
    pos0, vel0, mass0 = (x.numpy().copy() for x in (state0.pos, state0.vel, state0.mass))
    sim = Simulation(cfg, state0, device=args.device)
    sim.run(50)
    ref_pos, _ = _numpy_f64_trajectory(
        pos0, vel0, mass0, dt=0.008, steps=50, eps2=cfg.eps2,
        compensate=cfg.compensate, integrator="leapfrog",
    )
    # Simulation may Morton-sort; map back via sort_perm when present.
    got = sim.state.pos[:state0.n].cpu().numpy()
    if sim.sort_perm is not None:
        inv = np.empty_like(sim.sort_perm)
        inv[sim.sort_perm] = np.arange(len(sim.sort_perm))
        got = got[inv]
    delta = np.linalg.norm(got - ref_pos, axis=1)
    disp = np.linalg.norm(ref_pos - pos0, axis=1)
    report = {
        "metric": "integrator order (fitted)",
        "value": scaling["leapfrog"]["fitted_order"],
        "unit": "d log(drift) / d log(dt)",
        "n": n,
        "solver": args.solver,
        "scaling": scaling,
        "oracle_f64": {
            "steps": 50,
            "dt": 0.008,
            "pos_delta_median": float(np.median(delta)),
            "pos_delta_p99": float(np.percentile(delta, 99)),
            "pos_delta_max": float(delta.max()),
            "displacement_median": float(np.median(disp)),
        },
    }
    print(json.dumps(report))
    return report


def run_long(args) -> dict:
    """The long run: conserved quantities every ``--check-every`` steps;
    prints and returns the report (with the card's name and power limit,
    ``bench.card``)."""
    from n_body_problem_tpu_torch import SimConfig, Simulation, models
    from n_body_problem_tpu_torch.bench import card

    cfg = SimConfig(dt=args.dt, solver=args.solver, integrator=args.integrator)
    if args.dataset >= 0:
        from n_body_problem_tpu_torch.io.datasets import load_dataset

        state, _ = load_dataset(args.dataset, directory=args.data_dir)
    else:
        state = models.plummer(args.n, seed=0)

    sim = Simulation(cfg, state, device=args.device)
    d0 = sim.diagnostics()
    e0 = d0["energy"]
    p0 = np.asarray(d0["momentum"])
    L0 = np.asarray(d0["angular_momentum"])
    print(f"validate: n={sim.state.n_real} padded={sim.state.n} "
          f"solver={cfg.solver} E0={e0:.6e}", file=sys.stderr)

    history = []
    t0 = time.perf_counter()
    done = 0
    chunk = args.chunk_steps or args.check_every
    next_check = args.check_every
    while done < args.steps:
        todo = min(chunk, args.steps - done)
        sim.run(todo)
        done += todo
        if done < min(next_check, args.steps):
            continue
        next_check += args.check_every
        d = sim.diagnostics()
        drift = (d["energy"] - e0) / abs(e0)
        history.append({
            "step": done,
            "energy": d["energy"],
            "rel_energy_drift": drift,
            "momentum_err": float(np.linalg.norm(np.asarray(d["momentum"]) - p0)),
            "angmom_err": float(np.linalg.norm(np.asarray(d["angular_momentum"]) - L0)),
            "overspeed": d["overspeed"],
        })
        print(f"validate: step {done}: drift={drift:+.3e} "
              f"overspeed={d['overspeed']}", file=sys.stderr)
    wall = time.perf_counter() - t0

    report = {
        "metric": "relative energy drift",
        "value": history[-1]["rel_energy_drift"],
        "unit": "dE/E0",
        "steps": args.steps,
        "n": sim.state.n_real,
        "solver": cfg.solver,
        "integrator": cfg.integrator,
        "dt": cfg.dt,
        "wall_seconds": wall,
        "pairs_per_sec": sim.state.n ** 2 * args.steps / wall,
        "max_abs_drift": max(abs(h["rel_energy_drift"]) for h in history),
        "momentum_err_final": history[-1]["momentum_err"],
        "backend": sim.device.type,
        **card(sim.device),
        "history": history,
    }
    print(json.dumps(report))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m n_body_problem_tpu_torch.validate")
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--check-every", type=int, default=1000)
    ap.add_argument("--chunk-steps", type=int, default=0,
                    help="steps per run() call (0 = check-every)")
    ap.add_argument("--solver", default="auto")
    ap.add_argument("--integrator", default="leapfrog")
    ap.add_argument("--dt", type=float, default=0.008)
    ap.add_argument("--dataset", type=int, default=-1,
                    help="load a dataset id instead of a Plummer sphere")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--convergence", action="store_true",
                    help="dt-scaling + f64-oracle study instead of a long run")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; give cpu to run on the CPU)")
    args = ap.parse_args(argv)

    if args.convergence:
        run_convergence(args)
    else:
        run_long(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
