"""Multi-step sharded == single-device equality at real scale.

Counterpart of the JAX package's ``tools/sharded_equality.py``, with its
flags and record keys. Runs both sharded treecode paths for two or more
rebuild cadences over a world of ``--devices`` ranks (gloo with ``--device
cpu``, NCCL on ``cuda``) at N = 65,536 / D = 8 by default, against the
single-device ``Simulation`` of the same config, and records the agreement
in ``--out``:

- ``flat``: each rank's compacted near lists, replicated sources, the
  global resort, the summed VIP reactions;
- ``hier``: the multi-level far field on top, its lists from the
  whole population's level summaries and median scale.

Capacities are K_t x max_near on both sides, so neither sheds and the
ranks' lists cover the single device's open sets row for row. The record
is this package's own (``validation/torch_sharded_equality_65k.json`` by
default), never the JAX package's; a rerun of one path keeps the other's
record, and each path's record is written as soon as it is done.

    python -m n_body_problem_tpu_torch.sharded_equality --device cpu
        [--n 65536] [--devices 8] [--steps 8] [--rebuild-every 4]
        [--paths flat,hier] [--out validation/torch_sharded_equality_65k.json]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_RECORD = ROOT / "validation" / "sharded_equality_65k.json"


def configs(n: int, rebuild_every: int) -> dict:
    """The two paths' configs, as the JAX tool's."""
    from n_body_problem_tpu_torch import SimConfig
    from n_body_problem_tpu_torch.ops.treecode import FAR_ENTRIES

    return {
        "flat": SimConfig(solver="treecode", tree_vip_tiles=64,
                          tree_rebuild_every=rebuild_every, tree_src_tile=64,
                          tree_max_near=128, tree_flat_cap=(n // 32) * 128,
                          tree_hier=False, donate=False),
        "hier": SimConfig(solver="treecode", tree_vip_tiles=64,
                          tree_rebuild_every=rebuild_every, tree_src_tile=64,
                          tree_max_near=128, tree_tile=128, tree_hier=True,
                          tree_flat_cap=(n // 128) * 64 * 16,
                          tree_far_cap=(n // 128) * FAR_ENTRIES * 16, donate=False),
    }


def sharded_rank(mesh, cfg, n: int, steps: int, path: str) -> dict:
    """The sharded run on one rank (``spawn_ring``'s target): rank 0's
    gathered positions, ``sort_perm``, diagnostics and wall seconds
    (construction and run)."""
    from n_body_problem_tpu_torch import models
    from n_body_problem_tpu_torch.parallel import ShardedSimulation

    t0 = time.perf_counter()
    sim = ShardedSimulation(cfg, models.plummer(n, seed=43), mesh, strategy="treecode")
    if path == "hier" and sim.cfg.tree_far_max <= 0:
        raise RuntimeError("hier path not engaged")
    sim.run(steps)
    wall = time.perf_counter() - t0
    pos = sim.gather_state().pos[:n].cpu().numpy()
    d = sim.diagnostics()
    return dict(pos=pos, sort_perm=np.asarray(sim.sort_perm), wall=wall,
                overspeed=int(d["overspeed"]), energy=float(d["energy"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rebuild-every", type=int, default=4)
    ap.add_argument("--paths", default="flat,hier", help="comma list: flat, hier")
    ap.add_argument("--out", default="validation/torch_sharded_equality_65k.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (NCCL, default) or cpu (gloo)")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    if out.resolve() == JAX_RECORD.resolve():
        print(f"error: {JAX_RECORD.name} is the JAX package's record; write another file",
              file=sys.stderr)
        return 2

    from n_body_problem_tpu_torch import Simulation, models
    from n_body_problem_tpu_torch.parallel import spawn_ring

    n, dev = args.n, args.device
    cfgs = configs(n, args.rebuild_every)
    mesh_key = "cpu_mesh" if dev == "cpu" else dev
    records: dict[str, dict] = json.loads(out.read_text()) if out.exists() else {}
    for path in args.paths.split(","):
        cfg = cfgs[path]
        got = spawn_ring(sharded_rank, args.devices, device_type=dev,
                         args=(cfg, n, args.steps, path))
        t0 = time.perf_counter()
        ref = Simulation(cfg, models.plummer(n, seed=43), device=dev)
        ref.run(args.steps)
        t_single = time.perf_counter() - t0

        a, b = got["pos"], ref.state.pos[:n].cpu().numpy()
        inv_a = np.empty(n, int)
        inv_a[got["sort_perm"]] = np.arange(n)
        inv_b = np.empty(n, int)
        inv_b[np.asarray(ref.sort_perm)] = np.arange(n)
        delta = np.abs(a[inv_a] - b[inv_b])
        scale = np.abs(b[inv_b]).max()
        rec = {
            "n": n,
            "devices": args.devices,
            "steps": args.steps,
            "rebuild_every": args.rebuild_every,
            "resorts_fired": args.steps // args.rebuild_every,
            "max_abs_delta": float(delta.max()),
            "max_rel_delta": float(delta.max() / scale),
            "sharded_overspeed": got["overspeed"],
            "sharded_energy_finite": bool(np.isfinite(got["energy"])),
            f"wall_s_sharded_{mesh_key}": round(got["wall"], 1),
            f"wall_s_single_chip_{dev}": round(t_single, 1),
            "passes": bool(delta.max() / scale < 5e-4),
            "device": dev,
        }
        records[path] = rec
        print(json.dumps({path: rec}), flush=True)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(records, indent=2) + "\n")
    failed = [path for path, rec in records.items() if not rec["passes"]]
    if failed:
        print(f"error: {', '.join(failed)}: sharded != single device beyond tolerance",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
