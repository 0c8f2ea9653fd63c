"""Multi-device dry run: every sharded strategy held against one device.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``, with
the same seven legs, sizes, configs and tolerances, in one world of
``n_devices`` ranks (``parallel.spawn_ring``: NCCL on ``cuda``, one rank a
GPU; gloo on the CPU):

- the exact ring and the half ring, one leapfrog step of a Plummer sphere
  of 32 D bodies, against the single-device direct step (rtol 2e-5,
  atol 1e-5);
- the sharded treecode on the dense path (leapfrog), the flat path (Euler
  and leapfrog), the hierarchical path, and the staged treecode
  (hierarchical, VIP, a resort mid-run), each against ``Simulation`` of the
  same config through ``sort_perm`` (rtol 5e-4, atol 5e-5). The staged
  strategy compacts its near lists per source shard, so its reference
  unclamps the near lists (``tree_max_near`` = K_s).

Rank 0 runs the references on its device and prints a line a leg; a leg
that disagrees raises.

    python -m n_body_problem_tpu_torch.multichip --devices 8 --device cpu
    python -m n_body_problem_tpu_torch.multichip --devices 1            # one GPU
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

LEG_TOL = {"exact": dict(rtol=2e-5, atol=1e-5), "tree": dict(rtol=5e-4, atol=5e-5)}


def _check_equal(tag: str, got, want, tol: dict) -> float:
    """Positions equal within ``tol``, else raise; prints the leg's line."""
    np.testing.assert_allclose(got, want, **tol,
                               err_msg=f"{tag}: sharded positions diverge from single-chip")
    worst = float(np.abs(got - want).max())
    print(f"dryrun_multichip: {tag}: sharded == single-chip (max |d| {worst:.2e})",
          flush=True)
    return worst


def _tree_leg(mesh, tag: str, cfg, n: int, steps: int, strategy: str = "treecode",
              ref_cfg=None) -> float | None:
    """One treecode leg: ``ShardedSimulation`` of a Plummer sphere (seed 1)
    for ``steps``, against ``Simulation`` of ``ref_cfg`` (default ``cfg``)
    through both ``sort_perm``; None on ranks other than 0."""
    from n_body_problem_tpu_torch import Simulation, models
    from n_body_problem_tpu_torch.parallel import ShardedSimulation

    sim = ShardedSimulation(cfg, models.plummer(n, seed=1), mesh, strategy=strategy)
    sim.run(steps)
    whole = sim.gather_state()
    if mesh.rank:
        return None
    ref = Simulation(ref_cfg or cfg, models.plummer(n, seed=1), device=mesh.device)
    ref.run(steps)
    k = ref.state.n_real
    a, b = whole.pos[:k].cpu().numpy(), ref.state.pos[:k].cpu().numpy()
    inv_a = np.empty(k, int)
    inv_a[np.asarray(sim.sort_perm)] = np.arange(k)
    inv_b = np.empty(k, int)
    inv_b[np.asarray(ref.sort_perm)] = np.arange(k)
    return _check_equal(tag, a[inv_a], b[inv_b], LEG_TOL["tree"])


def dryrun_rank(mesh) -> dict:
    """The seven legs on one rank of the world (``spawn_ring``'s target):
    rank 0 returns ``{leg: max |d|}``."""
    from n_body_problem_tpu_torch import SimConfig, models
    from n_body_problem_tpu_torch.parallel import make_sharded_step, shard_state
    from n_body_problem_tpu_torch.simulation import make_step_fn
    from n_body_problem_tpu_torch.state import pad_state

    d, dev = mesh.size, mesh.device
    out = {}
    cfg = SimConfig(solver="direct", integrator="leapfrog")
    state = pad_state(models.plummer(32 * d, seed=0), multiple=d)
    ref = make_step_fn(cfg, dev.type)(state.to(dev)) if mesh.rank == 0 else None
    for strategy in ("ring", "half_ring"):
        step = make_sharded_step(cfg, mesh, strategy=strategy)
        pos = mesh.all_gather(step(shard_state(state, mesh)).pos)
        if ref is not None:
            out[strategy] = _check_equal(strategy, pos.cpu().numpy(), ref.pos.cpu().numpy(),
                                         LEG_TOL["exact"])

    n_t = max(2048, 256 * d)
    tcfg = SimConfig(solver="treecode", integrator="leapfrog", tree_vip_tiles=8,
                     tree_rebuild_every=2, tree_flat_cap=-1)
    out["dense treecode (leapfrog)"] = _tree_leg(mesh, "dense treecode (leapfrog)", tcfg,
                                                 n_t, 4)

    n_f = max(4096, 512 * d)
    for integrator, steps in (("semi_implicit_euler", 8), ("leapfrog", 4)):
        fcfg = SimConfig(solver="treecode", integrator=integrator, tree_vip_tiles=8,
                         tree_rebuild_every=4, tree_src_tile=64, tree_max_near=64,
                         tree_hier=False, tree_flat_cap=(n_f // 32) * 64)
        tag = f"flat treecode ({integrator})"
        out[tag] = _tree_leg(mesh, tag, fcfg, n_f, steps)

    n_h = max(8192, 1024 * d)
    hcfg = SimConfig(solver="treecode", integrator="semi_implicit_euler", tree_vip_tiles=8,
                     tree_rebuild_every=4, tree_src_tile=64, tree_max_near=64,
                     tree_hier=True, tree_tile=128, tree_flat_cap=(n_h // 128) * 64 * 8,
                     tree_far_cap=(n_h // 128) * 64 * 8)
    out["hier treecode"] = _tree_leg(mesh, "hier treecode", hcfg, n_h, 8)

    # Per-shard K_src >= CHUNK_LANES / src_tile.
    n_s = max(16384, 2048 * d)
    k_l = (n_s // d) // 128
    scfg = SimConfig(solver="treecode", integrator="semi_implicit_euler", tree_vip_tiles=8,
                     tree_rebuild_every=2, tree_tile=128, tree_src_tile=128,
                     tree_near_slack=0, tree_max_near=k_l, tree_flat_cap=k_l * k_l,
                     tree_hier=True, tree_far_max=64, tree_far_cap=k_l * 64)
    ref_cfg = scfg.replace(tree_max_near=n_s // 128, tree_flat_cap=(n_s // 128) ** 2,
                           tree_far_cap=(n_s // 128) * 64)
    tag = "staged treecode (ring-streamed panels)"
    out[tag] = _tree_leg(mesh, tag, scfg, n_s, 4, strategy="treecode_staged",
                         ref_cfg=ref_cfg)
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Run the seven legs over a ring of ``n_devices`` ranks on ``device``
    (``"cuda"``: NCCL, at most the GPUs there are; ``"cpu"``: gloo) and
    return ``{leg: max |d|}``; a leg that disagrees with the single device
    raises (``RuntimeError`` with the rank's traceback)."""
    from n_body_problem_tpu_torch.parallel import spawn_ring

    return spawn_ring(dryrun_rank, n_devices, device_type=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks (default: the GPUs on cuda, 8 on the CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (NCCL, default) or cpu (gloo)")
    args = ap.parse_args(argv)
    import torch

    n = args.devices
    if n is None:
        n = torch.cuda.device_count() if args.device == "cuda" else 8
    try:
        legs = dryrun_multichip(n, device=args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"devices": n, "device": args.device, "legs": legs,
                      "worst_max_abs": max(legs.values())}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
