"""Acceptance census of the hierarchical treecode.

Counterpart of the JAX package's ``tools/hier_census.py``, with its argv
form and record keys. Counts the UNCAPPED near and far evaluations per
target row of the production acceptance chain (``_hier_lists`` of
``ops/treecode.py``) on a Morton-sorted Plummer sphere
(seed 0, 128-body target rows): the cost model behind capacity planning.
One JSON line per (N, ``union_coarse``): near and far means and maxima a
row, the near pairs a row, the single-level far mean it replaces
(``flat_far_mean``), and with ``union_coarse`` the far evaluations by level
(``far_mean_by_level``, keyed by the level's node count).

    python -m n_body_problem_tpu_torch.hier_census [--src TILE] [--tau0 T]
        [--hier-tau T] [--device cpu] [N ...]     (default N: 65536 262144)

Runs on ``--device cuda`` unless ``--device cpu`` is given. The counts are
integers; a float32 score exactly at its threshold may fall the other way
on another device.
"""

from __future__ import annotations

import argparse
import json


def row_counts(n: int, src_tile: int = 0, tau0: float = 0.0, hier_tau: float = 0.0,
               device="cuda") -> tuple[dict, dict]:
    """The census's per-row counts on a Plummer sphere of ``n`` bodies:
    ``({"n", "src", "k_src", "plan"}, {union_coarse: (near (K_t,), far
    evaluations a level [(K_t,), ...], finest first)})``, numpy integers;
    0 keeps a setting's default."""
    from n_body_problem_tpu_torch import SimConfig, Simulation, models
    from n_body_problem_tpu_torch.ops import treecode as tc

    tile = 128
    kw = {"tree_src_tile": src_tile} if src_tile else {}
    if tau0:
        kw["tree_mac_tau"] = tau0
    if hier_tau:
        kw["tree_hier_tau"] = hier_tau
    sim = Simulation(SimConfig(solver="treecode", tree_tile=tile, **kw),
                     models.plummer(n, seed=0), device=device)
    st, cfg = sim.state, sim.cfg
    src = cfg.tree_src_tile
    k_s = st.n // src
    xc, yc, zc = (st.pos[:, i].contiguous() for i in range(3))
    vipn = tc._clamp_vip(tc._vip_src_tiles(cfg.tree_vip_tiles, tile, src), k_s)
    plan = tc._level_plan(k_s)

    rows = {}
    for union in (False, True):
        _, _, opens, _, _, _, evals, reach0 = tc._hier_lists(
            xc, yc, zc, xc, yc, zc, st.mass, tile=tile, src_tile=src, theta=cfg.tree_theta,
            vip_src=vipn, plan=plan, branch=tc.HIER_BRANCH, mac_tau=cfg.tree_hier_tau,
            mac_tau0=cfg.tree_mac_tau, eps2=cfg.eps2, c2=cfg.compensate ** 2,
            union_coarse=union)
        far = [(reach0 & ~opens[0]).sum(1)] + [e.sum(1) for e in evals[1:]]
        rows[union] = ((reach0 & opens[0]).sum(1).cpu().numpy(),
                       [f.cpu().numpy() for f in far])
    return dict(n=st.n, src=src, k_src=k_s, plan=plan), rows


def records(info: dict, rows: dict) -> list[dict]:
    """The census records of :func:`row_counts`' output, as the JAX tool
    prints them."""
    out = []
    for union, (near, per) in rows.items():
        far = sum(per)
        rec = dict(n=info["n"], src=info["src"], k_src=info["k_src"], union_coarse=union,
                   near_mean=round(float(near.mean()), 1),
                   near_max=int(near.max()),
                   near_pairs_mean=round(float(near.mean()) * info["src"], 1),
                   far_mean=round(float(far.mean()), 1),
                   far_max=int(far.max()),
                   flat_far_mean=round(float(info["k_src"] - near.mean()), 1))
        if union:
            rec["far_mean_by_level"] = {f"K{k}": round(float(p.mean()), 1)
                                        for k, p in zip(info["plan"], per)}
        out.append(rec)
    return out


def census(n: int, src_tile: int = 0, tau0: float = 0.0, hier_tau: float = 0.0,
           device="cuda") -> list[dict]:
    """The census records of a Plummer sphere of ``n`` bodies, printed one
    JSON line each and returned."""
    recs = records(*row_counts(n, src_tile, tau0, hier_tau, device=device))
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m n_body_problem_tpu_torch.hier_census",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=int, default=0, help="source tile (0: the default)")
    ap.add_argument("--tau0", type=float, default=0.0, help="level-0 tree_mac_tau")
    ap.add_argument("--hier-tau", type=float, default=0.0, help="tree_hier_tau")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; give cpu to run on the CPU)")
    ap.add_argument("ns", type=int, nargs="*", default=[65536, 262144])
    args = ap.parse_args(argv)
    for n in args.ns:
        census(n, args.src, args.tau0, args.hier_tau, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
