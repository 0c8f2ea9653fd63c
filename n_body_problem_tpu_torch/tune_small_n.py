"""Small-N treecode tuning sweep, 4090-baseline crossover scan and A/B legs.

Counterpart of the JAX package's ``tools/tune_small_n.py``, with its legs,
flags, record keys and defaults, and of its five one-off A/B runners
(``tools/ab_src.py``, ``ab_union.py``, ``ab_20k_r4.py``, ``ab_20k_r4b.py``,
``ab_bracket_r4.py``) as further modes, each with its legs, sizes and
timing protocol. The only benchmark the reference published is 1.6
ms/step at N=20,225 on an RTX 4090 (2.6e11 directed pairs/s,
``bench.BASELINE``); the treecode's effective throughput grows with N, so
there is a crossover N* above which the card beats it.

  --mode sweep      the config sweep at N=20,480 (``--sweep-n``): rebuild
                    cadence, VIP budget, source tile, MAC tau, hier on/off
                    (``SWEEP``), 256 steps a leg
  --mode crossover  the default config at ``CROSSOVER_NS`` (or ``--n``):
                    brackets N* by log-linear interpolation (``crossover_n``)
  --mode ab-src     ``tree_src_tile`` 64 then 32 at ``--n`` (262,144), 32 steps
  --mode ab-union   ``tree_hier_union`` True then False, the same protocol
  --mode r4         five knobs over ``tuned_tree_overrides(20480)``, 512
                    steps x 2 chunks, one window
  --mode r4b        the tuned 20,480 config, 1,024 steps, one window
  --mode bracket    24,576 and 32,768 tuned, 1,024 steps, one window

Each leg is ``bench.bench_config(n, "treecode", ...)`` with its overrides
(timing, then the force-error probe on fresh lists), printed as one JSON
line: the bench record plus ``leg``, the keys the JAX runner adds
(``overrides``, ``src_tile``, ``union``) and ``vs_baseline``. A summary
line follows, with the card's name and power limit. ``--out`` appends
every line to a file, never to the JAX package's records
(``validation/tune_small_n_*.jsonl``). A failed leg prints its error on
stderr, the other legs still run, and the process exits 1.

    python -m n_body_problem_tpu_torch.tune_small_n --mode sweep \\
        --out validation/torch_tune_small_n_h100.jsonl
    python -m n_body_problem_tpu_torch.tune_small_n --mode crossover --n 65536 --steps 64
    python -m n_body_problem_tpu_torch.tune_small_n --device cpu --sweep-n 2048 \\
        --legs default --steps 2
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import math
import pathlib
import sys
from typing import NamedTuple

from n_body_problem_tpu_torch import bench
from n_body_problem_tpu_torch.config import tuned_tree_overrides

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_RECORDS = "tune_small_n_*.jsonl"   # under validation/: the JAX package's

SWEEP_N = 20480
SWEEP = [
    ("default", {}),
    ("rebuild16", {"tree_rebuild_every": 16}),
    ("rebuild32", {"tree_rebuild_every": 32}),
    ("vip16", {"tree_vip_tiles": 16}),
    ("vip0", {"tree_vip_tiles": 0}),
    ("src32", {"tree_src_tile": 32}),
    ("tau3e-4", {"tree_mac_tau": 3e-4}),
    ("tau5e-4", {"tree_mac_tau": 5e-4}),
    ("slack4", {"tree_near_slack": 4}),
    ("flat", {"tree_hier": False}),
    ("rebuild16_vip16", {"tree_rebuild_every": 16, "tree_vip_tiles": 16}),
    ("src32_tau5e-4", {"tree_src_tile": 32, "tree_mac_tau": 5e-4}),
    ("src32_tau5e-4_rebuild16", {"tree_src_tile": 32, "tree_mac_tau": 5e-4,
                                 "tree_rebuild_every": 16}),
    ("src32_tau1e-3", {"tree_src_tile": 32, "tree_mac_tau": 1e-3}),
    ("src32_tau5e-4_vip16", {"tree_src_tile": 32, "tree_mac_tau": 5e-4,
                             "tree_vip_tiles": 16}),
    ("src32_tau5e-4_rebuild32", {"tree_src_tile": 32, "tree_mac_tau": 5e-4,
                                 "tree_rebuild_every": 32}),
    ("src32_rebuild32", {"tree_src_tile": 32, "tree_rebuild_every": 32}),
    ("best_tile64", {"tree_src_tile": 32, "tree_mac_tau": 5e-4,
                     "tree_rebuild_every": 32, "tree_tile": 64}),
    ("best_tile32", {"tree_src_tile": 32, "tree_mac_tau": 5e-4,
                     "tree_rebuild_every": 32, "tree_tile": 32}),
    ("best_slack4", {"tree_src_tile": 32, "tree_mac_tau": 5e-4,
                     "tree_rebuild_every": 32, "tree_near_slack": 4}),
]
CROSSOVER_NS = [20480, 32768, 49152, 65536]

# The A/B runners' legs, as their scripts list them.
AB_N = 262144
SRC_TILES = (64, 32)                    # ab_src.py
HIER_UNIONS = (True, False)             # ab_union.py
_TUNED_20K = tuned_tree_overrides(20480)
R4_LEGS = [                             # ab_20k_r4.py
    ("vip0", dict(_TUNED_20K, tree_vip_tiles=0)),
    ("vip0_rebuild64", dict(_TUNED_20K, tree_vip_tiles=0, tree_rebuild_every=64)),
    ("rebuild64", dict(_TUNED_20K, tree_rebuild_every=64)),
    ("tile64_vip0", dict(_TUNED_20K, tree_tile=64, tree_vip_tiles=0)),
    ("vip8", dict(_TUNED_20K, tree_vip_tiles=8)),
]
R4B_LEGS = [("rowmerge_vip16_fixedprobe", dict(_TUNED_20K))]      # ab_20k_r4b.py
BRACKET_LEGS = [                        # ab_bracket_r4.py
    ("24k_tuned_fixedprobe", 24576, tuned_tree_overrides(24576)),
    ("32k_tuned_fixedprobe", 32768, tuned_tree_overrides(32768)),
]
# Steps a leg (``run(steps)`` a chunk) when ``--steps`` is not given.
MODE_STEPS = {"sweep": 256, "crossover": 256, "ab-src": 32, "ab-union": 32,
              "r4": 512, "r4b": 1024, "bracket": 1024}


class Leg(NamedTuple):
    name: str
    n: int
    overrides: dict
    protocol: dict       # bench_config's chunks / windows, where not its defaults
    extra: dict          # record keys the JAX runner adds after ``leg``


def legs_of(mode: str, *, n: int = 0, sweep_n: int = SWEEP_N) -> list[Leg]:
    """The legs of ``mode``, in the order the JAX tool runs them."""
    if mode == "sweep":
        return [Leg(name, sweep_n, kw, {}, {}) for name, kw in SWEEP]
    if mode == "crossover":
        return [Leg(f"n{m}", m, {}, {}, {}) for m in ([n] if n else CROSSOVER_NS)]
    if mode == "ab-src":
        return [Leg(f"src{s}", n or AB_N, {"tree_src_tile": s}, {}, {"src_tile": s})
                for s in SRC_TILES]
    if mode == "ab-union":
        return [Leg(f"union_{u}", n or AB_N, {"tree_hier_union": u}, {}, {"union": u})
                for u in HIER_UNIONS]
    if mode == "r4":
        return [Leg(tag, 20480, over, {"chunks": 2, "windows": 1}, {"overrides": over})
                for tag, over in R4_LEGS]
    if mode == "r4b":
        return [Leg(tag, 20480, over, {"windows": 1}, {"overrides": over})
                for tag, over in R4B_LEGS]
    if mode == "bracket":
        return [Leg(tag, m, over, {"windows": 1}, {"overrides": over})
                for tag, m, over in BRACKET_LEGS]
    raise ValueError(f"unknown mode {mode!r}")


def leg(spec: Leg, steps: int, device="cuda") -> dict:
    """One leg: the bench record plus ``leg``, the runner's keys and
    ``vs_baseline``."""
    r = bench.bench_config(spec.n, "treecode", steps=steps, device=device,
                           **spec.protocol, **spec.overrides)
    r["leg"] = spec.name
    r.update(spec.extra)
    r["vs_baseline"] = r["pairs_per_sec"] / bench.BASELINE
    return r


def crossover_n(records: list[dict]) -> float | None:
    """N* where ``vs_baseline`` crosses 1: log-linear interpolation over N
    between the first bracketing pair of consecutive records, else None."""
    for a, b in zip(records, records[1:]):
        va, vb = a["vs_baseline"], b["vs_baseline"]
        if va < 1.0 <= vb:
            la, lb = math.log(a["n"]), math.log(b["n"])
            return math.exp(la + (lb - la) * (1.0 - va) / (vb - va))
    return None


def is_jax_record(path: pathlib.Path) -> bool:
    path = path.resolve()
    return (path.parent == (ROOT / "validation").resolve()
            and fnmatch.fnmatch(path.name, JAX_RECORDS))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m n_body_problem_tpu_torch.tune_small_n",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=list(MODE_STEPS), default="sweep")
    ap.add_argument("--steps", type=int, default=0,
                    help="steps a run() call (0: the mode's own, "
                         + ", ".join(f"{m} {s}" for m, s in MODE_STEPS.items()) + ")")
    ap.add_argument("--legs", type=str, default="",
                    help="comma-separated leg names to run (default: all of the mode's)")
    ap.add_argument("--n", type=int, default=0,
                    help="crossover: this single N only; ab-src/ab-union: the N "
                         f"(default {AB_N:,})")
    ap.add_argument("--sweep-n", type=int, default=SWEEP_N,
                    help="sweep mode: body count")
    ap.add_argument("--out", default="",
                    help="append every JSON line to this file")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; give cpu to run on the CPU)")
    args = ap.parse_args(argv)

    out = pathlib.Path(args.out) if args.out else None
    if out is not None and is_jax_record(out):
        print(f"error: {out} is a JAX package record ({JAX_RECORDS}); write another file",
              file=sys.stderr)
        return 2
    from n_body_problem_tpu_torch.simulation import resolve_device

    dev = resolve_device(args.device)
    steps = args.steps or MODE_STEPS[args.mode]
    specs = legs_of(args.mode, n=args.n, sweep_n=args.sweep_n)
    if args.legs:
        wanted = args.legs.split(",")
        unknown = sorted(set(wanted) - {s.name for s in specs})
        if unknown:
            ap.error(f"--mode {args.mode} has no legs {unknown}")
        specs = [s for s in specs if s.name in wanted]

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if out is not None:
            out.parent.mkdir(parents=True, exist_ok=True)
            with out.open("a") as f:
                f.write(line + "\n")

    done, failed = [], []
    for spec in specs:
        try:
            r = leg(spec, steps, dev)
        except Exception as e:  # the other legs still run; the exit code says so
            print(f"tune: leg {spec.name} failed: {e!r}", file=sys.stderr)
            failed.append(spec.name)
            continue
        emit(r)
        done.append(r)

    if args.mode == "crossover":
        emit({"summary": "crossover",
              "vs_baseline_by_n": {str(r["n"]): r["vs_baseline"] for r in done},
              "crossover_n_estimate": crossover_n(done), **bench.card(dev)})
    elif done:
        best = min(done, key=lambda r: r["ms_per_step"])
        emit({"summary": args.mode, "n": best["n"], "best_leg": best["leg"],
              "best_ms_per_step": best["ms_per_step"],
              "best_vs_baseline": best["vs_baseline"],
              "best_force_err_p99": best.get("force_err_p99"), **bench.card(dev)})
    if failed:
        print(f"tune: {len(failed)} failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
