"""The control's readings: the plain reference in bfloat16 put in the
program's place (``reference.control.Control``), driven and judged as a run
of the cell is, on the card at the cell's own size.

    python3 -m nbody_bench.control --workload <name> --seeds 1,2,3 [--seconds 15]
        [--steps-per-call k]

Prints one JSON line a seed: ``correct`` (false for a sound comparison) and
each number compared beside its limit. There is no warm call. A 50-step
call costs 50 full reference steps (0.14 s each at 65,536 bodies on an
H100, 35 s at 1,048,576), so ``--steps-per-call`` can shorten the calls
where the cell's own length would not fit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import tempfile

from nbody_bench import harness, spec
from nbody_bench.reference.control import Control


def readings(workload: str, seed: int, seconds: float, steps_per_call: int | None = None,
             root: pathlib.Path = spec.ROOT, device: str = "cuda") -> dict:
    """The control's result object of one run (no warm call)."""
    if steps_per_call is not None:
        tmp = pathlib.Path(tempfile.mkdtemp())
        try:
            shutil.copy(root / "BENCHMARK.json", tmp)
            shutil.copytree(root / spec.PACKAGE, tmp / spec.PACKAGE,
                            ignore=shutil.ignore_patterns("__pycache__"))
            cell = spec.load(workload, root)
            name = json.loads((root / "BENCHMARK.json").read_text())
            traffic = next(w["traffic"] for w in name["workloads"] if w["name"] == workload)
            t = dict(cell.traffic, steps_per_call=steps_per_call)
            (tmp / spec.PACKAGE / "traffic" / f"{traffic}.json").write_text(json.dumps(t))
            return harness.run_cell(workload, seed, seconds, False, root=tmp, device=device,
                                    system_cls=Control, warm=False)
        finally:
            shutil.rmtree(tmp)
    return harness.run_cell(workload, seed, seconds, False, root=root, device=device,
                            system_cls=Control, warm=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m nbody_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--steps-per-call", type=int, default=None)
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        out = readings(args.workload, int(s), args.seconds, args.steps_per_call)
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "steps_per_call": args.steps_per_call, "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
