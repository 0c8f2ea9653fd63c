"""Every reference dataset for a few hundred steps: step rate and sanity.

Counterpart of the JAX package's ``validation/dataset_sweep.py``, with its
flags and per-dataset keys. Each id of ``io.datasets.DATASETS`` is loaded
(its file from ``--data-dir``, else its procedural fallback; an id with
neither is recorded as ``missing: ...``, never synthesized), run on
``solver="auto"`` for ``--steps`` steps to warm up and ``--steps`` more
timed (ending in a device sync), and checked for finite positions. The
report names the backend, the card and its power limit, and is written to
``--out`` (this package's own record, never the JAX package's):

    python -m n_body_problem_tpu_torch.dataset_sweep [--data-dir DIR] [--steps 200]
        [--out validation/torch_dataset_sweep.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_RECORD = ROOT / "validation" / "dataset_sweep.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m n_body_problem_tpu_torch.dataset_sweep",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--out", default="validation/torch_dataset_sweep.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; give cpu to run on the CPU)")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    if out.resolve() == JAX_RECORD.resolve():
        print(f"error: {JAX_RECORD.name} is the JAX package's record; write another file",
              file=sys.stderr)
        return 2

    from n_body_problem_tpu_torch import SimConfig, Simulation
    from n_body_problem_tpu_torch.bench import _sync, card
    from n_body_problem_tpu_torch.io import datasets
    from n_body_problem_tpu_torch.simulation import resolve_device

    dev = resolve_device(args.device)
    results = []
    for ds_id, spec in sorted(datasets.DATASETS.items()):
        try:
            state, _ = datasets.load_dataset(ds_id, directory=args.data_dir)
        except FileNotFoundError as e:
            results.append({"dataset": ds_id, "name": spec.name, "status": f"missing: {e}"})
            continue
        sim = Simulation(SimConfig(solver="auto"), state, device=dev)
        sim.run(args.steps)   # warm
        _sync(dev)
        t0 = time.perf_counter()
        sim.run(args.steps)
        _sync(dev)
        dt = time.perf_counter() - t0
        pos = sim.state.pos.cpu().numpy()
        rec = {
            "dataset": ds_id,
            "name": spec.name,
            "status": "ok",
            "n_real": sim.state.n_real,
            "n_padded": sim.state.n,
            "steps": 2 * args.steps,
            "ms_per_step": dt / args.steps * 1e3,
            "pairs_per_sec": sim.state.n ** 2 * args.steps / dt,
            "finite": bool(np.isfinite(pos).all()),
            "fallback_model": not bool(spec.filename) or None,
        }
        results.append(rec)
        print(f"dataset {ds_id} ({spec.name}): n={rec['n_real']} solver={sim.solver} "
              f"{rec['ms_per_step']:.2f} ms/step finite={rec['finite']}", file=sys.stderr)
    report = {"backend": dev.type, **card(dev), "results": results}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps({"datasets_ok": sum(r.get("status") == "ok" for r in results)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
