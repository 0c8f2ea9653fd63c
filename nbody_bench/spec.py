"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one loop, one
cell's limits or one metric sits in a file of its own under ``nbody_bench/``,
found by the name that ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the deployment (body count, generator,
  physics, the bodies the comparison samples); the workload entry's
  ``config``. Its ``physics.integrator`` is ``semi_implicit_euler`` or
  ``leapfrog`` (KDK, stored-acceleration form), the two the program runs
  and the reference follows (``reference.gravity.INTEGRATORS``); any other
  name is refused here. A leapfrog cell's limits also name ``dv_p90`` and
  ``dv_lag``, which the comparison reads under the leapfrog alone. Its ``n`` is
  any count: the comparison takes the program's real bodies, not its
  padding;
- ``inputs/<generator>.py``: ``generate(n, seed, **generator_params)``,
  the bodies' ``(pos, vel, mass)`` as float32 arrays from the seed;
- ``traffic/<traffic>.json``: the solver and its settings, the loop by name,
  the steps a call, the frame, the calls judged and traced a window, and
  optionally ``judged_within_steps``, the window's first steps that the
  judged calls are drawn from;
- ``loops/<loop>.py``: ``Loop(system, traffic)`` with ``warm()`` and
  ``call()``, each returning a ``Call``;
- ``limits/<workload>.json``: the limit of each number the comparison
  reads in that cell;
- ``e2e/<metric>.py`` and ``metrics/<metric>.py``: ``read(...)``, an
  end-to-end metric of the run and a per-layer metric of its trace, with
  the dots of a metric's name as underscores in the file's name. A
  per-layer reader returns its number, None where it finds nothing to read,
  or a function of no arguments that the harness calls once the program is
  freed (for work that needs the card's memory).

A metric named ``<base>.<twin>`` with no file of its own is read by
``<base>``'s reader. Such twins exist for one reason: an end-to-end metric
whose cells need different bounds is split by cell (``ms_per_step`` in the
cells the card paces, bound 0.02; ``ms_per_step.host_paced`` in those the
host paces, 0.25), and a per-layer metric can move only one end-to-end
metric, so each per-layer quantity of those cells takes the same suffix
(``k2_roofline`` and ``k2_roofline.host_paced``). A new cell reports the
twin of its pace; a third twin of a quantity needs a third bound, not a
third pace.

A cell, a mix, a loop or a metric is added by adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

from nbody_bench.reference.gravity import INTEGRATORS

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = "nbody_bench"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]
    loop: object


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def module_name(metric: str) -> str:
    return metric.replace(".", "_").replace("-", "_")


def _module(path: pathlib.Path):
    """The module of the file ``path``, loaded under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reader(folder: pathlib.Path, metric: str):
    """The reader of ``metric`` in ``folder``: its own file, or its base's."""
    path = folder / f"{module_name(metric)}.py"
    if not path.exists() and "." in metric:
        return _reader(folder, metric.rsplit(".", 1)[0])
    return _module(path)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files read
    and its loop and metric readers loaded from ``root/nbody_bench``."""
    bench = _load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in {root / 'BENCHMARK.json'}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _load_json(root / conf["file"])
    if config["physics"]["integrator"] not in INTEGRATORS:
        raise ValueError(f"{conf['file']}: integrator {config['physics']['integrator']!r} "
                         f"is none of {sorted(INTEGRATORS)}")
    base = root / PACKAGE
    traffic = _load_json(base / "traffic" / f"{entry['traffic']}.json")
    return Cell(
        name=workload,
        config=config,
        traffic=traffic,
        limits=_load_json(base / "limits" / f"{workload}.json"),
        chips=entry["chips"],
        end_to_end=[dict(m, reader=_reader(base / "e2e", m["name"]))
                    for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[dict(m, reader=_reader(base / "metrics", m["name"]))
                   for m in bench["per_layer"] if _applies(m, workload)],
        loop=_module(base / "loops" / f"{traffic['loop']}.py"),
    )
