"""Cells of kinds that the accepted benchmark does not have, added to a copy
of it by files and ``BENCHMARK.json`` entries alone, as a new deployment is
added: body counts that the program pads to its solver's multiple, two
particle masses (``three_component.py``, written into the copy's
``inputs/``) and the KDK leapfrog. Each cell is held to an accepted cell's
limits, copied into a file of its own, and a leapfrog cell also to
``LEAPFROG_LIMITS`` on the velocity (the judge reads ``dv_p90`` and
``dv_lag`` under the leapfrog alone)."""

from __future__ import annotations

import json
import pathlib
import shutil

from nbody_bench import spec

GENERATOR = pathlib.Path(__file__).with_name("three_component.py")

# name: its body count, solver, loop, generator, integrator, and the
# accepted cell whose limits it is held to.
CELLS = {
    "padded.exact": (1000, "auto", "batch", "plummer", "semi_implicit_euler",
                     "plummer_65k.exact"),
    "padded.tree": (2000, "treecode", "batch", "plummer", "semi_implicit_euler",
                    "plummer_65k.tree"),
    "two_mass.exact": (1024, "auto", "batch", "three_component", "semi_implicit_euler",
                       "plummer_65k.exact"),
    "leapfrog.exact": (1024, "auto", "batch", "plummer", "leapfrog", "plummer_65k.exact"),
    "galaxy.exact": (1000, "auto", "batch", "three_component", "leapfrog",
                     "plummer_65k.exact"),
    "galaxy.tree": (2000, "treecode", "batch", "three_component", "leapfrog",
                    "plummer_65k.tree"),
    "galaxy.live": (1000, "auto", "live", "three_component", "leapfrog",
                    "plummer_65k.live"),
}


# Set from sound runs on the CPU at the tests' sizes (2, 10-step calls; 1,000
# to 2,048 bodies): dv_p90 at most 0.14, dv_lag at most 6.5e-6; a closing
# half-kick left out reads dv_lag 0.5. dv_p90 is for gross faults (a
# velocity of another body), not for that one.
LEAPFROG_LIMITS = {"dv_p90": 0.5, "dv_lag": 0.05}


def copy(dst: pathlib.Path) -> None:
    """The benchmark, without its tests, copied to ``dst``."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", dst)
    shutil.copytree(spec.ROOT / spec.PACKAGE, dst / spec.PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))


def add(root: pathlib.Path, name: str, steps_per_call: int, n: int | None = None) -> None:
    """Cell ``name`` of ``CELLS`` (at ``n`` bodies, where given) added to the
    copy at ``root``: its configuration, traffic and limits files, and its
    entries in ``BENCHMARK.json``, where it reports ``ms_per_step``."""
    count, solver, loop, generator, integrator, limits_of = CELLS[name]
    n = count if n is None else n
    base = root / spec.PACKAGE
    stem = spec.module_name(name)
    if generator == "three_component":
        shutil.copy(GENERATOR, base / "inputs" / GENERATOR.name)
    config = json.loads((spec.ROOT / spec.PACKAGE / "configs/plummer_65k.json").read_text())
    config.update(n=n, probe_bodies=n, generator=generator,
                  generator_params={} if generator != "plummer" else config["generator_params"],
                  physics=dict(config["physics"], integrator=integrator))
    (base / "configs" / f"{stem}.json").write_text(json.dumps(config))
    traffic = {"solver": solver, "settings": {}, "loop": loop,
               "steps_per_call": 1 if loop == "live" else steps_per_call,
               "judged_calls": 2, "traced_calls": 100}
    if loop == "live":
        traffic["frame"] = json.loads((spec.ROOT / spec.PACKAGE / "traffic/live.json")
                                      .read_text())["frame"]
    (base / "traffic" / f"{stem}.json").write_text(json.dumps(traffic))
    limits = json.loads((spec.ROOT / spec.PACKAGE / "limits" / f"{limits_of}.json").read_text())
    if integrator == "leapfrog":
        limits.update(LEAPFROG_LIMITS)
    (base / "limits" / f"{name}.json").write_text(json.dumps(limits))

    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": stem, "source": "a test", "reduced": [],
                             "file": f"{spec.PACKAGE}/configs/{stem}.json", "why": "a test"})
    bench["workloads"].append({"name": name, "config": stem, "traffic": stem, "chips": 1,
                               "why": "a test"})
    next(m for m in bench["end_to_end"] if m["name"] == "ms_per_step")["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
