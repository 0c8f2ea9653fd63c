"""Dataset registry: id -> file, reader, render scales, camera distance.

Counterpart of ``n_body_problem_tpu.io.datasets``, field for field. Mirrors
the reference's ``load_data`` switch (``kernel.cu:975-1013``), including
each dataset's per-axis render scale factors and camera distance. When the
files of dataset 1 (dubinski.tab) or 2 (tab65536.tab) are absent the
registry synthesizes an equivalent workload from
:mod:`n_body_problem_tpu_torch.models`, so every id with a fallback stays
loadable.

Quirk Q1: the reference routes the ``.snap`` datasets 4/5 through its *dat*
reader (``kernel.cu:1002, 1008``) — header lines become 3 bogus unit-mass
bodies and columns are misread. ``quirk_compat=True`` reproduces that for
parity runs; the default parses snap files correctly.

The state returned is on the CPU; ``Simulation`` moves it to its device.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import Callable

from n_body_problem_tpu_torch.io import text, tipsy
from n_body_problem_tpu_torch.state import SimState, pad_state

DEFAULT_DATASET = 1  # kernel.cu:67


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    filename: str | None
    reader: str                      # "tipsy" | "tab" | "dat" | "snap"
    scale_factors: tuple[float, float, float]
    camera_distance: float = 1.0
    description: str = ""
    fallback_model: str | None = None
    fallback_n: int = 0


DATASETS: dict[int, DatasetSpec] = {
    0: DatasetSpec(
        "galaxy_20k", "galaxy_20K.bin", "tipsy", (200, 120, 200),
        description="single rotating galaxy, 20,000 bodies (tipsy binary)",
    ),
    1: DatasetSpec(
        "dubinski", "dubinski.tab", "tab", (100, 100, 100),
        description="two colliding galaxies (default dataset)",
        fallback_model="galaxy_collision", fallback_n=81920,
    ),
    2: DatasetSpec(
        "tab65536", "tab65536.tab", "tab", (50, 50, 50),
        description="single central galaxy, 65,536 bodies",
        fallback_model="disk_galaxy", fallback_n=65535,
    ),
    3: DatasetSpec(
        "stars", "stars.dat", "dat", (400, 400, 400), camera_distance=3.0,
        description="star cluster explosion",
    ),
    4: DatasetSpec(
        "k17c", "k17c.snap", "snap", (300, 300, 300),
        description="globular cluster snapshot, 32,770 bodies",
    ),
    5: DatasetSpec(
        "k17hp", "k17hp.snap", "snap", (300, 300, 300),
        description="globular cluster snapshot, 10,002 bodies",
    ),
}

_READERS: dict[str, Callable] = {
    "tab": text.read_tab,
    "dat": text.read_dat,
    "snap": text.read_snap,
}


def data_dir() -> pathlib.Path:
    """Dataset directory: $NBODY_DATA_DIR, else ./data."""
    return pathlib.Path(os.environ.get("NBODY_DATA_DIR", "data"))


def load_dataset(
    dataset_id: int,
    *,
    directory: str | pathlib.Path | None = None,
    quirk_compat: bool = False,
    pad_reference_style: bool = False,
    max_bodies: int | None = None,
    seed: int = 0,
) -> tuple[SimState, DatasetSpec]:
    """Load dataset ``dataset_id`` (0-5), returning (state, spec).

    ``pad_reference_style`` pads to the reference's K*256+1 body count
    (``kernel.cu:260-278``); by default no padding is applied (the solvers
    pad to their own tile sizes). ``max_bodies`` truncates oversized inputs
    (the dev-history MAX_BODIES clamp, ``project_develop_code.cu:1597-1602``).
    """
    try:
        spec = DATASETS[dataset_id]
    except KeyError:
        raise ValueError(f"dataset id {dataset_id} not in {sorted(DATASETS)}")

    directory = pathlib.Path(directory) if directory is not None else data_dir()
    path = directory / spec.filename if spec.filename else None

    if path is not None and path.exists():
        if spec.reader == "tipsy":
            state = tipsy.read_tipsy(path).to_state()
        elif spec.reader == "snap" and quirk_compat:
            state = text.read_snap_as_dat(path).to_state()
        else:
            state = _READERS[spec.reader](path).to_state()
    elif spec.fallback_model:
        from n_body_problem_tpu_torch.models import make_model

        state = make_model(spec.fallback_model, spec.fallback_n, seed=seed)
    else:
        raise FileNotFoundError(
            f"dataset {dataset_id} ({spec.name}): {path} not found and no "
            f"procedural fallback exists"
        )

    if max_bodies is not None and state.n > max_bodies:
        state = dataclasses.replace(
            state, pos=state.pos[:max_bodies], vel=state.vel[:max_bodies],
            mass=state.mass[:max_bodies], eps=state.eps[:max_bodies],
            acc=state.acc[:max_bodies], n_real=min(state.n_real, max_bodies),
        )
    if pad_reference_style:
        state = pad_state(state, multiple=256, extra=1)
    return state, spec
