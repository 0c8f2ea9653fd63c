"""Name -> initial-condition generator registry (CLI-facing)."""

from __future__ import annotations

from typing import Callable

from n_body_problem_tpu_torch.models.agora import agora_disk
from n_body_problem_tpu_torch.models.galaxy import disk_galaxy, galaxy_collision
from n_body_problem_tpu_torch.models.plummer import plummer
from n_body_problem_tpu_torch.models.solar_system import solar_system
from n_body_problem_tpu_torch.models.uniform import cold_sphere, uniform_cube
from n_body_problem_tpu_torch.state import SimState

MODELS: dict[str, Callable[..., SimState]] = {
    "plummer": plummer,
    "solar_system": lambda n=9, **kw: solar_system(**{k: v for k, v in kw.items() if k != "n"}),
    "uniform_cube": uniform_cube,
    "cold_sphere": cold_sphere,
    "disk_galaxy": disk_galaxy,
    "galaxy_collision": galaxy_collision,
    "agora_disk": agora_disk,
}


def make_model(name: str, n: int, **kw) -> SimState:
    try:
        fn = MODELS[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; expected one of {sorted(MODELS)}")
    return fn(n, **kw) if name != "solar_system" else MODELS[name](n=n, **kw)
