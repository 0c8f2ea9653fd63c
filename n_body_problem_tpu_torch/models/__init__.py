from n_body_problem_tpu_torch.models.plummer import plummer
from n_body_problem_tpu_torch.models.solar_system import solar_system
from n_body_problem_tpu_torch.models.uniform import uniform_cube, cold_sphere
from n_body_problem_tpu_torch.models.galaxy import disk_galaxy, galaxy_collision
from n_body_problem_tpu_torch.models.registry import MODELS, make_model

__all__ = [
    "plummer",
    "solar_system",
    "uniform_cube",
    "cold_sphere",
    "disk_galaxy",
    "galaxy_collision",
    "MODELS",
    "make_model",
]
