from n_body_problem_tpu_torch.render.camera import OrbitCamera, look_at, perspective
from n_body_problem_tpu_torch.render.splat import splat_frame, render_state, project_to_screen
from n_body_problem_tpu_torch.render.sprites import sprite_footprint, GOLDEN_COLOR
from n_body_problem_tpu_torch.render.image import tonemap, write_png, write_ppm
from n_body_problem_tpu_torch.render.viewer import FrameWriter

__all__ = [
    "OrbitCamera",
    "look_at",
    "perspective",
    "splat_frame",
    "render_state",
    "project_to_screen",
    "sprite_footprint",
    "GOLDEN_COLOR",
    "tonemap",
    "write_png",
    "write_ppm",
    "FrameWriter",
]
