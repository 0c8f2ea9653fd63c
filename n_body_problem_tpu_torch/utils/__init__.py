from n_body_problem_tpu_torch.utils.padding import round_up, cdiv

__all__ = ["round_up", "cdiv"]
