"""Shape-alignment helpers (kernel tiles want whole multiples)."""

from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(n: int, multiple: int) -> int:
    if multiple <= 0:
        raise ValueError("multiple must be positive")
    return cdiv(n, multiple) * multiple
