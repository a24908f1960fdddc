"""Tiny dependency-free helpers shared across the ops layer."""


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m
