"""Shared helpers for the Pallas GPU kernels (Triton route)."""

from __future__ import annotations

import jax


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def interpret_for(backend: str) -> bool:
    """Whether Pallas kernels run in the interpreter on ``backend``.

    The kernels are written for the GPU (Pallas through Triton) and compile
    there; the CPU is the test harness, where they interpret.  Any other
    backend has no compiled form of these kernels and must not fall back to
    the interpreter silently, so it raises."""
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise RuntimeError(
        f"no Pallas kernels for backend {backend!r}: they compile for 'gpu' "
        "and interpret on 'cpu'"
    )


def interpret_default() -> bool:
    return interpret_for(jax.default_backend())
