"""Benchmark timing on a local card.

JAX returns before the device finishes, so every timed call ends in
``block_until_ready``; the first call compiles and is reported apart.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import jax
import numpy as np


def time_call(fn: Callable, *args, repeats: int = 5) -> Tuple[float, float]:
    """``(first_call_seconds, median_seconds)`` of ``fn(*args)``: the first
    call includes compilation, the median is over ``repeats`` later calls."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts))


def roofline_gbps(bytes_moved: int, seconds: float) -> float:
    return bytes_moved / seconds / 1e9
