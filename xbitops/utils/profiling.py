"""Observability: profiler traces, device peaks and decode roofline reports.

- :func:`trace` wraps ``jax.profiler`` for on-demand traces;
- :data:`DEVICE_PEAKS` holds the published peaks a measured time is divided
  by, keyed by ``device_kind``; an unknown device is an error;
- :func:`decode_roofline` decomposes a decode step's device-memory traffic
  (packed weights, dense weights, KV cache read+write) and reports a
  measured step time against the bandwidth bound.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import jax

from xbitops.formats import QTensor

# Published dense peaks (NVIDIA H100 / H200 SXM data sheets): device-memory
# bytes/s and bf16 tensor-core FLOP/s, at the card's full power limit.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "bf16_flops": 989e12},
    "NVIDIA H200": {"hbm_bytes_per_s": 4.8e12, "bf16_flops": 989e12},
}


def device_peaks(device_kind: Optional[str] = None) -> dict:
    """Peaks of ``device_kind`` (default: the first JAX device's)."""
    kind = device_kind if device_kind is not None else jax.devices()[0].device_kind
    if kind not in DEVICE_PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}")
    return DEVICE_PEAKS[kind]


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("/path/trace"):`` — view with xprof/tensorboard."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class DecodeRoofline:
    weight_bytes: int  # packed + dense weight stream per step
    cache_bytes: int  # KV read + write per step at current lengths
    total_bytes: int
    hbm_gbps_peak: float
    bound_ms: float  # total_bytes / peak
    measured_ms: Optional[float] = None

    @property
    def efficiency(self) -> Optional[float]:
        if self.measured_ms is None:
            return None
        return self.bound_ms / self.measured_ms

    def __str__(self) -> str:
        s = (
            f"weights {self.weight_bytes/1e9:.2f} GB + cache "
            f"{self.cache_bytes/1e9:.3f} GB per step -> bound "
            f"{self.bound_ms:.2f} ms @ {self.hbm_gbps_peak:.0f} GB/s"
        )
        if self.measured_ms is not None:
            s += f"; measured {self.measured_ms:.2f} ms ({self.efficiency:.0%} of roofline)"
        return s


def model_weight_bytes(params) -> int:
    """Per-step weight traffic: packed QTensor bytes + dense weight bytes
    (embedding gathers excluded — decode reads only B rows)."""
    total = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(
        params, is_leaf=lambda x: isinstance(x, QTensor)
    ):
        if isinstance(leaf, QTensor):
            total += leaf.bytes_packed()
        elif any(getattr(k, "key", None) == "embed" for k in path):
            continue  # gather, not a full read
        elif hasattr(leaf, "dtype"):
            total += leaf.size * leaf.dtype.itemsize
    return total


def kv_step_bytes(cfg, batch: int, mean_len: int, dtype_bytes: int = 2) -> int:
    """KV bytes touched per decode step: read all cached positions + write one."""
    per_pos = cfg.num_kv_heads * cfg.head_dim * dtype_bytes * 2  # k and v
    return cfg.num_layers * batch * (mean_len + 1) * per_pos


def decode_roofline(
    params,
    cfg,
    batch: int,
    mean_len: int = 0,
    device_kind: Optional[str] = None,
    measured_ms: Optional[float] = None,
) -> DecodeRoofline:
    """Bandwidth bound of a decode step on ``device_kind`` (default: the
    first JAX device's; see :func:`device_peaks`)."""
    peak_gbps = device_peaks(device_kind)["hbm_bytes_per_s"] / 1e9
    wb = model_weight_bytes(params)
    cb = kv_step_bytes(cfg, batch, mean_len)
    total = wb + cb
    return DecodeRoofline(
        weight_bytes=wb,
        cache_bytes=cb,
        total_bytes=total,
        hbm_gbps_peak=peak_gbps,
        bound_ms=total / peak_gbps / 1e6,
        measured_ms=measured_ms,
    )
