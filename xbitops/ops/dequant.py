"""Public ``dequant`` op — unpack 1–8-bit packed weights to fp16/bf16/f32.

Reference-compatible surface of ``XbitOps.dequant`` (``dq_torch_ops.cc:23-44``),
with its validation rules, plus :func:`dequant_qtensor` on a pre-converted
:class:`~xbitops.formats.QTensor`.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from xbitops import formats
from xbitops.formats import QTensor


def _validate(qweight, scales, qzeros, group_size, bits, in_features):
    # Mirrors the reference's TORCH_CHECK guards (dq_torch_ops.cc:25-31), minus the
    # bits=1 hole it validates but aborts on (SURVEY §5 quirk 5) — we support 1-bit.
    if group_size < 16:
        raise ValueError(f"group_size must be >= 16, got {group_size}")
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    expect_rows = (in_features * bits + 31) // 32
    if qweight.shape[0] != expect_rows:
        raise ValueError(
            f"qweight rows {qweight.shape[0]} != ceil(K*bits/32) = {expect_rows}"
        )
    if scales.shape[0] != -(-in_features // group_size):
        raise ValueError("scales rows != ceil(K/group_size)")
    if qzeros.shape != (scales.shape[0], (scales.shape[1] * bits + 31) // 32):
        raise ValueError("qzeros shape mismatch")


def dequant_qtensor(qt: QTensor, out_dtype=jnp.bfloat16) -> jax.Array:
    """Dequantize a QTensor to a dense ``(K, N)`` matrix in logical row order.

    Plain jnp: the unpack and the scale FMA are elementwise, and XLA fuses
    them into one pass that reads the packed words and writes the result."""
    return formats.dequant_qtensor_reference(qt, out_dtype=out_dtype)


def dequant(
    qweight: jax.Array,
    scales: jax.Array,
    qzeros: jax.Array,
    group_size: int,
    bits: int,
    in_features: int,
    add_zero_bias: int = 0,
    g_idx: Optional[jax.Array] = None,
    out_dtype=None,
) -> jax.Array:
    """Drop-in analog of ``XbitOps.dequant`` (``dq_torch_ops.cc:23-44``).

    Accepts the GPTQ interchange layout and returns the dense ``(K, N)`` weight in
    ``out_dtype`` (default: the scales' dtype, matching the reference's
    fp16-in/fp16-out and bf16-in/bf16-out behavior — without the reference's extra
    bf16→fp16→bf16 round-trip kernels, ``dq_torch_ops.cc:34-42``).

    For repeated use, convert once with :func:`xbitops.from_gptq` and call
    :func:`dequant_qtensor` — this wrapper repacks on every call.
    """
    _validate(qweight, scales, qzeros, group_size, bits, in_features)
    out_dtype = out_dtype or scales.dtype
    qt = formats.from_gptq(
        qweight, scales, qzeros, bits, group_size, in_features,
        add_zero_bias=add_zero_bias, g_idx=g_idx,
    )
    return dequant_qtensor(qt, out_dtype=out_dtype)
