"""Public fused quantized matmul / GEMV ops.

``qmatmul`` is the native surface (activations × QTensor); ``gemv`` is the
reference-compatible wrapper for ``XbitOps.gemv`` (``dq_torch_ops.cc:46-78``) —
but unlike the reference, which aborts outside bits=4/group_size=128
(``gemv_w4a16_pt.cu:152-155``), every bit-width 1..8 and group size ≥ 16 is
supported here.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from xbitops import formats
from xbitops.formats import QTensor
from xbitops.kernels.qgemv_kernel import block_n, kernel_plan, qmatmul_kernel

# Rows above which the plain path (dense dequant + the library GEMM) replaces
# the fused kernel.  On the card the kernel wins up to 32 rows, ties or
# loses at 64 and loses from 128 on (PERF.md).
KERNEL_MAX_M = 32


def use_fused_kernel(M: int, qt: QTensor) -> bool:
    """The fused kernel runs decode-sized M on tile geometries it can block;
    everything else takes the plain dequant-then-dot path."""
    return (M <= KERNEL_MAX_M and block_n(qt.N) is not None
            and kernel_plan(qt) is not None)


def _at_layer(qt: QTensor, layer) -> QTensor:
    return jax.tree.map(lambda x: x[layer], qt)


def _a8_matmul(a2: jax.Array, qt: QTensor) -> jax.Array:
    """W4A8-style product: activations quantized per row to int8 (absmax),
    integer weights, an exact int8 x int8 -> int32 dot per scale group, and
    the group scales applied to the int32 sums:
        out = a_scale * (sum_g s_g * (aq_g @ wq_g) - (sum aq_g) * sz_g)."""
    M, K = a2.shape
    gt = qt.groups_per_tile
    g_rows = qt.tile_k // gt
    G = K // g_rows
    af = a2.astype(jnp.float32)
    a_scale = jnp.maximum(jnp.max(jnp.abs(af), axis=1, keepdims=True), 1e-30) / 127.0
    aq = jnp.round(af / a_scale).astype(jnp.int8)
    wq = formats.unpack_planes_reference(
        qt.planes, qt.bits, qt.tile_k, qt.K, paired=qt.paired
    )
    # 8-bit values (0..255) do not fit int8: shift by -128 and add it back
    # through the exact activation sums
    shift = 128 if qt.bits == 8 else 0
    wq8 = (wq - shift).astype(jnp.int8).reshape(G, g_rows, -1)
    aq_g = aq.reshape(M, G, g_rows).swapaxes(0, 1)  # (G, M, g_rows)
    d = jax.lax.dot_general(
        aq_g, wq8, (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32)  # (G, M, N)
    asum = aq_g.astype(jnp.int32).sum(-1).astype(jnp.float32)  # (G, M)
    s = formats.decode_scale_store(qt.scales[:, :gt]).reshape(G, -1)
    sz = formats.decode_scale_store(qt.scale_zeros[:, :gt]).reshape(G, -1)
    out = jnp.einsum("gmn,gn->mn", d + shift * asum[..., None], s,
                     precision=jax.lax.Precision.HIGHEST)
    out = out - jnp.dot(asum.T, sz, precision=jax.lax.Precision.HIGHEST)
    return out * a_scale


def qmatmul(
    a: jax.Array,
    qt: QTensor,
    out_dtype=None,
    precise: bool = False,
    use_kernel: bool = True,
    interpret: Optional[bool] = None,
    layer: Optional[jax.Array] = None,
    a8: bool = False,
) -> jax.Array:
    """``a[..., K] @ dequant(qt)[K, N] -> [..., N]``.

    Decode-sized products run the fused kernel, which never materializes the
    dense weight; larger ones dequantize to the compute dtype and call the
    library GEMM (see ``KERNEL_MAX_M``).  Leading dims of ``a`` fold into M
    (as the reference folds 3-D inputs, ``dq_torch_ops.cc:61-64``).
    Act-order QTensors gather the activation columns through ``qt.perm``
    (exllama-style) rather than gathering weights.

    ``layer`` (traced int32): ``qt``'s arrays carry a leading layer axis
    (``models.llama.stack_layers``) and the kernel reads that layer in place.

    ``precise=True`` keeps activations in f32 with f32 dots (the reference's
    f32-accumulation variant); otherwise activations round to bf16.
    ``use_kernel=False`` is the f32 oracle at ``Precision.HIGHEST``.

    ``a8=True`` (W4A8-style): activations quantize per row to int8 (absmax)
    and each scale group is an exact int8 x int8 -> int32 dot; only
    activations round (~1/254 per-element relative).
    """
    out_dtype = out_dtype or a.dtype
    *lead, K = a.shape
    if K != qt.K_logical:
        raise ValueError(f"a K={K} != weight K={qt.K_logical}")
    M = 1
    for d in lead:
        M *= d
    a2 = a.reshape(M, K)
    if qt.perm is not None:
        # stacked QTensors carry a per-layer permutation [L, K]
        p = qt.perm if layer is None else qt.perm[layer]
        a2 = jnp.take(a2, p, axis=1)
    if qt.K != K:  # padded packed rows: zero activations contribute nothing
        a2 = jnp.pad(a2, ((0, 0), (0, qt.K - K)))
    Nl = qt.shape[1]

    def finish(out):
        return out[:, :Nl].reshape(*lead, Nl).astype(out_dtype)

    if not use_kernel:
        w = formats.dequant_qtensor_stored(
            qt if layer is None else _at_layer(qt, layer)
        )
        a_or = a2.astype(jnp.float32)
        if a8:  # fake-quant the activations like the a8 path does
            sc = jnp.maximum(jnp.max(jnp.abs(a_or), axis=1, keepdims=True), 1e-30) / 127.0
            a_or = jnp.round(a_or / sc) * sc
        return finish(jnp.dot(
            a_or, w, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ))
    if a8:
        return finish(_a8_matmul(a2, qt if layer is None else _at_layer(qt, layer)))
    if use_fused_kernel(M, qt):
        kernel_out = jnp.float32 if precise else out_dtype
        return finish(qmatmul_kernel(
            a2, qt, out_dtype=kernel_out, precise=precise,
            interpret=interpret, layer_idx=layer,
        ))
    compute = jnp.float32 if precise else jnp.bfloat16
    w = formats.dequant_qtensor_stored(
        qt if layer is None else _at_layer(qt, layer), out_dtype=compute
    )
    return finish(jnp.dot(
        a2.astype(compute), w, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST if precise else None,
    ))


def gemv(
    input_a: jax.Array,
    qweight: jax.Array,
    scales: jax.Array,
    qzeros: jax.Array,
    group_size: int,
    bits: int,
    in_features: int,
    add_zero_bias: int = 0,
    g_idx: Optional[jax.Array] = None,
    out_dtype=None,
    use_kernel: bool = True,
) -> jax.Array:
    """Drop-in analog of ``XbitOps.gemv`` (``dq_torch_ops.cc:46-78``): fused
    dequantize + GEMV/GEMM from the GPTQ interchange layout.

    For hot loops, convert once with :func:`xbitops.from_gptq` and call
    :func:`qmatmul` — this wrapper repacks the weight on every call.
    """
    qt = formats.from_gptq(
        qweight, scales, qzeros, bits, group_size, in_features,
        add_zero_bias=add_zero_bias, g_idx=g_idx,
    )
    return qmatmul(input_a, qt, out_dtype=out_dtype or input_a.dtype, use_kernel=use_kernel)
