"""On-device quantization: float weight → QTensor (native layout).

The reference has no quantizer (checkpoints arrive pre-quantized); this exists so
models can be quantized on the fly for benchmarks and tests, and so full-model
conversion never leaves the accelerator.  Asymmetric per-group min/max with GPTQ
conventions (``w ≈ (wq - z) * s``).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from xbitops import formats
from xbitops.formats import QTensor
from xbitops.kernels import common


def quantize_array(
    w: jax.Array,
    bits: int,
    group_size: int = 128,
    sym: bool = False,
    tile_k: Optional[int] = None,
    scale_store_dtype=formats.FP16_BITS,
    scale_round_dtype=None,
    row_shards: int = 1,
    act_order: bool = False,
    storage_bits=None,
) -> QTensor:
    """Quantize ``w[K, N]`` to ``bits`` with per-group scale/zero, returning the
    packed native layout.  ``scale_round_dtype`` (e.g. fp16) optionally rounds scales
    through a checkpoint dtype first, for parity with fp16 GPTQ checkpoints.
    ``row_shards > 1`` packs for row-parallel TP (stacked shard leaves — see
    ``formats.make_row_sharded_qtensor``).

    ``act_order`` quantizes rows in descending-salience order so groups span
    similar-magnitude rows (the GPTQ desc_act idea; real checkpoints carry the
    measured order as ``g_idx`` through :func:`formats.from_gptq`).  The row
    permutation is stored on the QTensor and activations are gathered at
    matmul time — kernels stay gather-free (exllama's approach to the
    reference's disabled act-order kernel, ``quant_cuda_kernel.cu:257-336``).
    With ``row_shards > 1`` the ordering is PER SHARD (each K-shard sorts its
    own rows), so the gather stays shard-local under row-parallel TP — no
    cross-device permutation; the stored perm is ``[row_shards, K/row_shards]``
    of shard-local indices."""
    K, N = w.shape
    perm = None
    if act_order:
        salience = jnp.sum(jnp.abs(w.astype(jnp.float32)), axis=1)
        if row_shards > 1:
            if K % row_shards:
                raise ValueError(f"K={K} must divide into {row_shards} shards")
            Ks = K // row_shards
            perm = jnp.argsort(
                -salience.reshape(row_shards, Ks), axis=1
            ).astype(jnp.int32)  # [row_shards, Ks] shard-local
            full = (perm + (jnp.arange(row_shards) * Ks)[:, None]).reshape(-1)
            w = jnp.take(w, full, axis=0)
        else:
            perm = jnp.argsort(-salience).astype(jnp.int32)
            w = jnp.take(w, perm, axis=0)
    Kp = common.round_up(K, group_size)
    wf = jnp.pad(w.astype(jnp.float32), ((0, Kp - K), (0, 0)))
    G = Kp // group_size
    maxq = (1 << bits) - 1
    wg = wf.reshape(G, group_size, N)
    if scale_round_dtype is None:
        # deployed scales are fp16 (FP16_BITS storage): round BEFORE choosing
        # q/zero so they compensate the stored value, like real GPTQ
        scale_round_dtype = jnp.float16
    if sym:
        amax = jnp.max(jnp.abs(wg), axis=1)
        scale = jnp.maximum(amax / (maxq / 2), 1e-8)
        scale = scale.astype(scale_round_dtype).astype(jnp.float32)
        zero = jnp.full((G, N), (maxq + 1) // 2, jnp.float32)
    else:
        lo = jnp.minimum(jnp.min(wg, axis=1), 0.0)
        hi = jnp.maximum(jnp.max(wg, axis=1), 0.0)
        scale = jnp.maximum((hi - lo) / maxq, 1e-8)
        scale = scale.astype(scale_round_dtype).astype(jnp.float32)
        zero = jnp.clip(jnp.round(-lo / scale), 0, maxq)
    q = jnp.clip(jnp.round(wg / scale[:, None, :] + zero[:, None, :]), 0, maxq)
    wq = q.reshape(Kp, N).astype(jnp.int32)[:K]
    scale = scale.astype(scale_round_dtype)
    zero = zero.astype(jnp.int32)
    if row_shards > 1:
        return formats.make_row_sharded_qtensor(
            wq, scale, zero, bits, group_size, row_shards,
            tile_k=tile_k, scale_store_dtype=scale_store_dtype,
            storage_bits=storage_bits, perm=perm,
        )
    return formats.make_qtensor(
        wq, scale, zero, bits, group_size, add_zero_bias=0, tile_k=tile_k,
        perm=perm, scale_store_dtype=scale_store_dtype, storage_bits=storage_bits,
    )


def requantize_a8(qt: QTensor, tile_k: Optional[int] = None) -> QTensor:
    """Re-quantize a grouped QTensor to 8-bit PER-CHANNEL scales: the a8
    (W4A8) product then runs as ONE int32 dot per row with a single rescale
    at the output, instead of one per scale group.

    Cost: 8 storage bits per weight (~2x the bytes of 4-bit; callers keeping
    the 4-bit tensor for decode hold both copies).  Accuracy: adds one 8-bit rounding against the COLUMN range
    — (col max-min)/255 per element, typically ~10x under the original 4-bit
    per-group grid, so combined error stays dominated by the original
    quantization (per-channel W8 is near-lossless for LLM weights).
    Act-order inputs requantize in logical row order (no perm afterwards)."""
    wd = formats.dequant_qtensor_reference(qt, out_dtype=jnp.float32)
    return quantize_array(wd, 8, group_size=wd.shape[0], tile_k=tile_k)
