"""Synthetic model-weight generators for benchmarks and dry-runs.

Perf benchmarks are shape-dependent, not value-dependent, so the 7B bench model
builds its packed :class:`~xbitops.formats.QTensor`s directly from random
bits — no dense f32 materialization, no quantization pass — keeping bench
startup seconds-fast and memory-light (the reference similarly benches on
synthetic packed data, ``gemv_w4a16.cu:172-228`` host-side random packer).
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from xbitops import formats
from xbitops.formats import PLANE_DECOMP, QTensor
from xbitops.kernels import common
from xbitops.models import llama


def random_qtensor(
    key: jax.Array,
    K: int,
    N: int,
    bits: int = 4,
    group_size: int = 128,
    tile_k: Optional[int] = None,
    row_shards: int = 1,
    scale_lo: float = 0.002,
    scale_hi: float = 0.01,
    storage_bits=None,
) -> QTensor:
    """A QTensor with random packed bits and small positive group scales.

    Statistically equivalent to a quantized random-normal weight for perf
    purposes; ~100x cheaper to build than quantize_array on large matrices.
    """
    if row_shards > 1:
        if K % row_shards:
            raise ValueError(f"K={K} must divide into {row_shards} shards")
        Ks = K // row_shards
        g_local = math.gcd(group_size, Ks)
        subkeys = jax.random.split(key, row_shards)
        shards = [
            random_qtensor(k, Ks, N, bits, g_local, tile_k, 1, scale_lo, scale_hi)
            for k in subkeys
        ]
        first = shards[0]
        return QTensor(
            planes=tuple(
                jnp.stack([s.planes[j] for s in shards])
                for j in range(len(first.planes))
            ),
            scales=jnp.stack([s.scales for s in shards]),
            scale_zeros=jnp.stack([s.scale_zeros for s in shards]),
            bits=bits,
            group_size=g_local,
            tile_k=first.tile_k,
            K=first.K,
            K_logical=first.K_logical,
        )

    value_bits = None
    sb = formats.resolve_storage_bits(bits, storage_bits)
    if sb != bits:
        value_bits, bits = bits, sb
    tile_k = tile_k or formats.default_tile_k(K, group_size, bits)
    K_logical = K
    K = common.round_up(K, tile_k)
    kp, ks, ksz = jax.random.split(key, 3)
    planes = []
    for j, pb in enumerate(PLANE_DECOMP[bits]):
        bits_u32 = jax.random.bits(
            jax.random.fold_in(kp, j), (K // (32 // pb), N), jnp.uint32
        )
        planes.append(lax.bitcast_convert_type(bits_u32, jnp.int32))
    T = K // tile_k
    gt = max(1, tile_k // group_size)
    gt_pad = common.round_up(gt, 8)
    maxq = (1 << (value_bits or bits)) - 1
    scales = jax.random.uniform(ks, (T, gt_pad, N), jnp.float32, scale_lo, scale_hi)
    # zero-point near mid-range so dequantized values are centered
    z = jax.random.uniform(ksz, (T, gt_pad, N), jnp.float32, 0.4 * maxq, 0.6 * maxq)
    return QTensor(
        planes=tuple(planes),
        scales=formats.encode_scale_store(scales, formats.FP16_BITS),
        scale_zeros=formats.encode_scale_store(scales * z, formats.FP16_BITS),
        bits=bits,
        group_size=group_size,
        tile_k=tile_k,
        K=K,
        K_logical=K_logical,
        value_bits=value_bits,
    )


def random_llama_params(
    key: jax.Array,
    cfg: llama.LlamaConfig,
    bits: Optional[int] = 4,
    group_size: int = 128,
    dtype=jnp.bfloat16,
    tp: int = 1,
    fuse: bool = True,
) -> dict:
    """Random Llama params fast: packed projections from random bits
    (``bits=None`` → dense ``dtype`` weights, the a16w16 baseline model).
    ``fuse`` packs q|k|v and gate|up as single matmuls (random content, so no
    interleaving is needed for TP)."""

    def q(key, kdim, ndim, row_parallel=False):
        if bits is None:
            scale = kdim ** -0.5
            return (jax.random.normal(key, (kdim, ndim), dtype) * scale).astype(dtype)
        return random_qtensor(
            key, kdim, ndim, bits, group_size,
            row_shards=tp if (row_parallel and tp > 1) else 1,
        )

    h, ffn = cfg.hidden_size, cfg.intermediate_size
    qdim = cfg.num_heads * cfg.head_dim
    kvdim = cfg.num_kv_heads * cfg.head_dim
    keys = jax.random.split(key, cfg.num_layers * 7 + 3)
    layers = []
    for i in range(cfg.num_layers):
        k = keys[i * 7 : (i + 1) * 7]
        if fuse:
            attn_mlp = dict(
                wqkv=q(k[0], h, qdim + 2 * kvdim),
                w_gateup=q(k[4], h, 2 * ffn),
            )
        else:
            attn_mlp = dict(
                wq=q(k[0], h, qdim),
                wk=q(k[1], h, kvdim),
                wv=q(k[2], h, kvdim),
                w_gate=q(k[4], h, ffn),
                w_up=q(k[5], h, ffn),
            )
        layers.append(
            dict(
                **attn_mlp,
                wo=q(k[3], qdim, h, row_parallel=True),
                w_down=q(k[6], ffn, h, row_parallel=True),
                ln_attn=jnp.ones((h,), jnp.float32),
                ln_mlp=jnp.ones((h,), jnp.float32),
            )
        )
    embed = (jax.random.normal(keys[-3], (cfg.vocab_size, h), dtype) * 0.02).astype(dtype)
    return dict(
        embed=embed,
        lm_head=q(keys[-2], h, cfg.vocab_size),
        ln_final=jnp.ones((h,), jnp.float32),
        layers=layers,
    )


def copy_llama_params(
    key: jax.Array,
    cfg: llama.LlamaConfig,
    bits: int = 4,
    group_size: int = 128,
    period: int = 8,
    tp: int = 1,
) -> dict:
    """A "copy-model": greedy decode follows the period-``period`` token
    cycle ``0, 1, .., period-1, 0, ..`` at real quantized weight bytes.

    The residual stream stays ~= the current token's embedding (the output
    projections ``wo``/``w_down`` carry ~1e-4-scale weights, so attention and
    MLP contributions are negligible against the 0.02-scale embeddings), and
    lm_head column ``(v+1) % period`` is embedding row ``v`` — so
    ``argmax(logits) = (token + 1) % period`` with a large margin over the
    random columns.

    This is the speculative-decoding FAVORABLE case (repetitive
    continuations, the prompt-lookup draft's use case) at honest compute
    cost: decode and verify both run the full quantized model — random
    weights (acceptance 0) and this (acceptance ~1) bracket real workloads.

    ``tp > 1`` lays the SAME model out for a ``tp``-way tensor-parallel mesh:
    fused column weights interleave per shard (``llama.interleave_order``)
    and ``wo``/``w_down`` pack row-sharded from the same dense values, so the
    ``tp`` and one-card layouts hold identical dequantized weights.
    """
    from xbitops.ops.quantize import quantize_array

    params = random_llama_params(key, cfg, bits, group_size)
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    qdim = cfg.num_heads * cfg.head_dim
    kvdim = cfg.num_kv_heads * cfg.head_dim
    keys = jax.random.split(jax.random.fold_in(key, 1), 2 * cfg.num_layers + 1)

    def cols(qt, sizes):
        order = jnp.asarray(llama.interleave_order(sizes, tp))
        return jax.tree.map(lambda x: jnp.take(x, order, axis=-1), qt)

    def tiny(k, kdim):
        w = jax.random.normal(k, (kdim, h), jnp.float32) * 5e-5
        return quantize_array(w, bits, group_size, row_shards=tp)

    for i, layer in enumerate(params["layers"]):
        layer["wo"] = tiny(keys[2 * i], qdim)
        layer["w_down"] = tiny(keys[2 * i + 1], ffn)
        if tp > 1:
            layer["wqkv"] = cols(layer["wqkv"], (qdim, kvdim, kvdim))
            layer["w_gateup"] = cols(layer["w_gateup"], (ffn, ffn))
    assert period <= cfg.vocab_size
    embed = params["embed"].astype(jnp.float32)
    W = jax.random.normal(keys[-1], (h, cfg.vocab_size), jnp.float32) * 0.02
    succ = (jnp.arange(period) + 1) % period
    W = W.at[:, succ].set(embed[:period].T)
    params["lm_head"] = quantize_array(W, bits, group_size)
    return params
