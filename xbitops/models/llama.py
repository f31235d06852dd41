"""Quantized Llama-family decoder, functional JAX.

The reference ships no model code — its README positions the ops for GPTQ LLM
inference and leaves the model to the caller (SURVEY §1 "what sits above L4").
Here the model is part of the framework: every projection is a packed
:class:`~xbitops.formats.QTensor` consumed by the fused Pallas matmul, the KV
cache is a static-shape ring the decode step updates in place, and the same
forward code runs single-chip or tensor-parallel (the :class:`Runtime` strategy
supplies plain or collective-reducing linears).

Supports Llama-2 (7B/13B) and any config-compatible variant (GQA included).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from xbitops.formats import QTensor
from xbitops.ops.qmatmul import qmatmul
from xbitops.ops.quantize import quantize_array


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 2048
    # attention against the cache through the length-aware Pallas kernel
    # (reads scale with live lengths, not the cache allocation); the plain
    # XLA path if False
    flash_decode: bool = True
    # W4A8 prefill: projections on T >= 32 token blocks quantize activations
    # per row to int8 and run exact int8 x int8 -> int32 dots per scale group
    # (~0.5-1% activation rounding).  Decode (T == 1) always stays bf16.
    prefill_a8: bool = False
    # Long-context RoPE scaling: "linear" divides positions by `factor`
    # (position interpolation), "ntk" stretches the base theta by
    # factor^(d/(d-2)) (NTK-aware interpolation).  None = stock RoPE.
    rope_scaling_type: Optional[str] = None  # None | "linear" | "ntk"
    rope_scaling_factor: float = 1.0
    # Sliding-window attention (Mistral): each query attends only the last
    # `sliding_window` positions.  Masks bound every XLA attention path and
    # the attention kernel starts reading at the window's first block —
    # decode reads scale with min(live, window), not live.  The
    # cache still allocates max_seq_len rows (positions stay absolute; a
    # rolling buffer would break the engine's position/padding invariants);
    # use the int8 or paged cache to bound capacity.
    sliding_window: Optional[int] = None

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def mistral_7b() -> "LlamaConfig":
        """Mistral-7B-v0.1: GQA (8 kv heads), 14336 ffn, 4096-token sliding
        window (HF config.json sliding_window; window semantics per the
        Mistral reference: query at position p attends (p-W, p])."""
        return LlamaConfig(
            intermediate_size=14336, num_kv_heads=8, max_seq_len=8192,
            sliding_window=4096,
        )

    @staticmethod
    def llama2_13b() -> "LlamaConfig":
        return LlamaConfig(
            hidden_size=5120, intermediate_size=13824, num_layers=40,
            num_heads=40, num_kv_heads=40,
        )

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        """Llama-3-8B: GQA (8 kv heads), 128k vocab, theta 5e5, 8k context."""
        return LlamaConfig(
            vocab_size=128256, intermediate_size=14336, num_kv_heads=8,
            rope_theta=500000.0, max_seq_len=8192,
        )

    @staticmethod
    def tiny(vocab: int = 256, seq: int = 64) -> "LlamaConfig":
        """Test-size config (shapes still tile-legal: hidden 256, ffn 512)."""
        return LlamaConfig(
            vocab_size=vocab, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
            max_seq_len=seq,
        )

    def local(self, tp: int) -> "LlamaConfig":
        """Per-shard view under tensor parallelism (heads and ffn split)."""
        assert self.num_heads % tp == 0 and self.num_kv_heads % tp == 0
        assert self.intermediate_size % tp == 0
        return dataclasses.replace(
            self,
            num_heads=self.num_heads // tp,
            num_kv_heads=self.num_kv_heads // tp,
            intermediate_size=self.intermediate_size // tp,
        )


# --- parameter pytrees (plain dicts for orbax-friendliness) ---


def interleave_order(sizes, tp: int):
    """Column order turning a concat ``[A|B|C]`` into per-shard interleaving
    ``[A_0|B_0|C_0|A_1|B_1|C_1|...]`` so a fused column-parallel weight splits
    into self-consistent per-shard ``[q_s|k_s|v_s]`` blocks (Megatron fused-QKV
    layout)."""
    import numpy as np

    offs = np.cumsum([0] + list(sizes[:-1]))
    for sz in sizes:
        if sz % tp:
            raise ValueError(
                f"fused block of size {sz} does not split evenly over tp={tp}; "
                f"a truncated interleave would corrupt the packed checkpoint"
            )
    idx = []
    for s in range(tp):
        for off, sz in zip(offs, sizes):
            per = sz // tp
            idx.extend(range(off + s * per, off + (s + 1) * per))
    return np.asarray(idx, np.int32)


def init_params(
    key: jax.Array,
    cfg: LlamaConfig,
    bits: Optional[int] = 4,
    group_size: int = 128,
    dtype=jnp.bfloat16,
    tp: int = 1,
    fuse: bool = True,
    act_order: bool = False,
) -> dict:
    """Random-init a model; projections packed to ``bits`` (None = dense bf16).

    ``tp > 1`` packs the row-parallel weights (wo, w_down) shard-stacked for a
    ``tp``-way mesh (see ``formats.make_row_sharded_qtensor``).  ``fuse`` packs
    q|k|v and gate|up as single fused matmuls (per-shard interleaved under TP).
    ``act_order`` quantizes rows in salience order (exllama-style permuted
    groups).  Under TP, column-parallel weights keep a global order (K is
    replicated) and row-parallel weights use per-K-shard ordering so the
    activation gather stays shard-local (see ``quantize_array``)."""

    def dense(key, shape, scale):
        return (jax.random.normal(key, shape, jnp.float32) * scale).astype(jnp.float32)

    def q(key, kdim, ndim, scale, row_parallel=False):
        w = dense(key, (kdim, ndim), scale)
        if bits is None:
            return w.astype(dtype)
        row_shards = tp if (row_parallel and tp > 1) else 1
        return quantize_array(
            w, bits, group_size, row_shards=row_shards, act_order=act_order,
        )

    def q_fused(key, kdim, ndims, scale):
        w = dense(key, (kdim, sum(ndims)), scale)
        if tp > 1:
            w = w[:, interleave_order(ndims, tp)]
        if bits is None:
            return w.astype(dtype)
        return quantize_array(w, bits, group_size, act_order=act_order)

    h, ffn = cfg.hidden_size, cfg.intermediate_size
    qdim = cfg.num_heads * cfg.head_dim
    kvdim = cfg.num_kv_heads * cfg.head_dim
    s = h ** -0.5
    keys = jax.random.split(key, cfg.num_layers * 7 + 3)
    layers = []
    for i in range(cfg.num_layers):
        k = keys[i * 7 : (i + 1) * 7]
        if fuse:
            attn_mlp = dict(
                wqkv=q_fused(k[0], h, (qdim, kvdim, kvdim), s),
                w_gateup=q_fused(k[4], h, (ffn, ffn), s),
            )
        else:
            attn_mlp = dict(
                wq=q(k[0], h, qdim, s),
                wk=q(k[1], h, kvdim, s),
                wv=q(k[2], h, kvdim, s),
                w_gate=q(k[4], h, ffn, s),
                w_up=q(k[5], h, ffn, s),
            )
        layers.append(
            dict(
                **attn_mlp,
                wo=q(k[3], qdim, h, s, row_parallel=True),
                w_down=q(k[6], ffn, h, ffn ** -0.5, row_parallel=True),
                ln_attn=jnp.ones((h,), jnp.float32),
                ln_mlp=jnp.ones((h,), jnp.float32),
            )
        )
    return dict(
        embed=(jax.random.normal(keys[-3], (cfg.vocab_size, h), jnp.float32) * 0.02).astype(dtype),
        lm_head=q(keys[-2], h, cfg.vocab_size, s),
        ln_final=jnp.ones((h,), jnp.float32),
        layers=layers,
    )


# --- KV cache ---


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class KVCache:
    """Static-shape HEAD-MAJOR cache ``[L, B, n_kv, S_max, head_dim]`` with
    per-slot lengths: one kv head's positions are contiguous rows, so the
    attention kernel loads a block of them as one ``(bs, D)`` tile
    (kernels/attention.py).

    With ``quantized=True`` at init, k/v store int8 values packed four
    consecutive sequence positions per int32 word, ``[L, B, n_kv, S/4,
    head_dim]`` (byte j of word w = position 4w+j), bytes BIASED by +128
    (u = v+128 ∈ [1, 255]), with per-(position, head) absmax scales
    ``[L, B, 4, n_kv, S/4]`` — twice the context capacity per byte of device
    memory at near-lossless accuracy.  The scale layout keeps S/4 minor, so
    a block's scales for byte j are one contiguous row.
    """

    k: jax.Array
    v: jax.Array
    lengths: jax.Array  # int32 [B]
    k_scale: Optional[jax.Array] = None  # bf16 [L, B, 4, n_kv, S/4] (int8 cache)
    v_scale: Optional[jax.Array] = None
    # Paged mode: k/v are page POOLS [L, n_pages, n_kv, page_size(/4), D]
    # shared by all slots, and `page_table` int32 [B, P] maps each slot's
    # virtual page p to a pool page (-1 = unallocated).  Slots stop paying
    # S_max of device memory each — the engine's allocator hands pages out on demand, so a
    # pool sized for the expected TOTAL context serves mixed long/short
    # batches that would not fit dense per-slot allocations.  Composes with
    # the int8 cache (scale pools [L, n_pages, 4, n_kv, page_size/4]).
    page_table: Optional[jax.Array] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def paged(self) -> bool:
        return self.page_table is not None

    @property
    def page_size(self) -> int:
        assert self.paged
        return self.k.shape[3] * (4 if self.quantized else 1)

    @property
    def S(self) -> int:
        """Per-slot capacity in positions (virtual for a paged cache)."""
        if self.paged:
            return self.page_table.shape[1] * self.page_size
        return self.k.shape[3] * (4 if self.quantized else 1)

    def tree_flatten(self):
        return (
            self.k, self.v, self.lengths, self.k_scale, self.v_scale,
            self.page_table,
        ), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @staticmethod
    def init(
        cfg: LlamaConfig, batch: int, dtype=jnp.bfloat16, quantized: bool = False
    ) -> "KVCache":
        L, Hkv, D, S = (
            cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, cfg.max_seq_len
        )
        if quantized:
            if S % 4:
                raise ValueError("int8 KV cache needs max_seq_len % 4 == 0")
            wshape = (L, batch, Hkv, S // 4, D)
            return KVCache(
                k=jnp.zeros(wshape, jnp.int32), v=jnp.zeros(wshape, jnp.int32),
                lengths=jnp.zeros((batch,), jnp.int32),
                k_scale=jnp.zeros((L, batch, 4, Hkv, S // 4), jnp.bfloat16),
                v_scale=jnp.zeros((L, batch, 4, Hkv, S // 4), jnp.bfloat16),
            )
        return KVCache(
            k=jnp.zeros((L, batch, Hkv, S, D), dtype),
            v=jnp.zeros((L, batch, Hkv, S, D), dtype),
            lengths=jnp.zeros((batch,), jnp.int32),
        )

    @staticmethod
    def init_paged(
        cfg: LlamaConfig,
        batch: int,
        pool_pages: int,
        page_size: int = 256,
        dtype=jnp.bfloat16,
        quantized: bool = False,
    ) -> "KVCache":
        """Paged cache: a shared pool of ``pool_pages`` pages of ``page_size``
        positions each (memory ~ pool size, not slots * S_max) plus an
        all-unallocated page table."""
        if cfg.max_seq_len % page_size:
            raise ValueError("max_seq_len must be a multiple of page_size")
        L, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        P = cfg.max_seq_len // page_size
        table = jnp.full((batch, P), -1, jnp.int32)
        if quantized:
            if page_size % 4:
                raise ValueError("int8 paged cache needs page_size % 4 == 0")
            pool = (L, pool_pages, Hkv, page_size // 4, D)
            return KVCache(
                k=jnp.zeros(pool, jnp.int32), v=jnp.zeros(pool, jnp.int32),
                lengths=jnp.zeros((batch,), jnp.int32),
                k_scale=jnp.zeros(
                    (L, pool_pages, 4, Hkv, page_size // 4), jnp.bfloat16
                ),
                v_scale=jnp.zeros(
                    (L, pool_pages, 4, Hkv, page_size // 4), jnp.bfloat16
                ),
                page_table=table,
            )
        pool = (L, pool_pages, Hkv, page_size, D)
        return KVCache(
            k=jnp.zeros(pool, dtype), v=jnp.zeros(pool, dtype),
            lengths=jnp.zeros((batch,), jnp.int32),
            page_table=table,
        )


# --- runtimes: where collectives happen ---


class IndexedQTensor:
    """View of a layer-stacked QTensor at a traced layer index: the fused
    kernel reads that layer's planes in place through an index operand (no
    per-step weight copy — see kernels/qgemv_kernel.py)."""

    def __init__(self, qt: QTensor, layer):
        self.qt = qt
        self.layer = layer


class Runtime:
    """Single-chip execution: linears are plain fused qmatmuls."""

    # set by expert-parallel entry points (models/moe.py): the mesh axis the
    # MoE combine psums over (None = all experts local)
    expert_axis = None

    def col(self, x, w, **kw):
        return _linear(x, w, **kw)

    def row(self, x, w, **kw):
        return _linear(x, w, **kw)

    def logits_gather(self, x):
        return x


class TPRuntime(Runtime):
    """Inside-shard_map execution: column outputs stay sharded, row outputs psum."""

    def __init__(self, axis: str):
        self.axis = axis

    def row(self, x, w, **kw):
        from xbitops.formats import is_row_sharded
        from xbitops.parallel.tp import squeeze_row_shard

        if isinstance(w, IndexedQTensor) and w.qt.planes[0].ndim == 4:
            # stacked row-sharded: drop the (length-1) local shard axis
            # (perm is stacked shard-local [L, 1, Ks] when act-ordered)
            qt = dataclasses.replace(
                w.qt,
                planes=tuple(p[:, 0] for p in w.qt.planes),
                scales=w.qt.scales[:, 0],
                scale_zeros=w.qt.scale_zeros[:, 0],
                perm=None if w.qt.perm is None else w.qt.perm[:, 0],
            )
            w = IndexedQTensor(qt, w.layer)
        if isinstance(w, QTensor) and is_row_sharded(w):
            w = squeeze_row_shard(w)
        # act-order row op executing gathered-column (desc_act o_proj: its
        # runtime perm crosses shard boundaries, so the weight is column-
        # sharded instead — see parallel.tp.qtensor_pspecs): the local x is a
        # K-shard, the matmul needs all of K, and the N-sharded output must
        # replicate.  Two all-gathers ~= the psum they replace in bytes moved.
        w_k = None
        if isinstance(w, QTensor):
            w_k = w.K_logical
        elif isinstance(w, IndexedQTensor):
            w_k = w.qt.K_logical
        if w_k is not None and x.shape[-1] != w_k:
            x = jax.lax.all_gather(x, self.axis, axis=x.ndim - 1, tiled=True)
            out = _linear(x, w, **kw)
            return jax.lax.all_gather(out, self.axis, axis=out.ndim - 1, tiled=True)
        return jax.lax.psum(_linear(x, w, **kw), self.axis)

    def logits_gather(self, x):
        return jax.lax.all_gather(x, self.axis, axis=x.ndim - 1, tiled=True)


def _linear(x: jax.Array, w: Any, a8: bool = False, **kw) -> jax.Array:
    if isinstance(w, IndexedQTensor):
        return qmatmul(x, w.qt, out_dtype=x.dtype, layer=w.layer, a8=a8, **kw)
    if isinstance(w, QTensor):
        return qmatmul(x, w, out_dtype=x.dtype, a8=a8, **kw)
    # dense (bf16) weights have no int8 path — a8 is a no-op for them
    return jnp.dot(x, w.astype(x.dtype), preferred_element_type=jnp.float32).astype(x.dtype)


# --- building blocks ---


def rms_norm(x: jax.Array, w: jax.Array, eps: float) -> jax.Array:
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return (xf * jax.lax.rsqrt(var + eps) * w).astype(x.dtype)


def _rope(
    x: jax.Array,
    positions: jax.Array,
    theta: float,
    scaling_type: Optional[str] = None,
    scaling_factor: float = 1.0,
) -> jax.Array:
    """Rotate-half RoPE (HF Llama convention). x: [..., T, heads, head_dim].

    ``scaling_type``: "linear" = position interpolation (positions / factor);
    "ntk" = NTK-aware base stretch theta * factor^(d/(d-2)) — both extend a
    model trained at a shorter context to ``factor`` times the length."""
    hd = x.shape[-1]
    pos = positions.astype(jnp.float32)
    if scaling_type == "linear":
        pos = pos / float(scaling_factor)
    elif scaling_type == "ntk":
        theta = theta * float(scaling_factor) ** (hd / (hd - 2))
    elif scaling_type is not None:
        raise ValueError(f"unknown rope scaling type {scaling_type!r}")
    freqs = theta ** (-jnp.arange(0, hd // 2, dtype=jnp.float32) / (hd // 2))
    ang = pos[..., :, None] * freqs[None, :]  # [..., T, hd/2]
    cos = jnp.cos(ang)[..., None, :]  # [..., T, 1, hd/2]
    sin = jnp.sin(ang)[..., None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
    xf1, xf2 = x1.astype(jnp.float32), x2.astype(jnp.float32)
    return jnp.concatenate(
        [xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], axis=-1
    ).astype(x.dtype)


def _attention(q, kT, vT, mask, scale):
    """q: [B, Tq, H, D]; kT/vT: HEAD-MAJOR [B, Hkv, Tk, D]; mask: [B, Tq, Tk]
    bool.  (The cache is stored head-major; fresh per-block k/v transpose
    their small [B, T, Hkv, D] projections before calling — O(B·T·h) only.)"""
    B, Tq, H, D = q.shape
    Hkv = kT.shape[1]
    rep = H // Hkv
    if rep > 1:
        kT = jnp.repeat(kT, rep, axis=1)
        vT = jnp.repeat(vT, rep, axis=1)
    logits = jnp.einsum(
        "bqhd,bhkd->bhqk", q.astype(jnp.float32), kT.astype(jnp.float32)
    )
    logits = logits * scale + jnp.where(mask[:, None], 0.0, -1e30)
    p = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("bhqk,bhkd->bqhd", p, vT.astype(jnp.float32))
    return out.astype(q.dtype)


# Shortest chunk routed to the prefill-attention kernel; shorter T>1 blocks
# (spec verify, small buckets) attend through the plain path.
FLASH_PREFILL_MIN_T = 128


def _attention_kernel_ok(cfg: LlamaConfig) -> bool:
    """The attention kernel takes power-of-two head dims of 16 or more."""
    D = cfg.head_dim
    return cfg.flash_decode and D >= 16 and D & (D - 1) == 0


def _quant_kv(x):
    """Per-(token, head) absmax int8 quantization of a [B, T, H, D] tensor.
    Values return BIASED (+128, range 1..255) as int32 — the storage
    convention of the packed cache."""
    xf = x.astype(jnp.float32)
    s = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1), 1e-8) / 127.0
    q = jnp.clip(jnp.round(xf / s[..., None]), -127, 127).astype(jnp.int32)
    return q + 128, s


def _pack_kv_words(q):
    """[B, T, H, D] biased byte values -> head-major words [B, H, T/4, D]
    (byte j of word w = position 4w+j)."""
    B, T, H, D = q.shape
    qT = jnp.swapaxes(q & 255, 1, 2)  # (B, H, T, D)
    qb = qT.reshape(B, H, T // 4, 4, D)
    return (
        qb[..., 0, :] | (qb[..., 1, :] << 8)
        | (qb[..., 2, :] << 16) | (qb[..., 3, :] << 24)
    )


def _pack_kv_scales(s):
    """[B, T, H] per-position scales -> [B, 4, H, T/4] (sc[b, j, h, w] =
    s[b, 4w+j, h]; S/4-minor layout, see KVCache)."""
    B, T, H = s.shape
    sb = s.reshape(B, T // 4, 4, H)  # [b, w, j, h]
    return jnp.transpose(sb, (0, 2, 3, 1))


def _unpack_kv_words(words, scales):
    """[..., H, W, D] packed biased words + [..., 4, H, W] scales ->
    dequantized head-major [..., H, 4W, D] f32 (plain path; the attention
    kernel unpacks blocks in registers instead)."""
    parts = [
        ((jax.lax.shift_right_logical(words, 8 * j) & 255) - 128)
        for j in range(4)
    ]
    q = jnp.stack(parts, axis=-2)  # [..., H, W, 4, D]
    sc = jnp.moveaxis(scales, -3, -1)  # [..., H, W, 4]
    deq = q.astype(jnp.float32) * sc.astype(jnp.float32)[..., None]
    return deq.reshape(*words.shape[:-2], -1, words.shape[-1])


def _paged_word(page_table, b_rows, pos, pool):
    """Map virtual positions (B,) or (B, W) to (pool page, word-in-page) for
    the packed int8 paged pool ``[L, n_pages, Hkv, psz/4, D]``.  Unallocated
    (-1) / past-capacity positions return a POSITIVE out-of-range page so
    ``mode="drop"`` discards them (negative indices would wrap)."""
    psz = pool.shape[3] * 4
    P = page_table.shape[1]
    n_pages = pool.shape[1]
    tbl_rows = page_table[b_rows]  # (B, P)
    pos2 = pos if pos.ndim == 2 else pos[:, None]
    pageidx = pos2 // psz
    page = jnp.take_along_axis(tbl_rows, jnp.minimum(pageidx, P - 1), axis=1)
    page = jnp.where((pageidx < P) & (page >= 0), page, n_pages)
    wip = (pos2 % psz) // 4
    if pos.ndim == 1:
        return page[:, 0], wip[:, 0]
    return page, wip


def write_kv(kv, k, v, positions, li, b_rows, page_table=None,
             kv_unaligned=False):
    """Write new k/v ``[B, T, Hkv, D]`` into layer ``li`` of the stacked
    caches ``kv = (k_all, v_all, k_scale_all, v_scale_all)`` at
    ``positions [B, T]`` of cache rows ``b_rows [B]``; returns the updated
    tuple.  Writes are scatters and slab updates on the loop-carried (or
    donated) buffers, so XLA performs them in place.  JAX drops
    out-of-bounds updates, so positions >= S (padding / inactive slots)
    write nothing — the engine relies on this for ragged batches."""
    k_all, v_all, ks_all, vs_all = kv
    B, T = positions.shape
    D = k.shape[-1]
    paged = page_table is not None
    Hkv_l = k.shape[2]
    h_idx = jnp.arange(Hkv_l)[None, :, None]  # (1, Hkv, 1)
    b_idx3 = b_rows[:, None, None]  # (B, 1, 1)
    if ks_all is not None:  # int8 cache, packed words + biased bytes
        kq, ks = _quant_kv(k)  # kq (B, T, Hkv, D) biased; ks (B, T, Hkv)
        vq, vs = _quant_kv(v)
        if T == 1 or kv_unaligned:
            # decode / unaligned small writes (speculative verify starts at
            # an arbitrary length): read-modify-write one byte per position,
            # scattered in place into the loop-carried cache.  T is static
            # and small — the loop unrolls.  Works against paged pools too
            # (the page lookup replaces the slot index).
            for t in range(T):
                pos_t = positions[:, t]  # (B,)
                if paged:
                    tgt_b, w_col = _paged_word(
                        page_table, b_rows, pos_t, k_all
                    )
                else:
                    Sw = k_all.shape[3]
                    tgt_b = jnp.where(pos_t < Sw * 4, b_rows, k_all.shape[1])
                    w_col = pos_t // 4
                byte = (pos_t % 4)[:, None, None]  # (B, 1, 1)
                sh = (byte * 8)[..., None]  # (B, 1, 1, 1)
                keep = ~(255 << sh)
                t_idx = (li, tgt_b[:, None, None], h_idx, w_col[:, None, None])
                kq_t = kq[:, t][:, :, None, :]  # (B, Hkv, 1, D)
                vq_t = vq[:, t][:, :, None, :]
                oldk = k_all.at[t_idx].get(mode="fill", fill_value=0)
                oldv = v_all.at[t_idx].get(mode="fill", fill_value=0)
                k_all = k_all.at[t_idx].set(
                    (oldk & keep) | ((kq_t & 255) << sh), mode="drop"
                )
                v_all = v_all.at[t_idx].set(
                    (oldv & keep) | ((vq_t & 255) << sh), mode="drop"
                )
                s_idx = (li, tgt_b[:, None, None], byte, h_idx,
                         w_col[:, None, None])
                ks_all = ks_all.at[s_idx].set(
                    ks[:, t][:, :, None].astype(ks_all.dtype), mode="drop"
                )
                vs_all = vs_all.at[s_idx].set(
                    vs[:, t][:, :, None].astype(vs_all.dtype), mode="drop"
                )
        else:
            # prefill: whole words (positions are 4-aligned contiguous runs —
            # engine chunk/bucket sizes are multiples of 4; trailing pads sit
            # past each row's length and are masked by attention)
            assert T % 4 == 0, "int8 KV prefill needs T % 4 == 0"
            if paged:
                # per-word page lookup (words never straddle pages:
                # page_size % 4 == 0 enforced at init)
                first, w_idx0 = _paged_word(
                    page_table, b_rows, positions[:, 0::4], k_all
                )
                w_idx = w_idx0[:, None, :]  # (B, 1, T/4)
                f_idx = first[:, None, :]
                k_all = k_all.at[li, f_idx, h_idx, w_idx].set(
                    _pack_kv_words(kq), mode="drop"
                )
                v_all = v_all.at[li, f_idx, h_idx, w_idx].set(
                    _pack_kv_words(vq), mode="drop"
                )
                f_idx4 = first[:, None, None, :]
                j_idx = jnp.arange(4)[None, :, None, None]
                h_idx4 = jnp.arange(Hkv_l)[None, None, :, None]
                w_idx4 = w_idx0[:, None, None, :]
                ks_all = ks_all.at[li, f_idx4, j_idx, h_idx4, w_idx4].set(
                    _pack_kv_scales(ks).astype(ks_all.dtype), mode="drop"
                )
                vs_all = vs_all.at[li, f_idx4, j_idx, h_idx4, w_idx4].set(
                    _pack_kv_scales(vs).astype(vs_all.dtype), mode="drop"
                )
            else:
                # Each row's valid positions are a contiguous 4-aligned run
                # from positions[:, 0] (prefix property of chunk/bucket
                # admission), so the write is a per-slot
                # dynamic_update_slice of a dense (Hkv, T/4, D) slab.
                # Invalid rows (inert slots / exhausted prompts) write back
                # what they read; garbage words past a row's true length are
                # never attended (length-bounded masks) and are overwritten
                # by later appends.
                kw = _pack_kv_words(kq)  # (B, Hkv, T/4, D)
                vw = _pack_kv_words(vq)
                kss = _pack_kv_scales(ks).astype(ks_all.dtype)  # (B,4,Hkv,T/4)
                vss = _pack_kv_scales(vs).astype(vs_all.dtype)
                Sw = k_all.shape[3]
                B_cache = k_all.shape[1]
                tw = T // 4
                li_i = jnp.asarray(li, jnp.int32)
                zero = jnp.int32(0)
                for b in range(B):
                    tgt = jnp.clip(b_rows[b], 0, B_cache - 1).astype(jnp.int32)
                    p0 = positions[b, 0]
                    # the run must fit the allocation whole (engine chunk /
                    # bucket sizes always do); otherwise write nothing
                    ok = (b_rows[b] < B_cache) & (p0 // 4 + tw <= Sw)
                    w0 = jnp.clip(p0 // 4, 0, Sw - tw).astype(jnp.int32)
                    kv_at = (li_i, tgt, zero, w0, zero)
                    sc_at = (li_i, tgt, zero, zero, w0)

                    def dus(arr, new, at):
                        old = jax.lax.dynamic_slice(arr, at, new.shape)
                        return jax.lax.dynamic_update_slice(
                            arr, jnp.where(ok, new, old), at
                        )

                    k_all = dus(k_all, kw[b][None, None], kv_at)
                    v_all = dus(v_all, vw[b][None, None], kv_at)
                    ks_all = dus(ks_all, kss[b][None, None], sc_at)
                    vs_all = dus(vs_all, vss[b][None, None], sc_at)
    elif page_table is not None:
        # paged pool: virtual position -> (pool page via table, in-page row).
        # Unallocated (-1) / past-capacity positions redirect to a POSITIVE
        # out-of-bounds page so mode="drop" discards them (a negative index
        # would wrap to the last pool page, like numpy indexing).
        psz = k_all.shape[3]
        P = page_table.shape[1]
        n_pages = k_all.shape[1]
        tbl_rows = page_table[b_rows]  # (B, P)
        pageidx = positions // psz
        page = jnp.take_along_axis(
            tbl_rows, jnp.minimum(pageidx, P - 1), axis=1
        )
        page = jnp.where((pageidx < P) & (page >= 0), page, n_pages)
        row = positions % psz
        kT = jnp.swapaxes(k, 1, 2)  # (B, Hkv, T, D)
        vT = jnp.swapaxes(v, 1, 2)
        p_idx = (li, page[:, None, :], h_idx, row[:, None, :])
        k_all = k_all.at[p_idx].set(kT.astype(k_all.dtype), mode="drop")
        v_all = v_all.at[p_idx].set(vT.astype(v_all.dtype), mode="drop")
    else:
        kT = jnp.swapaxes(k, 1, 2).astype(k_all.dtype)  # (B, Hkv, T, D)
        vT = jnp.swapaxes(v, 1, 2).astype(v_all.dtype)
        if T == 1 or kv_unaligned:
            # decode: one in-place scatter of the (Hkv, 1, D) rows into the
            # loop-carried cache.  Speculative verify may straddle the
            # capacity edge (a chain starting near S legitimately drops only
            # its tail rows): the scatter's mode="drop" is per element.
            d_idx = (li, b_idx3, h_idx, positions[:, None, :])
            k_all = k_all.at[d_idx].set(kT, mode="drop")
            v_all = v_all.at[d_idx].set(vT, mode="drop")
        else:
            # every other caller's valid positions are a contiguous run from
            # positions[:, 0] that fits the allocation whole (prefix
            # property: prefill from 0, chunks from start), so write
            # per-slot dense (Hkv, T, D) slabs with dynamic_update_slice.
            S_rows = k_all.shape[3]
            B_cache = k_all.shape[1]
            li_i = jnp.asarray(li, jnp.int32)
            zero = jnp.int32(0)
            for b in range(B):
                tgt = jnp.clip(b_rows[b], 0, B_cache - 1).astype(jnp.int32)
                p0 = positions[b, 0]
                ok = (b_rows[b] < B_cache) & (p0 + T <= S_rows)
                r0 = jnp.clip(p0, 0, S_rows - T).astype(jnp.int32)
                at = (li_i, tgt, zero, r0, zero)
                oldk = jax.lax.dynamic_slice(k_all, at, (1, 1, Hkv_l, T, D))
                oldv = jax.lax.dynamic_slice(v_all, at, (1, 1, Hkv_l, T, D))
                k_all = jax.lax.dynamic_update_slice(
                    k_all, jnp.where(ok, kT[b][None, None], oldk), at
                )
                v_all = jax.lax.dynamic_update_slice(
                    v_all, jnp.where(ok, vT[b][None, None], oldv), at
                )

    return k_all, v_all, ks_all, vs_all


def _block(
    layer, cfg: LlamaConfig, rt: Runtime, x, positions, kv, li, mask,
    slot_ids=None, self_attend=False, kv_unaligned=False, page_table=None,
):
    """One transformer block on [B, T, h_local-agnostic].

    ``kv = (k_all, v_all, k_scale_all, v_scale_all)`` are the FULL stacked
    head-major caches ``[L, B, Hkv, S, D]`` (see :class:`KVCache` for the
    packed int8 / paged shapes); new k/v scatter directly into layer ``li``
    of them (a sparse in-place update on the loop-carried buffers — never a
    per-layer slice + restack, which would double cache memory and rewrite
    it every step).

    ``slot_ids`` maps x's batch rows to cache slots (default: identity).  With
    ``self_attend`` the attention context is the block's own k/v (a fresh
    request prefilling — nothing older exists in its slot) while the cache is
    still updated, so a single request can prefill into a shared batched cache
    without reading the other slots.
    """
    B, T, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qdim, kvdim = H * D, Hkv * D
    # T is static under jit: prefill blocks (large T, compute-bound) may take
    # the int8-activation path; decode (T == 1) never does.
    a8 = bool(cfg.prefill_a8) and T >= 32

    hx = rms_norm(x, layer["ln_attn"], cfg.rms_eps)
    if "wqkv" in layer:  # fused projection: one packed matmul for q|k|v
        qkv = rt.col(hx, layer["wqkv"], a8=a8)
        q = qkv[..., :qdim].reshape(B, T, H, D)
        k = qkv[..., qdim : qdim + kvdim].reshape(B, T, Hkv, D)
        v = qkv[..., qdim + kvdim :].reshape(B, T, Hkv, D)
    else:
        q = rt.col(hx, layer["wq"], a8=a8).reshape(B, T, H, D)
        k = rt.col(hx, layer["wk"], a8=a8).reshape(B, T, Hkv, D)
        v = rt.col(hx, layer["wv"], a8=a8).reshape(B, T, Hkv, D)
    q = _rope(q, positions, cfg.rope_theta, cfg.rope_scaling_type,
              cfg.rope_scaling_factor)
    k = _rope(k, positions, cfg.rope_theta, cfg.rope_scaling_type,
              cfg.rope_scaling_factor)

    # new k/v land in the cache first; attention then reads them from it
    b_rows = slot_ids if slot_ids is not None else jnp.arange(B)
    k_all, v_all, ks_all, vs_all = write_kv(
        kv, k, v, positions, li, b_rows, page_table, kv_unaligned)

    def ctx(rows):
        """Head-major attention context [n, Hkv, S, D] for cache rows of
        layer li (all or a subset)."""
        kc, vc = k_all[li], v_all[li]
        quant = ks_all is not None
        if page_table is not None:
            # gather each row's pages into a virtually-contiguous context;
            # unallocated (-1 -> clamped) pages read garbage that the causal
            # mask excludes (those positions are past the slot's length)
            tbl = page_table if rows is None else page_table[rows]
            safe = jnp.maximum(tbl, 0)
            n, P = safe.shape
            # pool [n_pages, Hkv, psz(/4), D] -> [n, Hkv, P*psz(/4), D]
            kg = jnp.moveaxis(kc[safe], 1, 2).reshape(
                n, kc.shape[1], -1, kc.shape[3]
            )
            vg = jnp.moveaxis(vc[safe], 1, 2).reshape(
                n, vc.shape[1], -1, vc.shape[3]
            )
            if not quant:
                return kg, vg
            # scale pools [n_pages, 4, Hkv, psz/4] -> [n, 4, Hkv, P*psz/4]
            ksg = jnp.moveaxis(ks_all[li][safe], 1, 3).reshape(
                n, 4, kc.shape[1], -1
            )
            vsg = jnp.moveaxis(vs_all[li][safe], 1, 3).reshape(
                n, 4, vc.shape[1], -1
            )
            return _unpack_kv_words(kg, ksg), _unpack_kv_words(vg, vsg)
        if rows is not None:
            kc, vc = kc[rows], vc[rows]
        if not quant:
            return kc, vc
        ksc, vsc = ks_all[li], vs_all[li]
        if rows is not None:
            ksc, vsc = ksc[rows], vsc[rows]
        return _unpack_kv_words(kc, ksc), _unpack_kv_words(vc, vsc)

    pack = 4 if ks_all is not None else 1
    if page_table is not None:
        S_cap = page_table.shape[1] * k_all.shape[3] * pack
    else:
        S_cap = k_all.shape[3] * pack
    kernel_ok = _attention_kernel_ok(cfg)
    # T > 1 against the cache (chunked prefill / full prefill): the kernel
    # reads only each query tile's visible blocks, where ctx() reads the
    # slots' whole allocation and — packed int8 — dequantizes all of it.
    flash_prefill = (
        T >= FLASH_PREFILL_MIN_T and not self_attend and not kv_unaligned
        and page_table is None and kernel_ok
    )
    if self_attend:
        att = _attention(
            q, jnp.swapaxes(k, 1, 2), jnp.swapaxes(v, 1, 2), mask, D ** -0.5
        )
    elif flash_prefill:
        from xbitops.kernels.attention import prefill_attention

        att = prefill_attention(
            q, k_all, v_all, positions, b_rows, layer_idx=li,
            k_scale=ks_all, v_scale=vs_all, window=cfg.sliding_window,
        )
    elif slot_ids is not None:
        # x's batch rows map to a subset of cache slots: attend those slots
        att = _attention(q, *ctx(slot_ids), mask, D ** -0.5)
    elif T == 1 and kernel_ok and (
        ks_all is None or page_table is None
        or S_cap // page_table.shape[1] >= 64
    ):
        # decode: the kernel reads layer li of the stacked cache in place;
        # its reads follow live lengths, not the allocation (int8 pages need
        # 64 positions: a block is 16 words of 4)
        from xbitops.kernels.attention import decode_attention

        att = decode_attention(
            q[:, 0], k_all, v_all, jnp.minimum(positions[:, 0] + 1, S_cap),
            layer_idx=li, window=cfg.sliding_window,
            k_scale=ks_all, v_scale=vs_all, page_table=page_table,
        )[:, None]
    else:
        att = _attention(q, *ctx(None), mask, D ** -0.5)
    x = x + rt.row(att.reshape(B, T, H * D), layer["wo"], a8=a8)

    hx = rms_norm(x, layer["ln_mlp"], cfg.rms_eps)
    if "router" in layer:  # sparse MoE FFN (models/moe.py)
        from xbitops.models import moe

        x = x + moe.moe_ffn(
            hx, layer, cfg,
            expert_axis=getattr(rt, "expert_axis", None), a8=a8,
        )
        return x, (k_all, v_all, ks_all, vs_all)
    if "w_gateup" in layer:  # fused projection: one packed matmul for gate|up
        gu = rt.col(hx, layer["w_gateup"], a8=a8)
        gate, up = gu[..., : cfg.intermediate_size], gu[..., cfg.intermediate_size :]
    else:
        gate = rt.col(hx, layer["w_gate"], a8=a8)
        up = rt.col(hx, layer["w_up"], a8=a8)
    act = (jax.nn.silu(gate.astype(jnp.float32)) * up.astype(jnp.float32)).astype(x.dtype)
    x = x + rt.row(act, layer["w_down"], a8=a8)
    return x, (k_all, v_all, ks_all, vs_all)


def forward(
    params: dict,
    cfg: LlamaConfig,
    tokens: jax.Array,  # int32 [B, T]
    cache: KVCache,
    positions: jax.Array,  # int32 [B, T] absolute positions of `tokens`
    rt: Optional[Runtime] = None,
    slot_ids: Optional[jax.Array] = None,  # int32 [B] cache slots for x's rows
    self_attend: bool = False,
    kv_unaligned: bool = False,
    logits_rows: Optional[jax.Array] = None,  # int32 [B]: only these positions' logits
) -> Tuple[jax.Array, KVCache]:
    """Run T tokens per slot through the model (T=1 -> decode; T>1 -> prefill).

    Assumes cache slots were written for positions < lengths; attends to cached
    positions plus causally to the new tokens.  Positions >= S mark padding /
    inactive tokens: they write nothing to the cache and advance no lengths.

    ``kv_unaligned``: this T > 1 call's positions may start off a 4-position
    word boundary (speculative verify) — a packed int8 cache then writes
    per-position bytes instead of whole words.

    ``logits_rows`` (prefill-admission fast path): per batch row, the single
    position whose logits the caller will read — lm_head then runs on [B, 1]
    instead of [B, T] (a C=512 chunk at 7B shapes otherwise spends ~4.3
    TFLOP and a 262 MB logits write on rows nobody reads) and the returned
    logits are [B, 1, V].
    """
    rt = rt or Runtime()
    B, T = tokens.shape
    x = params["embed"][tokens].astype(jnp.bfloat16)

    S = cache.S
    if self_attend:
        # mask[b, q, t]: block token t visible to query q (causal, non-pad)
        mask = (positions[:, None, :] <= positions[:, :, None]) & (
            positions[:, None, :] < S
        )
        if cfg.sliding_window is not None:
            # sliding window: query p attends keys in (p - W, p]
            mask &= (
                positions[:, :, None] - positions[:, None, :]
                < cfg.sliding_window
            )
    else:
        # mask[b, q, s]: cache position s visible to query q (s <= positions[b, q])
        s_idx = jnp.arange(S)[None, None, :]
        mask = s_idx <= positions[:, :, None]
        if cfg.sliding_window is not None:
            mask &= positions[:, :, None] - s_idx < cfg.sliding_window

    layers = params["layers"]
    kv = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    page_table = cache.page_table
    if isinstance(layers, (list, tuple)):
        for li, layer in enumerate(layers):
            x, kv = _block(
                layer, cfg, rt, x, positions, kv, li, mask,
                slot_ids=slot_ids, self_attend=self_attend,
                kv_unaligned=kv_unaligned, page_table=page_table,
            )
    else:
        # stacked layers (see stack_layers): one compiled block, scanned —
        # compile time and program size stay O(1) in depth.  QTensors are NOT
        # scanned over (a scan slice feeding a Pallas call would copy the
        # weights every step); the fused kernel reads layer `li` in place via
        # an index operand (IndexedQTensor).  The caches ride the scan CARRY
        # and receive sparse scatters — in place on the carried buffers.
        qt_stacked = {k: v for k, v in layers.items() if isinstance(v, QTensor)}
        others = {k: v for k, v in layers.items() if not isinstance(v, QTensor)}
        L = cache.k.shape[0]

        def body(carry, xs):
            x, kv = carry
            li, other = xs
            layer = dict(other)
            for key, qtv in qt_stacked.items():
                layer[key] = IndexedQTensor(qtv, li)
            x, kv = _block(
                layer, cfg, rt, x, positions, kv, li, mask,
                slot_ids=slot_ids, self_attend=self_attend,
                kv_unaligned=kv_unaligned, page_table=page_table,
            )
            return (x, kv), None

        (x, kv), _ = jax.lax.scan(body, (x, kv), (jnp.arange(L), others))
    new_k, new_v, new_ks, new_vs = kv

    x = rms_norm(x, params["ln_final"], cfg.rms_eps)
    if logits_rows is not None:
        x = jnp.take_along_axis(
            x, logits_rows.astype(jnp.int32)[:, None, None], axis=1
        )  # [B, 1, h]
    logits = _linear(x, params["lm_head"])
    logits = rt.logits_gather(logits)
    # Positions >= S mark padding/inactive tokens; they advance nothing.
    valid_next = jnp.where(positions < S, positions + 1, 0)
    rows = slot_ids if slot_ids is not None else jnp.arange(B)
    new_cache = KVCache(
        k=new_k, v=new_v,
        lengths=cache.lengths.at[rows].max(jnp.max(valid_next, axis=1)),
        k_scale=new_ks, v_scale=new_vs, page_table=page_table,
    )
    return logits, new_cache


def stack_layers(params: dict, consume: bool = False) -> dict:
    """Stack the per-layer param list into one pytree with a leading layer
    axis, switching ``forward`` to a ``lax.scan`` over layers (O(1) compile
    time in depth; the fused kernel reads layer planes IN PLACE through an
    index operand, so stacked runs at full speed).  Requires
    every layer to have identical structure (true unless act-order fusion
    was skipped for some layers only).

    ``consume=True`` frees each per-layer buffer as soon as its stacked
    column is built (and CLEARS the input's layer dicts): peak device memory
    is one model + one layer instead of two models."""
    layers = params["layers"]
    if not isinstance(layers, (list, tuple)):
        return params
    if any("router" in layer for layer in layers):
        # MoE expert QTensors already carry their (expert) stacking axis; a
        # second layer axis would break the in-place expert indexing — MoE
        # models run unrolled (the engine's try/except falls back to the list)
        raise ValueError("MoE layers run unrolled; stack_layers unsupported")
    if not consume:
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *layers)
        return dict(params, layers=stacked)
    flat = [jax.tree_util.tree_flatten(layer) for layer in layers]
    treedef = flat[0][1]
    if any(f[1] != treedef for f in flat[1:]):
        raise ValueError("stack_layers: layers differ in structure")
    cols = [f[0] for f in flat]
    for layer in layers:
        layer.clear()  # drop the dict -> leaf references (consume semantics)
    n_leaves = len(cols[0])
    stacked_leaves = []
    for j in range(n_leaves):
        stacked_leaves.append(jnp.stack([c[j] for c in cols]))
        for c in cols:
            c[j] = None  # free layer j's buffer before stacking leaf j+1
    stacked = jax.tree_util.tree_unflatten(treedef, stacked_leaves)
    return dict(params, layers=stacked)


def decode_step(params, cfg, tokens, cache, rt=None, active=None):
    """One decode step: tokens int32 [B] at positions cache.lengths.

    ``active`` (bool [B]) masks slots: inactive slots compute but write nothing
    and advance nothing (continuous batching with static shapes).
    """
    positions = cache.lengths[:, None]
    if active is not None:
        positions = jnp.where(active[:, None], positions, cache.S)
    logits, cache = forward(params, cfg, tokens[:, None], cache, positions, rt)
    return logits[:, -1, :], cache


def spec_verify_step(params, cfg, tokens, cache, rt=None, active=None):
    """Speculative-decoding verify: run ``tokens[:, 0]`` (each slot's current
    token) plus ``gamma = T-1`` drafted tokens through ONE forward, accept the
    longest prefix the model agrees with (greedy), and roll the cache back to
    the accepted length.

    Decode is weight-bound (the whole packed model streams per step
    regardless of T), so verifying gamma+1 tokens costs about one decode
    step on the weight stream; accepted draft tokens amortize it.  Caveat:
    the T=gamma+1 verify path rounds differently from the T=1 decode path
    in bf16, so argmax can flip on near-ties — exact in equal-precision
    arithmetic, bit-identical on the tiny test model, tie-flips possible on
    near-uniform logits.  No reference counterpart — serving-layer feature.

    Returns ``(greedy [B, T], accepted [B], cache)``: slot b emitted
    ``tokens[b, 1 : 1+accepted[b]]`` (the accepted drafts) followed by
    ``greedy[b, accepted[b]]`` (the model's own next token) — i.e.
    ``accepted[b] + 1`` tokens.  Stale cache entries past the rollback are
    overwritten by later writes and masked by lengths meanwhile.
    """
    B, T = tokens.shape
    S = cache.S
    old_lens = cache.lengths
    positions = old_lens[:, None] + jnp.arange(T)[None]
    if active is not None:
        positions = jnp.where(active[:, None], positions, S)
    positions = jnp.minimum(positions, S)  # past-capacity drafts are inert
    logits, cache = forward(
        params, cfg, tokens, cache, positions, rt, kv_unaligned=True
    )
    greedy = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    # accepted prefix: drafts tokens[:, 1:] vs the model's greedy continuation
    match = (greedy[:, :-1] == tokens[:, 1:]).astype(jnp.int32)
    accepted = jnp.sum(jnp.cumprod(match, axis=1), axis=1)  # [B] in [0, T-1]
    # cap emissions at remaining capacity, then roll lengths back to the
    # accepted point (forward advanced them by up to T)
    emit = jnp.minimum(accepted + 1, jnp.maximum(S - old_lens, 0))
    new_lens = old_lens + emit
    if active is not None:
        new_lens = jnp.where(active, new_lens, old_lens)
    cache = dataclasses.replace(cache, lengths=new_lens.astype(jnp.int32))
    return greedy, accepted, cache


def prefill_slot(params, cfg, tokens, true_len, slot, cache, rt=None):
    """Prefill ONE request into cache slot ``slot``; returns last-token logits.

    ``tokens`` is int32 [T] zero-padded past ``true_len`` (T is the engine's
    static bucket size).  Attention is self-contained — a fresh request has
    nothing in its slot — so no other slot's cache is read, and pad tokens
    (position set to S) neither write cache nor advance the slot length.
    """
    T = tokens.shape[0]
    S = cache.S
    pos = jnp.arange(T)
    positions = jnp.where(pos < true_len, pos, S)[None]
    logits, cache = forward(
        params, cfg, tokens[None], cache, positions, rt,
        slot_ids=jnp.full((1,), slot, jnp.int32), self_attend=True,
        logits_rows=jnp.maximum(true_len - 1, 0)[None],
    )
    # Reset the slot's length outright (forward's scatter-max would keep a
    # longer stale length from a previous occupant of this slot).
    cache = dataclasses.replace(
        cache, lengths=cache.lengths.at[slot].set(true_len)
    )
    return logits[0, 0], cache


def prefill_slots(params, cfg, tokens, true_lens, slots, cache, rt=None):
    """Batched :func:`prefill_slot`: n requests into n cache slots in ONE
    forward (continuous-batching admission without per-request dispatches).

    ``tokens`` int32 [n, T] zero-padded, ``true_lens``/``slots`` int32 [n].
    Rows with ``true_len == 0`` are inert padding — point their slot out of
    range (e.g. n_slots) and the scatters drop them.  Returns last-token
    logits [n, V] and the updated cache.
    """
    n, T = tokens.shape
    S = cache.S
    pos = jnp.arange(T)[None]
    positions = jnp.where(pos < true_lens[:, None], pos, S)
    logits, cache = forward(
        params, cfg, tokens, cache, positions, rt,
        slot_ids=slots.astype(jnp.int32), self_attend=True,
        logits_rows=jnp.maximum(true_lens - 1, 0),
    )
    # Reset each slot's length outright (a recycled slot may carry a longer
    # stale length); out-of-range dummy slots drop.
    cache = dataclasses.replace(
        cache,
        lengths=cache.lengths.at[slots].set(true_lens.astype(jnp.int32), mode="drop"),
    )
    return logits[:, 0], cache


def prefill_slot_chunk(
    params, cfg, tokens, start, true_len, slot, cache, rt=None, reset=False
):
    """One chunk of a long prefill into slot ``slot``: tokens [C] are prompt
    positions ``[start, start+C)`` (pads past ``true_len`` masked out).

    Unlike :func:`prefill_slot`, attention reads the slot's cache (earlier
    chunks) plus the chunk itself — attention memory is O(C * S), not O(T^2),
    so arbitrarily long prompts prefill in fixed-size pieces.  ``reset=True``
    on the first chunk clears a recycled slot's stale length.

    Returns the logits row for the prompt's last token (meaningful once the
    final chunk ran; garbage before) and the updated cache.
    """
    C = tokens.shape[0]
    S = cache.S
    pos = start + jnp.arange(C)
    positions = jnp.where(pos < true_len, pos, S)[None]
    # reset may be traced (one compiled program for first/later chunks)
    slot_len = jnp.where(jnp.asarray(reset), 0, cache.lengths[slot])
    cache = dataclasses.replace(cache, lengths=cache.lengths.at[slot].set(slot_len))
    last_in_chunk = jnp.clip(true_len - 1 - start, 0, C - 1)
    logits, cache = forward(
        params, cfg, tokens[None], cache, positions, rt,
        slot_ids=jnp.full((1,), slot, jnp.int32),
        logits_rows=jnp.asarray(last_in_chunk)[None],
    )
    return logits[0, 0], cache


def prefill_slots_chunk(
    params, cfg, tokens, starts, true_lens, slots, cache, rt=None, resets=None
):
    """Batched :func:`prefill_slot_chunk`: one chunk for each of n long
    prompts in ONE forward (the chunked-admission analog of
    :func:`prefill_slots` — long prompts no longer pay a host dispatch per
    request per chunk).

    ``tokens`` int32 [n, C]; ``starts``/``true_lens``/``slots`` int32 [n];
    ``resets`` bool [n] clears a recycled slot's stale length (first chunk).
    Rows whose prompt is exhausted (or padding rows) are inert: pass
    ``true_len = 0`` and an out-of-range slot.  Returns logits rows [n, V]
    for each prompt's last token (meaningful once that row's final chunk ran).
    """
    n, C = tokens.shape
    S = cache.S
    pos = starts[:, None] + jnp.arange(C)[None]
    positions = jnp.where(pos < true_lens[:, None], pos, S)
    if resets is not None:
        keep = jnp.where(resets, 0, cache.lengths.at[slots].get(mode="fill", fill_value=0))
        cache = dataclasses.replace(
            cache, lengths=cache.lengths.at[slots].set(keep, mode="drop")
        )
    last_in_chunk = jnp.clip(true_lens - 1 - starts, 0, C - 1)
    logits, cache = forward(
        params, cfg, tokens, cache, positions, rt,
        slot_ids=slots.astype(jnp.int32), logits_rows=last_in_chunk,
    )
    return logits[:, 0], cache


def prefill(params, cfg, tokens, cache, rt=None):
    """Prefill a [B, T] prompt (all slots same length; use engine/ for ragged)."""
    B, T = tokens.shape
    positions = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    return forward(params, cfg, tokens, cache, positions, rt)
