"""Length-aware attention against the KV cache, Pallas through Triton.

The plain path (``models.llama`` ``ctx()``) attends over each slot's whole
cache allocation — masking hides dead positions from the softmax but not from
device memory — and on the packed int8 cache first dequantizes all of it to
f32.  This kernel reads only the blocks that hold visible positions and
dequantizes int8 blocks in registers.

One kernel serves decode and chunked prefill.  Its unit of work is a *query
group*: ``R`` query rows that share one cache slot and one kv head, each row
with its own absolute position.  Decode makes one group per slot from the
``rep = H/Hkv`` query heads of a kv head (padded to 16 rows, the smallest
tensor-core tile); prefill makes one group per ``tq``-position query tile.
The grid is (group, kv head, split): each program loads its own visible
range and page ids, loops over its share of the range's blocks with an
online softmax, and — when the range is split across programs
(flash-decoding) — writes unnormalized partials that a second pass combines.

Cache layouts (``models.llama.KVCache``): head-major ``[L, B, Hkv, S, D]``;
packed int8 words ``[L, B, Hkv, S/4, D]`` (byte j of word w = position 4w+j,
biased +128) with scales ``[L, B, 4, Hkv, S/4]``; paged pools replace
``B, S`` by ``n_pages, page_size`` and a page table maps positions to pages.
A block's words decode to positions ``4w+j``; the order of positions inside
a block does not matter to attention as long as the mask and V use it too.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from xbitops.kernels import common

NEG_INF = -1e30
# Aim for this many programs when choosing the decode split: two per SM of a
# 132-SM card.
TARGET_PROGRAMS = 264
BLOCK_S_BF16 = 64
BLOCK_S_INT8 = 128
NUM_WARPS = 4
NUM_STAGES = 2


def _kernel(bs, D, scale, quant, paged, psz, window, n_split, S_rows,
            normalize, *refs):
    refs = list(refs)
    slot_ref, lo_ref, hi_ref, li_ref = refs[:4]
    refs = refs[4:]
    tbl_ref = refs.pop(0) if paged else None
    pos_ref, q_ref, k_ref, v_ref = refs[:4]
    refs = refs[4:]
    ks_ref = vs_ref = None
    if quant:
        ks_ref, vs_ref = refs[:2]
        refs = refs[2:]
    if normalize:
        (o_ref,) = refs
    else:
        o_ref, m_ref, l_ref = refs

    g = pl.program_id(0)
    h = pl.program_id(1)
    sp = pl.program_id(2)
    slot = slot_ref[g]
    lo = lo_ref[g]
    hi = hi_ref[g]
    li = li_ref[0]
    q = q_ref[g, h]  # (R, D)
    cd = q.dtype
    pos = pos_ref[g]  # (R,) absolute positions; -1 = padding row
    R = q.shape[0]

    b_lo = lo // bs
    n_blk = jnp.where(hi >= 0, hi // bs - b_lo + 1, 0)
    per = (n_blk + n_split - 1) // n_split
    b0 = b_lo + sp * per
    b1 = jnp.minimum(b0 + per, b_lo + n_blk)

    rows_per_blk = bs // 4 if quant else bs
    tail = S_rows % rows_per_blk != 0  # last block runs past the allocation

    def where_row(base_pos):
        if paged:
            return tbl_ref[slot, base_pos // psz], (base_pos % psz)
        return slot, base_pos

    def load_rows(ref, page, r0, n, lead=()):
        """(n, D) rows [r0, r0+n) of ``ref[li, page, *lead, h]``."""
        at = ref.at[(li, page) + lead + (h, pl.ds(r0, n))]
        if tail:
            ok = (r0 + jnp.arange(n)) < S_rows
            return plgpu.load(at, mask=ok[:, None] if len(at.shape) == 2 else ok,
                              other=0)
        return at[...]

    def live_of(spos):
        live = spos[None, :] <= pos[:, None]
        if window:
            live = jnp.logical_and(live, spos[None, :] > pos[:, None] - window)
        return live

    def body(blk, carry):
        acc, m, l = carry
        base = blk * bs
        page, row = where_row(base)
        if quant:
            bw = bs // 4
            w0 = row // 4
            kw = load_rows(k_ref, page, w0, bw)  # (bw, D) int32
            vw = load_rows(v_ref, page, w0, bw)
            parts = []
            for j in range(4):
                kj = (((kw >> (8 * j)) & 255) - 128).astype(cd)
                ksj = load_rows(ks_ref, page, w0, bw, (j,)).astype(jnp.float32)
                s = pl.dot(q, kj, trans_b=True) * (ksj * scale)[None, :]
                live = live_of(base + 4 * jnp.arange(bw) + j)
                parts.append((jnp.where(live, s, NEG_INF), live))
            m_blk = parts[0][0].max(axis=1)
            for s, _ in parts[1:]:
                m_blk = jnp.maximum(m_blk, s.max(axis=1))
            m_new = jnp.maximum(m, m_blk)
            alpha = jnp.exp(m - m_new)
            l_new = l * alpha
            acc_new = acc * alpha[:, None]
            for j, (s, live) in enumerate(parts):
                p = jnp.where(live, jnp.exp(s - m_new[:, None]), 0.0)
                l_new = l_new + p.sum(axis=1)
                vsj = load_rows(vs_ref, page, w0, bw, (j,)).astype(jnp.float32)
                vj = (((vw >> (8 * j)) & 255) - 128).astype(cd)
                acc_new = acc_new + pl.dot((p * vsj[None, :]).astype(cd), vj)
            return acc_new, m_new, l_new
        kb = load_rows(k_ref, page, row, bs).astype(cd)  # (bs, D)
        vb = load_rows(v_ref, page, row, bs).astype(cd)
        live = live_of(base + jnp.arange(bs))
        s = jnp.where(live, pl.dot(q, kb, trans_b=True) * scale, NEG_INF)
        m_new = jnp.maximum(m, s.max(axis=1))
        alpha = jnp.exp(m - m_new)
        p = jnp.where(live, jnp.exp(s - m_new[:, None]), 0.0)
        l_new = l * alpha + p.sum(axis=1)
        acc_new = acc * alpha[:, None] + pl.dot(p.astype(cd), vb)
        return acc_new, m_new, l_new

    init = (
        jnp.zeros((R, D), jnp.float32),
        jnp.full((R,), NEG_INF, jnp.float32),
        jnp.zeros((R,), jnp.float32),
    )
    acc, m, l = jax.lax.fori_loop(b0, b1, body, init)
    if normalize:
        out = acc / jnp.maximum(l, 1e-30)[:, None]
        o_ref[g, h] = out.astype(o_ref.dtype)
    else:
        o_ref[sp, g, h] = acc
        m_ref[sp, g, h] = m
        l_ref[sp, g, h] = l


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _pick_block(block_s, quant, psz):
    bs = block_s or (BLOCK_S_INT8 if quant else BLOCK_S_BF16)
    if psz is not None:
        bs = min(bs, psz)
        while psz % bs:
            bs //= 2
    floor = 64 if quant else 16  # 16-row words/positions per dot
    if not common.is_pow2(bs) or bs < floor:
        raise ValueError(f"attention block {bs} must be a power of two >= {floor}")
    return bs


def _attend(q_rows, pos_rows, slot, lo, hi, k, v, k_scale, v_scale, layer_idx,
            page_table, window, bs, n_split, interpret):
    """Core call.  ``q_rows`` (G, Hkv, R, D); ``pos_rows`` (G, R) int32 (-1 =
    padding); ``slot``/``lo``/``hi`` (G,) int32: cache row, first visible
    position, last visible position (-1 = none).  Returns the normalized
    output (G, Hkv, R, D) in ``q_rows.dtype``."""
    if interpret is None:
        interpret = common.interpret_default()
    quant = k_scale is not None
    paged = page_table is not None
    if layer_idx is None:  # one code path: a layer axis of 1
        k, v = k[None], v[None]
        if quant:
            k_scale, v_scale = k_scale[None], v_scale[None]
        layer_idx = 0
    G, Hkv, R, D = q_rows.shape
    pack = 4 if quant else 1
    S_rows = k.shape[3]
    psz = S_rows * pack if paged else None
    normalize = n_split == 1
    operands = [
        slot.astype(jnp.int32), lo.astype(jnp.int32), hi.astype(jnp.int32),
        jnp.asarray(layer_idx, jnp.int32).reshape(1),
    ]
    if paged:
        operands.append(page_table.astype(jnp.int32))
    operands += [pos_rows.astype(jnp.int32), q_rows, k, v]
    if quant:
        operands += [k_scale, v_scale]
    if normalize:
        out_shape = jax.ShapeDtypeStruct((G, Hkv, R, D), q_rows.dtype)
    else:
        out_shape = (
            jax.ShapeDtypeStruct((n_split, G, Hkv, R, D), jnp.float32),
            jax.ShapeDtypeStruct((n_split, G, Hkv, R), jnp.float32),
            jax.ShapeDtypeStruct((n_split, G, Hkv, R), jnp.float32),
        )
    res = pl.pallas_call(
        functools.partial(
            _kernel, bs, D, D ** -0.5, quant, paged, psz, window, n_split,
            S_rows, normalize,
        ),
        grid=(G, Hkv, n_split),
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        interpret=interpret,
        backend="triton",
        name="attention",
    )(*operands)
    if normalize:
        return res
    acc, m, l = res
    m_all = m.max(axis=0)
    w = jnp.exp(m - m_all[None])
    denom = jnp.maximum((w * l).sum(axis=0), 1e-30)
    out = (w[..., None] * acc).sum(axis=0) / denom[..., None]
    return out.astype(q_rows.dtype)


def decode_split(groups: int, Hkv: int, n_blocks: int) -> int:
    """Flash-decoding split: enough programs to fill the card, never more
    splits than blocks."""
    return max(1, min(n_blocks, TARGET_PROGRAMS // max(1, groups * Hkv)))


@functools.partial(
    jax.jit, static_argnames=("block_s", "interpret", "window", "n_split")
)
def decode_attention(
    q: jax.Array,  # [B, H, D]
    k: jax.Array,  # [B, Hkv, S, D]  (or [L, B, Hkv, S, D] with layer_idx)
    v: jax.Array,  # like k
    lengths: jax.Array,  # int32 [B] — live positions per slot (attend s < len)
    block_s: Optional[int] = None,
    interpret: Optional[bool] = None,
    layer_idx: Optional[jax.Array] = None,
    k_scale: Optional[jax.Array] = None,  # [(L,) B, 4, Hkv, S/4]: int8 cache
    v_scale: Optional[jax.Array] = None,
    page_table: Optional[jax.Array] = None,  # int32 [B, P]: paged pool cache
    window: Optional[int] = None,  # sliding window: attend [len-W, len) only
    n_split: Optional[int] = None,
) -> jax.Array:
    """Softmax(q k^T / sqrt(D)) v over each slot's first ``lengths[b]`` cache
    positions; returns [B, H, D].  Reads scale with ``lengths`` (or
    ``min(lengths, window)``), not with the allocation.

    With ``k_scale``/``v_scale`` the cache is the biased packed int8 layout
    and blocks dequantize in registers.  With ``page_table`` the k/v operands
    are page pools ``[(L,) n_pages, Hkv, psz(/4), D]`` (scale pools
    ``[(L,) n_pages, 4, Hkv, psz/4]``) and position ``p`` of slot ``b`` lives
    on pool page ``page_table[b, p // psz]``.
    """
    B, H, D = q.shape
    quant = k_scale is not None
    Hkv = k.shape[-3]
    assert H % Hkv == 0
    rep = H // Hkv
    pack = 4 if quant else 1
    if page_table is not None:
        psz = k.shape[-2] * pack
        S = page_table.shape[1] * psz
    else:
        psz = None
        S = k.shape[-2] * pack
    if window is not None:
        assert window >= 1, "sliding window must be >= 1"
        if window >= S:
            window = None  # never binds: same program as no window
    bs = _pick_block(block_s, quant, psz)
    R = max(16, _next_pow2(rep))
    q_rows = jnp.pad(q.reshape(B, Hkv, rep, D), ((0, 0), (0, 0), (0, R - rep), (0, 0)))
    lengths = jnp.minimum(lengths.astype(jnp.int32), S)
    hi = lengths - 1
    pos_rows = jnp.where(jnp.arange(R)[None, :] < rep, hi[:, None], -1)
    lo = jnp.maximum(lengths - window, 0) if window else jnp.zeros_like(lengths)
    n_split = n_split or decode_split(B, Hkv, common.cdiv(S, bs))
    out = _attend(
        q_rows, pos_rows, jnp.arange(B, dtype=jnp.int32), lo, hi, k, v,
        k_scale, v_scale, layer_idx, page_table, window, bs, n_split, interpret,
    )
    return out[:, :, :rep].reshape(B, H, D)


@functools.partial(
    jax.jit, static_argnames=("block_s", "interpret", "window")
)
def prefill_attention(
    q: jax.Array,          # [N, T, H, D] chunk queries
    k: jax.Array,          # [(L,) B, Hkv, S, D] or int8 words [.., S/4, D]
    v: jax.Array,
    positions: jax.Array,  # int32 [N, T] global positions (>= S_cap = pad)
    slot_ids: jax.Array,   # int32 [N] cache rows (out of range = inert row)
    block_s: Optional[int] = None,
    interpret: Optional[bool] = None,
    layer_idx: Optional[jax.Array] = None,
    k_scale: Optional[jax.Array] = None,
    v_scale: Optional[jax.Array] = None,
    window: Optional[int] = None,
) -> jax.Array:
    """Chunked-prefill attention: ``out[n, t]`` attends cache positions
    ``s <= positions[n, t]`` (within ``window`` when set) of row
    ``slot_ids[n]``.  The chunk's own rows must already be written to the
    cache (the model writes k/v before attending, so chunk queries see
    themselves and each other causally through the cache).  Pad queries
    (positions >= S) return zeros.  Each query tile reads only its visible
    span of the cache."""
    N, T, H, D = q.shape
    quant = k_scale is not None
    Hkv = k.shape[-3]
    assert H % Hkv == 0
    rep = H // Hkv
    S = k.shape[-2] * (4 if quant else 1)
    B = k.shape[-4]
    if window is not None:
        assert window >= 1
        if window >= S:
            window = None
    bs = _pick_block(block_s, quant, None)
    tq = min(max(1, 64 // rep), T)
    QT = common.cdiv(T, tq)
    Tp = QT * tq
    positions = positions.astype(jnp.int32)
    if Tp != T:
        q = jnp.pad(q, ((0, 0), (0, Tp - T), (0, 0), (0, 0)))
        positions = jnp.pad(positions, ((0, 0), (0, Tp - T)), constant_values=S)
    live = positions < S
    pos = jnp.where(live, positions, -1).reshape(N * QT, tq)
    hi = pos.max(axis=1)
    if window is not None:
        first = jnp.where(live, positions, S).reshape(N * QT, tq).min(axis=1)
        lo = jnp.clip(first - (window - 1), 0, S - 1)
    else:
        lo = jnp.zeros_like(hi)
    slot = jnp.repeat(jnp.clip(slot_ids.astype(jnp.int32), 0, B - 1), QT)
    rows = tq * rep
    R = max(16, _next_pow2(rows))
    # q rows of a (tile, kv head): (t, r) for query head h*rep + r
    q_rows = (
        q.reshape(N, QT, tq, Hkv, rep, D).transpose(0, 1, 3, 2, 4, 5)
        .reshape(N * QT, Hkv, rows, D)
    )
    pos_rows = jnp.repeat(pos, rep, axis=1)  # (G, tq*rep) in (t, r) order
    if R != rows:
        q_rows = jnp.pad(q_rows, ((0, 0), (0, 0), (0, R - rows), (0, 0)))
        pos_rows = jnp.pad(pos_rows, ((0, 0), (0, R - rows)), constant_values=-1)
    out = _attend(
        q_rows, pos_rows, slot, lo, hi, k, v, k_scale, v_scale, layer_idx,
        None, window, bs, 1, interpret,
    )
    out = out[:, :, :rows].reshape(N, QT, Hkv, tq, rep, D).transpose(
        0, 1, 3, 2, 4, 5)
    return out.reshape(N, Tp, H, D)[:, :T]
