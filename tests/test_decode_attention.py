"""Length-aware decode-attention kernel vs the masked-softmax oracle.

The cache is head-major ([B, Hkv, S, D]; packed int8: biased words
[B, Hkv, S/4, D] + scales [B, 4, Hkv, S/4]) — tests build row-major
reference tensors and transpose at the kernel boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xbitops.kernels.attention import decode_attention


def ref_att(q, k, v, lengths, window=None):
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    kk = jnp.repeat(k, rep, axis=2).astype(jnp.float32)
    vv = jnp.repeat(v, rep, axis=2).astype(jnp.float32)
    logits = jnp.einsum("bhd,bshd->bhs", q.astype(jnp.float32), kk) * (D ** -0.5)
    mask = jnp.arange(S)[None, None, :] < lengths[:, None, None]
    if window is not None:
        lo = jnp.maximum(lengths - window, 0)
        mask &= jnp.arange(S)[None, None, :] >= lo[:, None, None]
    p = jax.nn.softmax(jnp.where(mask, logits, -1e30), axis=-1)
    return jnp.einsum("bhs,bshd->bhd", p, vv)


def hmT(x):
    """[.., S, Hkv, D] row-major -> head-major [.., Hkv, S, D]."""
    return jnp.swapaxes(x, -3, -2)


def pack_int8(kf, vf):
    """Row-major f32 k/v -> (words, scales, dequantized-bf16 refs)."""
    from xbitops.models.llama import (
        _pack_kv_scales, _pack_kv_words, _quant_kv,
    )

    kq, ks = _quant_kv(kf)  # biased bytes
    vq, vs = _quant_kv(vf)
    kd = ((kq - 128).astype(jnp.float32) * ks[..., None]).astype(jnp.bfloat16)
    vd = ((vq - 128).astype(jnp.float32) * vs[..., None]).astype(jnp.bfloat16)
    return (
        _pack_kv_words(kq), _pack_kv_words(vq),
        _pack_kv_scales(ks).astype(jnp.bfloat16),
        _pack_kv_scales(vs).astype(jnp.bfloat16),
        kd, vd,
    )


@pytest.mark.parametrize(
    "B,S,H,Hkv,bs",
    [(2, 256, 8, 2, 64), (3, 300, 12, 4, 128), (1, 64, 4, 4, 64), (2, 128, 4, 1, 32)],
)
def test_decode_attention_matches_oracle(B, S, H, Hkv, bs):
    D = 128
    key = jax.random.PRNGKey(B * 100 + S)
    q = jax.random.normal(key, (B, H, D), jnp.bfloat16)
    k = jax.random.normal(jax.random.fold_in(key, 1), (B, S, Hkv, D), jnp.bfloat16) * 0.3
    v = jax.random.normal(jax.random.fold_in(key, 2), (B, S, Hkv, D), jnp.bfloat16) * 0.3
    lengths = jnp.asarray(np.random.default_rng(S).integers(1, S + 1, B), jnp.int32)
    got = np.asarray(decode_attention(q, hmT(k), hmT(v), lengths, block_s=bs), np.float32)
    want = np.asarray(ref_att(q, k, v, lengths))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=2e-3)


def test_decode_attention_stacked_layer_index():
    L, B, S, H, Hkv, D = 3, 2, 128, 8, 2, 128
    key = jax.random.PRNGKey(7)
    q = jax.random.normal(key, (B, H, D), jnp.bfloat16)
    ks = jax.random.normal(jax.random.fold_in(key, 1), (L, B, S, Hkv, D), jnp.bfloat16) * 0.3
    vs = jax.random.normal(jax.random.fold_in(key, 2), (L, B, S, Hkv, D), jnp.bfloat16) * 0.3
    lengths = jnp.asarray([60, 128], jnp.int32)
    for li in range(L):
        got = np.asarray(
            decode_attention(q, hmT(ks), hmT(vs), lengths, block_s=64,
                             layer_idx=jnp.int32(li)),
            np.float32,
        )
        want = np.asarray(ref_att(q, ks[li], vs[li], lengths))
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=2e-3)


def test_decode_attention_length_isolation():
    """Values past each slot's length must not influence the output."""
    B, S, H, Hkv, D = 2, 128, 4, 2, 128
    key = jax.random.PRNGKey(0)
    q = jax.random.normal(key, (B, H, D), jnp.bfloat16)
    k = jax.random.normal(jax.random.fold_in(key, 1), (B, S, Hkv, D), jnp.bfloat16)
    v = jax.random.normal(jax.random.fold_in(key, 2), (B, S, Hkv, D), jnp.bfloat16)
    lengths = jnp.asarray([40, 100], jnp.int32)
    base = np.asarray(decode_attention(q, hmT(k), hmT(v), lengths, block_s=32), np.float32)
    # poison everything past the lengths with huge values
    pos = jnp.arange(S)[None, :, None, None]
    poison = jnp.where(pos >= lengths[:, None, None, None], 1e4, 0).astype(k.dtype)
    got = np.asarray(
        decode_attention(q, hmT(k + poison), hmT(v + poison), lengths, block_s=32),
        np.float32,
    )
    np.testing.assert_array_equal(got, base)


def test_decode_attention_int8_scales():
    """Packed biased int8 k/v + per-(pos, head) scales dequantize in-kernel to
    match the dequantized-oracle attention."""
    B, S, H, Hkv, D = 2, 128, 8, 2, 128
    key = jax.random.PRNGKey(3)
    q = jax.random.normal(key, (B, H, D), jnp.bfloat16)
    kf = jax.random.normal(jax.random.fold_in(key, 1), (B, S, Hkv, D)) * 0.5
    vf = jax.random.normal(jax.random.fold_in(key, 2), (B, S, Hkv, D)) * 0.5
    kw, vw, ks_p, vs_p, kd, vd = pack_int8(kf, vf)
    lengths = jnp.asarray([50, 128], jnp.int32)
    got = np.asarray(
        decode_attention(q, kw, vw, lengths, block_s=64, k_scale=ks_p, v_scale=vs_p),
        np.float32,
    )
    want = np.asarray(ref_att(q, kd, vd, lengths))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-3)


def test_decode_attention_paged():
    """Paged pool + page-table indirection == dense-cache attention (pages
    shuffled through the pool, one slot partial-length)."""
    B, S, H, Hkv, D, psz = 2, 256, 8, 2, 128, 64
    P, n_pages = S // psz, 10
    key = jax.random.PRNGKey(5)
    q = jax.random.normal(key, (B, H, D), jnp.bfloat16)
    kd = jax.random.normal(jax.random.fold_in(key, 1), (B, S, Hkv, D), jnp.bfloat16)
    vd = jax.random.normal(jax.random.fold_in(key, 2), (B, S, Hkv, D), jnp.bfloat16)
    rng = np.random.default_rng(0)
    perm = rng.permutation(n_pages)[: B * P]
    table = np.full((B, P), -1, np.int32)
    pool_k = np.zeros((n_pages, Hkv, psz, D), np.float32)
    pool_v = np.zeros((n_pages, Hkv, psz, D), np.float32)
    kT = np.asarray(hmT(kd), np.float32)  # (B, Hkv, S, D)
    vT = np.asarray(hmT(vd), np.float32)
    for b in range(B):
        for p in range(P):
            pg = int(perm[b * P + p])
            table[b, p] = pg
            pool_k[pg] = kT[b, :, p * psz : (p + 1) * psz]
            pool_v[pg] = vT[b, :, p * psz : (p + 1) * psz]
    lengths = jnp.asarray([70, 256], jnp.int32)
    got = np.asarray(
        decode_attention(
            q, jnp.asarray(pool_k, jnp.bfloat16), jnp.asarray(pool_v, jnp.bfloat16),
            lengths, page_table=jnp.asarray(table),
        ),
        np.float32,
    )
    want = np.asarray(ref_att(q, kd, vd, lengths))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-3)


def test_decode_attention_paged_stacked():
    """Stacked paged pool [L, n_pages, Hkv, psz, D] + layer_idx — the shape
    the engine actually drives (the model always passes layer_idx)."""
    L, B, S, H, Hkv, D, psz = 3, 2, 256, 8, 2, 128, 64
    P, n_pages = S // psz, 10
    key = jax.random.PRNGKey(11)
    q = jax.random.normal(key, (B, H, D), jnp.bfloat16)
    kd = jax.random.normal(jax.random.fold_in(key, 1), (L, B, S, Hkv, D), jnp.bfloat16)
    vd = jax.random.normal(jax.random.fold_in(key, 2), (L, B, S, Hkv, D), jnp.bfloat16)
    rng = np.random.default_rng(4)
    perm = rng.permutation(n_pages)[: B * P]
    table = np.full((B, P), -1, np.int32)
    pool_k = np.zeros((L, n_pages, Hkv, psz, D), np.float32)
    pool_v = np.zeros((L, n_pages, Hkv, psz, D), np.float32)
    kT = np.asarray(hmT(kd), np.float32)  # (L, B, Hkv, S, D)
    vT = np.asarray(hmT(vd), np.float32)
    for b in range(B):
        for p in range(P):
            pg = int(perm[b * P + p])
            table[b, p] = pg
            pool_k[:, pg] = kT[:, b, :, p * psz : (p + 1) * psz]
            pool_v[:, pg] = vT[:, b, :, p * psz : (p + 1) * psz]
    lengths = jnp.asarray([70, 256], jnp.int32)
    for li in range(L):
        got = np.asarray(
            decode_attention(
                q, jnp.asarray(pool_k, jnp.bfloat16), jnp.asarray(pool_v, jnp.bfloat16),
                lengths, page_table=jnp.asarray(table), layer_idx=jnp.int32(li),
            ),
            np.float32,
        )
        want = np.asarray(ref_att(q, kd[li], vd[li], lengths))
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-3)


def test_decode_attention_paged_int8():
    """Paged + packed-int8 combination (round-2 verdict item 10): int8 word
    pools + scale pools behind a shuffled page table == dequantized oracle."""
    B, S, H, Hkv, D, psz = 2, 256, 8, 2, 128, 64
    P, n_pages = S // psz, 10
    key = jax.random.PRNGKey(13)
    q = jax.random.normal(key, (B, H, D), jnp.bfloat16)
    kf = jax.random.normal(jax.random.fold_in(key, 1), (B, S, Hkv, D)) * 0.5
    vf = jax.random.normal(jax.random.fold_in(key, 2), (B, S, Hkv, D)) * 0.5
    kw, vw, ks_p, vs_p, kd, vd = pack_int8(kf, vf)
    # kw (B, Hkv, S/4, D); ks_p (B, 4, Hkv, S/4)
    rng = np.random.default_rng(2)
    perm = rng.permutation(n_pages)[: B * P]
    table = np.full((B, P), -1, np.int32)
    pszw = psz // 4
    pool_k = np.zeros((n_pages, Hkv, pszw, D), np.int32)
    pool_v = np.zeros((n_pages, Hkv, pszw, D), np.int32)
    pool_ks = np.zeros((n_pages, 4, Hkv, pszw), np.float32)
    pool_vs = np.zeros((n_pages, 4, Hkv, pszw), np.float32)
    kw_n, vw_n = np.asarray(kw), np.asarray(vw)
    ks_n = np.asarray(ks_p, np.float32)
    vs_n = np.asarray(vs_p, np.float32)
    for b in range(B):
        for p in range(P):
            pg = int(perm[b * P + p])
            table[b, p] = pg
            sl = slice(p * pszw, (p + 1) * pszw)
            pool_k[pg] = kw_n[b, :, sl]
            pool_v[pg] = vw_n[b, :, sl]
            pool_ks[pg] = ks_n[b, :, :, sl]
            pool_vs[pg] = vs_n[b, :, :, sl]
    lengths = jnp.asarray([70, 256], jnp.int32)
    got = np.asarray(
        decode_attention(
            q, jnp.asarray(pool_k), jnp.asarray(pool_v), lengths,
            page_table=jnp.asarray(table),
            k_scale=jnp.asarray(pool_ks, jnp.bfloat16),
            v_scale=jnp.asarray(pool_vs, jnp.bfloat16),
        ),
        np.float32,
    )
    want = np.asarray(ref_att(q, kd, vd, lengths))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-3)


@pytest.mark.parametrize(
    "B,S,H,Hkv,bs,window",
    [
        (2, 256, 8, 2, 64, 100),   # window crosses block boundaries
        (3, 300, 12, 4, 128, 64),  # window < one block
        (2, 128, 4, 4, 32, 200),   # window > some lengths (partially binds)
        (2, 128, 4, 1, 32, 1),     # degenerate: only the newest position
    ],
)
def test_decode_attention_sliding_window(B, S, H, Hkv, bs, window):
    """Sliding window == masked-softmax oracle over [len-W, len) only."""
    D = 128
    key = jax.random.PRNGKey(B * 10 + window)
    q = jax.random.normal(key, (B, H, D), jnp.bfloat16)
    k = jax.random.normal(jax.random.fold_in(key, 1), (B, S, Hkv, D),
                          jnp.bfloat16) * 0.3
    v = jax.random.normal(jax.random.fold_in(key, 2), (B, S, Hkv, D),
                          jnp.bfloat16) * 0.3
    lengths = jnp.asarray(
        np.random.default_rng(S + window).integers(1, S + 1, B), jnp.int32)
    got = np.asarray(
        decode_attention(q, hmT(k), hmT(v), lengths, block_s=bs,
                         window=window),
        np.float32,
    )
    want = np.asarray(ref_att(q, k, v, lengths, window=window))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=2e-3)


def test_decode_attention_sliding_window_excluded_blocks_isolated():
    """Poisoning every position OUTSIDE the window changes nothing — the
    excluded blocks must neither be read into the softmax nor the output."""
    B, S, H, Hkv, D, W = 2, 256, 4, 2, 128, 80
    key = jax.random.PRNGKey(21)
    q = jax.random.normal(key, (B, H, D), jnp.bfloat16)
    k = jax.random.normal(jax.random.fold_in(key, 1), (B, S, Hkv, D), jnp.bfloat16)
    v = jax.random.normal(jax.random.fold_in(key, 2), (B, S, Hkv, D), jnp.bfloat16)
    lengths = jnp.asarray([130, 256], jnp.int32)
    base = np.asarray(
        decode_attention(q, hmT(k), hmT(v), lengths, block_s=64, window=W),
        np.float32,
    )
    pos = jnp.arange(S)[None, :, None, None]
    lo = jnp.maximum(lengths - W, 0)[:, None, None, None]
    outside = (pos < lo) | (pos >= lengths[:, None, None, None])
    poison = jnp.where(outside, 1e4, 0).astype(k.dtype)
    got = np.asarray(
        decode_attention(q, hmT(k + poison), hmT(v + poison), lengths,
                         block_s=64, window=W),
        np.float32,
    )
    np.testing.assert_array_equal(got, base)


def test_decode_attention_sliding_window_int8_and_stacked():
    """Window composes with the packed int8 cache and stacked layers."""
    B, S, H, Hkv, D, W = 2, 128, 8, 2, 128, 50
    key = jax.random.PRNGKey(31)
    q = jax.random.normal(key, (B, H, D), jnp.bfloat16)
    kf = jax.random.normal(jax.random.fold_in(key, 1), (B, S, Hkv, D)) * 0.5
    vf = jax.random.normal(jax.random.fold_in(key, 2), (B, S, Hkv, D)) * 0.5
    kw, vw, ks_p, vs_p, kd, vd = pack_int8(kf, vf)
    lengths = jnp.asarray([70, 128], jnp.int32)
    got = np.asarray(
        decode_attention(q, kw, vw, lengths, block_s=64,
                         k_scale=ks_p, v_scale=vs_p, window=W),
        np.float32,
    )
    want = np.asarray(ref_att(q, kd, vd, lengths, window=W))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-3)

    L = 2
    got = np.asarray(
        decode_attention(q, jnp.stack([kw] * L), jnp.stack([vw] * L),
                         lengths, block_s=64, layer_idx=jnp.int32(1),
                         k_scale=jnp.stack([ks_p] * L),
                         v_scale=jnp.stack([vs_p] * L), window=W),
        np.float32,
    )
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-3)


@pytest.mark.parametrize("n_split", [2, 3])
def test_decode_attention_split_combine(n_split):
    """Flash-decoding: splitting each slot's blocks over programs and
    combining the partial softmaxes equals the unsplit result."""
    B, S, H, Hkv, D = 3, 256, 8, 2, 128
    key = jax.random.PRNGKey(n_split)
    q = jax.random.normal(key, (B, H, D), jnp.bfloat16)
    k = jax.random.normal(jax.random.fold_in(key, 1), (B, S, Hkv, D), jnp.bfloat16)
    v = jax.random.normal(jax.random.fold_in(key, 2), (B, S, Hkv, D), jnp.bfloat16)
    lengths = jnp.asarray([1, 130, 256], jnp.int32)
    got = np.asarray(decode_attention(q, hmT(k), hmT(v), lengths, block_s=32,
                                      n_split=n_split), np.float32)
    want = np.asarray(ref_att(q, k, v, lengths))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=2e-3)


@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_attention_matches_ctx(quantized):
    """Chunked-prefill kernel == the plain masked attention over the whole
    cache (queries at positions 64..127 of their slots, one inert row)."""
    from xbitops.kernels.attention import prefill_attention
    from xbitops.models.llama import _attention, _unpack_kv_words

    N, C, S, H, Hkv, D = 2, 64, 256, 8, 2, 128
    key = jax.random.PRNGKey(7 + quantized)
    q = jax.random.normal(key, (N, C, H, D), jnp.bfloat16)
    kf = jax.random.normal(jax.random.fold_in(key, 1), (N, S, Hkv, D)) * 0.5
    vf = jax.random.normal(jax.random.fold_in(key, 2), (N, S, Hkv, D)) * 0.5
    positions = jnp.broadcast_to(64 + jnp.arange(C)[None], (N, C)).astype(jnp.int32)
    positions = positions.at[1, 40:].set(S)  # padded tail of the second row
    slots = jnp.asarray([1, 0], jnp.int32)
    if quantized:
        kw, vw, ks_p, vs_p, _, _ = pack_int8(kf, vf)
        ctx = (_unpack_kv_words(kw, ks_p), _unpack_kv_words(vw, vs_p))
        got = prefill_attention(q, kw, vw, positions, slots, block_s=64,
                                k_scale=ks_p, v_scale=vs_p)
    else:
        kT, vT = hmT(kf.astype(jnp.bfloat16)), hmT(vf.astype(jnp.bfloat16))
        ctx = (kT, vT)
        got = prefill_attention(q, kT, vT, positions, slots, block_s=32)
    ctx = tuple(c[slots] for c in ctx)
    mask = (jnp.arange(S)[None, None, :] <= positions[:, :, None]) & (
        positions[:, :, None] < S)
    want = _attention(q.astype(jnp.float32), *ctx, mask, D ** -0.5)
    got = np.asarray(got, np.float32)
    live = np.asarray(positions < S)
    np.testing.assert_allclose(got[live], np.asarray(want)[live], rtol=5e-2, atol=5e-3)
    assert not got[~live].any()  # pad queries return zeros
