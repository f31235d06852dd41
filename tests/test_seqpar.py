"""Sequence-parallel (ring attention / context-parallel prefill) tests on the
8-virtual-device CPU mesh.  Oracle = the single-chip dense paths in
``models/llama.py`` (the reference has no sequence axis at all — SURVEY §5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xbitops.models import llama
from xbitops.parallel import mesh as meshlib
from xbitops.parallel import seqpar


@pytest.fixture(scope="module")
def seq_mesh():
    return meshlib.make_mesh((8,), ("seq",))


@pytest.fixture(scope="module")
def sp_tp_mesh():
    return meshlib.make_mesh((4, 2), ("seq", "model"))


def _att_oracle(q, k, v, q_pos, kv_pos, scale):
    """Dense causal attention over global positions (f32)."""
    qf, kf, vf = (x.astype(jnp.float32) for x in (q, k, v))
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        kf = jnp.repeat(kf, rep, axis=2)
        vf = jnp.repeat(vf, rep, axis=2)
    s = jnp.einsum("bqhd,bkhd->bqhk", qf, kf) * scale
    mask = (kv_pos[:, None, :] <= q_pos[:, :, None])[:, :, None, :]
    p = jax.nn.softmax(jnp.where(mask, s, -1e30), axis=-1)
    return jnp.einsum("bqhk,bkhd->bqhd", p, vf)


@pytest.mark.parametrize("rep", [1, 2])
def test_ring_attention_matches_dense(seq_mesh, rep):
    B, T, Hkv, D = 2, 64, 2, 64
    H = Hkv * rep
    key = jax.random.PRNGKey(0)
    q = jax.random.normal(key, (B, T, H, D), jnp.bfloat16)
    k = jax.random.normal(jax.random.fold_in(key, 1), (B, T, Hkv, D), jnp.bfloat16) * 0.3
    v = jax.random.normal(jax.random.fold_in(key, 2), (B, T, Hkv, D), jnp.bfloat16) * 0.3
    pos = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    got = seqpar.ring_attention(q, k, v, pos, pos, seq_mesh, axis="seq")
    want = _att_oracle(q, k, v, pos, pos, D ** -0.5)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want), rtol=5e-2, atol=5e-3
    )


def test_ring_attention_respects_positions(seq_mesh):
    """Queries must not see kv entries with larger global positions, no
    matter which ring device holds them."""
    B, T, H, D = 1, 16, 2, 32
    key = jax.random.PRNGKey(3)
    q = jax.random.normal(key, (B, T, H, D), jnp.float32)
    k = jax.random.normal(jax.random.fold_in(key, 1), (B, T, H, D), jnp.float32)
    v = jax.random.normal(jax.random.fold_in(key, 2), (B, T, H, D), jnp.float32)
    q_pos = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    # kv positions reversed: only the tail chunk is visible to early queries
    kv_pos = q_pos[:, ::-1]
    got = seqpar.ring_attention(q, k, v, q_pos, kv_pos, seq_mesh, axis="seq")
    want = _att_oracle(q, k, v, q_pos, kv_pos, D ** -0.5)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)


CFG = llama.LlamaConfig.tiny(seq=64)


# B*T = 32 rows: the oracle's projections take the fused kernel, as the
# shards' do (ops.qmatmul.KERNEL_MAX_M), so both sides share one numerics.
def _check_sp_prefill(params, mesh, tp_axis, B=2, T=16, oracle_params=None):
    key = jax.random.PRNGKey(7)
    tokens = jax.random.randint(key, (B, T), 0, CFG.vocab_size)
    # oracle: single-chip full prefill (TP runs pass same-key tp=1 params —
    # the interleaved fused pack is the same logical model)
    cache0 = llama.KVCache.init(CFG, B)
    want_logits, want_cache = llama.prefill(
        oracle_params if oracle_params is not None else params,
        CFG, tokens, cache0,
    )
    got_logits, got_cache = seqpar.sp_prefill(
        params, CFG, mesh, tokens, llama.KVCache.init(CFG, B),
        seq_axis="seq", tp_axis=tp_axis,
    )
    np.testing.assert_allclose(
        np.asarray(got_logits, np.float32),
        np.asarray(want_logits[:, -1], np.float32),
        rtol=5e-2, atol=5e-2,
    )
    assert (
        np.asarray(jnp.argmax(got_logits, -1))
        == np.asarray(jnp.argmax(want_logits[:, -1], -1))
    ).all()
    np.testing.assert_array_equal(np.asarray(got_cache.lengths[:B]), T)
    for got, want in ((got_cache.k, want_cache.k), (got_cache.v, want_cache.v)):
        np.testing.assert_allclose(
            np.asarray(got[:, :, :, :T], np.float32),
            np.asarray(want[:, :, :, :T], np.float32),
            rtol=5e-2, atol=3e-2,
        )
    # the sp cache must feed ordinary decode: one greedy step matches
    dec_params = oracle_params if oracle_params is not None else params
    d_want, _ = llama.decode_step(
        dec_params, CFG, jnp.argmax(want_logits[:, -1], -1).astype(jnp.int32),
        want_cache,
    )
    d_got, _ = llama.decode_step(
        dec_params, CFG, jnp.argmax(got_logits, -1).astype(jnp.int32), got_cache
    )
    assert (
        np.asarray(jnp.argmax(d_got, -1)) == np.asarray(jnp.argmax(d_want, -1))
    ).all()


def test_sp_prefill_matches_dense(seq_mesh):
    params = llama.init_params(jax.random.PRNGKey(0), CFG, bits=4, group_size=32)
    _check_sp_prefill(params, seq_mesh, tp_axis=None)


def test_sp_prefill_stacked_layers(seq_mesh):
    params = llama.stack_layers(
        llama.init_params(jax.random.PRNGKey(0), CFG, bits=4, group_size=32)
    )
    _check_sp_prefill(params, seq_mesh, tp_axis=None)


def test_sp_prefill_with_tp(sp_tp_mesh):
    params = llama.init_params(
        jax.random.PRNGKey(0), CFG, bits=4, group_size=32, tp=2
    )
    single = llama.init_params(
        jax.random.PRNGKey(0), CFG, bits=4, group_size=32, tp=1
    )
    _check_sp_prefill(params, sp_tp_mesh, tp_axis="model",
                      oracle_params=single)


def test_sp_prefill_rejects_bad_shapes(seq_mesh):
    params = llama.init_params(jax.random.PRNGKey(0), CFG, bits=4, group_size=32)
    cache = llama.KVCache.init(CFG, 2)
    with pytest.raises(ValueError, match="divide the seq axis"):
        seqpar.sp_prefill(
            params, CFG, seq_mesh,
            jnp.zeros((2, 12), jnp.int32), cache,
        )
    qcache = llama.KVCache.init(CFG, 2, quantized=True)
    with pytest.raises(ValueError, match="dense caches"):
        seqpar.sp_prefill(
            params, CFG, seq_mesh, jnp.zeros((2, 32), jnp.int32), qcache
        )


def test_ring_attention_sliding_window(seq_mesh):
    """Windowed ring attention == the dense windowed oracle — the window
    mask rides global positions, so it is shard-placement-oblivious."""
    B, T, Hkv, D, W = 2, 64, 2, 64, 20
    H = Hkv * 2
    key = jax.random.PRNGKey(17)
    q = jax.random.normal(key, (B, T, H, D), jnp.bfloat16)
    k = jax.random.normal(jax.random.fold_in(key, 1), (B, T, Hkv, D),
                          jnp.bfloat16) * 0.3
    v = jax.random.normal(jax.random.fold_in(key, 2), (B, T, Hkv, D),
                          jnp.bfloat16) * 0.3
    pos = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    got = seqpar.ring_attention(q, k, v, pos, pos, seq_mesh, axis="seq",
                                window=W)
    qf, kf, vf = (x.astype(jnp.float32) for x in (q, k, v))
    kf = jnp.repeat(kf, 2, axis=2)
    vf = jnp.repeat(vf, 2, axis=2)
    s = jnp.einsum("bqhd,bkhd->bqhk", qf, kf) * (D ** -0.5)
    mask = (pos[:, None, :] <= pos[:, :, None]) & (
        pos[:, :, None] - pos[:, None, :] < W
    )
    p = jax.nn.softmax(jnp.where(mask[:, :, None, :], s, -1e30), axis=-1)
    want = jnp.einsum("bqhk,bkhd->bqhd", p, vf)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want), rtol=5e-2, atol=5e-3
    )


def test_sp_prefill_sliding_window(seq_mesh):
    """sp_prefill on a sliding-window config == single-chip windowed prefill
    (same logits, same cache)."""
    import dataclasses as dc

    cfg = dc.replace(llama.LlamaConfig.tiny(), sliding_window=8)
    params = llama.init_params(jax.random.PRNGKey(4), cfg, bits=8,
                               group_size=32)
    B, T = 2, 16  # 32 rows: the oracle takes the fused kernel, as the shards do
    tokens = jax.random.randint(jax.random.PRNGKey(5), (B, T), 0,
                                cfg.vocab_size)
    logits_sp, cache_sp = seqpar.sp_prefill(
        params, cfg, seq_mesh, tokens, llama.KVCache.init(cfg, B))
    logits, cache_ref = llama.prefill(
        params, cfg, tokens, llama.KVCache.init(cfg, B))
    np.testing.assert_allclose(
        np.asarray(logits_sp, np.float32),
        np.asarray(logits[:, -1], np.float32), rtol=5e-2, atol=5e-2)
    assert (
        np.asarray(jnp.argmax(logits_sp, -1))
        == np.asarray(jnp.argmax(logits[:, -1], -1))
    ).all()
    np.testing.assert_allclose(
        np.asarray(cache_sp.k, np.float32)[:, :B],
        np.asarray(cache_ref.k, np.float32)[:, :B], rtol=5e-2, atol=3e-2)
