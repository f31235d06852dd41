"""Pipeline-parallel tests on the 8-virtual-device CPU mesh.  Oracle = the
single-chip stacked-model paths in ``models/llama.py`` (the reference has no
parallelism at all — SURVEY §2 checklist)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xbitops.models import llama
from xbitops.parallel import mesh as meshlib
from xbitops.parallel import pp

# 2 layers -> 2 stages of 1.  Pipeline stages attend their microbatch's slots
# through the plain attention path, so the single-chip oracle takes it too
# (flash_decode=False): cache writes then stay bit-identical.
CFG = dataclasses.replace(llama.LlamaConfig.tiny(seq=64), flash_decode=False)


@pytest.fixture(scope="module")
def pipe_mesh():
    return meshlib.make_mesh((2,), ("pipe",))


@pytest.fixture(scope="module")
def pipe_tp_mesh():
    return meshlib.make_mesh((2, 2), ("pipe", "model"))


def _params(tp=1):
    return llama.stack_layers(
        llama.init_params(jax.random.PRNGKey(0), CFG, bits=4, group_size=32,
                          tp=tp)
    )


def _prefilled(params, B, T=6):
    tokens = jax.random.randint(jax.random.PRNGKey(5), (B, T), 0,
                                CFG.vocab_size)
    lens = jnp.full((B,), T, jnp.int32)
    cache = llama.KVCache.init(CFG, B)
    logits, cache = llama.prefill_slots(
        params, CFG, tokens, lens, jnp.arange(B), cache
    )
    return jnp.argmax(logits, -1).astype(jnp.int32), cache


def test_pp_decode_burst_matches_sequential(pipe_mesh):
    """The software-pipelined burst (microbatch m re-enters stage 0 the
    round after its token leaves the last stage) emits exactly the tokens
    of a sequential greedy decode loop, and the caches agree."""
    params = _params()
    B, n_steps = 4, 5
    toks, cache = _prefilled(params, B)

    want_cache = cache
    want_toks, cur = [], toks
    for _ in range(n_steps):
        lg, want_cache = llama.decode_step(params, CFG, cur, want_cache)
        cur = jnp.argmax(lg, -1).astype(jnp.int32)
        want_toks.append(np.asarray(cur))

    got_toks, got_cache = pp.pp_decode_burst(
        params, CFG, pipe_mesh, toks, cache, n_steps
    )
    np.testing.assert_array_equal(np.asarray(got_toks), np.stack(want_toks))
    np.testing.assert_array_equal(
        np.asarray(got_cache.lengths), np.asarray(want_cache.lengths))
    np.testing.assert_allclose(
        np.asarray(got_cache.k, np.float32),
        np.asarray(want_cache.k, np.float32), rtol=2e-2, atol=2e-2)


def test_pp_decode_burst_inactive_and_capacity(pipe_mesh):
    """Inactive slots don't advance; slots at capacity drop writes (the
    plain decode_step semantics, chained)."""
    params = _params()
    B, n_steps = 4, 4
    toks, cache = _prefilled(params, B)
    S = cache.S
    # slot 3 sits one position from capacity: only 1 of 4 steps lands
    lens = cache.lengths.at[3].set(S - 1)
    cache = dataclasses.replace(cache, lengths=lens)
    active = jnp.asarray([True, True, False, True])

    want_cache = cache
    cur = toks
    want_toks = []
    for _ in range(n_steps):
        lg, want_cache = llama.decode_step(params, CFG, cur, want_cache,
                                           active=active)
        cur = jnp.where(active, jnp.argmax(lg, -1).astype(jnp.int32), 0)
        want_toks.append(np.asarray(cur))

    got_toks, got_cache = pp.pp_decode_burst(
        params, CFG, pipe_mesh, toks, cache, n_steps, active=active
    )
    np.testing.assert_array_equal(
        np.asarray(got_cache.lengths), np.asarray(want_cache.lengths))
    got = np.asarray(got_toks)
    want = np.stack(want_toks)
    np.testing.assert_array_equal(got[:, active], want[:, active])


def test_pp_decode_matches_single_chip(pipe_mesh):
    params = _params()
    B = 4
    toks, cache = _prefilled(params, B)
    want_logits, want_cache = llama.decode_step(params, CFG, toks, cache)
    got_logits, got_cache = pp.pp_decode_step(
        params, CFG, pipe_mesh, toks, cache
    )
    assert (
        np.asarray(jnp.argmax(got_logits, -1))
        == np.asarray(jnp.argmax(want_logits, -1))
    ).all()
    np.testing.assert_allclose(
        np.asarray(got_logits), np.asarray(want_logits, np.float32),
        rtol=2e-2, atol=2e-2,
    )
    np.testing.assert_array_equal(
        np.asarray(got_cache.lengths), np.asarray(want_cache.lengths))
    # cache writes are the same drop-scatters — bit-identical
    np.testing.assert_array_equal(np.asarray(got_cache.k),
                                  np.asarray(want_cache.k))
    np.testing.assert_array_equal(np.asarray(got_cache.v),
                                  np.asarray(want_cache.v))


def test_pp_decode_active_mask_and_capacity(pipe_mesh):
    params = _params()
    B = 4
    toks, cache = _prefilled(params, B)
    active = jnp.asarray([True, False, True, False])
    want_logits, want_cache = llama.decode_step(
        params, CFG, toks, cache, active=active)
    got_logits, got_cache = pp.pp_decode_step(
        params, CFG, pipe_mesh, toks, cache, active=active
    )
    np.testing.assert_array_equal(
        np.asarray(got_cache.lengths), np.asarray(want_cache.lengths))
    np.testing.assert_array_equal(np.asarray(got_cache.k),
                                  np.asarray(want_cache.k))
    assert (
        np.asarray(jnp.argmax(got_logits[active], -1))
        == np.asarray(jnp.argmax(want_logits[active], -1))
    ).all()


def test_pp_decode_int8_cache(pipe_mesh):
    params = _params()
    B = 4
    tokens = jax.random.randint(jax.random.PRNGKey(5), (B, 4), 0,
                                CFG.vocab_size)
    lens = jnp.full((B,), 4, jnp.int32)
    cache = llama.KVCache.init(CFG, B, quantized=True)
    logits, cache = llama.prefill_slots(
        params, CFG, tokens, lens, jnp.arange(B), cache)
    toks = jnp.argmax(logits, -1).astype(jnp.int32)
    want_logits, want_cache = llama.decode_step(params, CFG, toks, cache)
    got_logits, got_cache = pp.pp_decode_step(
        params, CFG, pipe_mesh, toks, cache
    )
    assert (
        np.asarray(jnp.argmax(got_logits, -1))
        == np.asarray(jnp.argmax(want_logits, -1))
    ).all()
    np.testing.assert_array_equal(np.asarray(got_cache.k),
                                  np.asarray(want_cache.k))
    np.testing.assert_array_equal(np.asarray(got_cache.k_scale),
                                  np.asarray(want_cache.k_scale))


def test_pp_prefill_matches_single_chip(pipe_mesh):
    params = _params()
    B, T = 4, 8
    tokens = jax.random.randint(jax.random.PRNGKey(9), (B, T), 0,
                                CFG.vocab_size)
    lens = jnp.asarray([3, 8, 5, 1], jnp.int32)
    tokens = jnp.where(jnp.arange(T)[None] < lens[:, None], tokens, 0)
    want_logits, want_cache = llama.prefill_slots(
        params, CFG, tokens, lens, jnp.arange(B), llama.KVCache.init(CFG, B))
    got_logits, got_cache = pp.pp_prefill_slots(
        params, CFG, pipe_mesh, tokens, lens, llama.KVCache.init(CFG, B)
    )
    assert (
        np.asarray(jnp.argmax(got_logits, -1))
        == np.asarray(jnp.argmax(want_logits, -1))
    ).all()
    np.testing.assert_array_equal(
        np.asarray(got_cache.lengths), np.asarray(want_cache.lengths))
    np.testing.assert_array_equal(np.asarray(got_cache.k),
                                  np.asarray(want_cache.k))
    # the pp cache must feed ordinary decode
    toks = jnp.argmax(got_logits, -1).astype(jnp.int32)
    d_want, _ = llama.decode_step(params, CFG, toks, want_cache)
    d_got, _ = llama.decode_step(params, CFG, toks, got_cache)
    assert (
        np.asarray(jnp.argmax(d_got, -1)) == np.asarray(jnp.argmax(d_want, -1))
    ).all()


def test_pp_with_tp(pipe_tp_mesh):
    params = _params(tp=2)
    oracle = _params(tp=1)
    B = 4
    toks, cache = _prefilled(oracle, B)
    want_logits, want_cache = llama.decode_step(oracle, CFG, toks, cache)
    got_logits, got_cache = pp.pp_decode_step(
        params, CFG, pipe_tp_mesh, toks, cache, tp_axis="model"
    )
    assert (
        np.asarray(jnp.argmax(got_logits, -1))
        == np.asarray(jnp.argmax(want_logits, -1))
    ).all()
    np.testing.assert_allclose(
        np.asarray(got_cache.k, np.float32),
        np.asarray(want_cache.k, np.float32), rtol=5e-2, atol=3e-2,
    )


def test_pp_rejects_bad_inputs(pipe_mesh):
    unstacked = llama.init_params(jax.random.PRNGKey(0), CFG, bits=4,
                                  group_size=32)
    cache = llama.KVCache.init(CFG, 4)
    with pytest.raises(ValueError, match="stacked"):
        pp.pp_decode_step(
            unstacked, CFG, pipe_mesh, jnp.zeros((4,), jnp.int32), cache)
    params = _params()
    with pytest.raises(ValueError, match="divide the pipe"):
        pp.pp_decode_step(
            params, CFG, pipe_mesh, jnp.zeros((3,), jnp.int32), cache)
