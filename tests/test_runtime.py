"""Backend and run-time plumbing: interpret-mode choice, compile cache,
in-place KV writes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xbitops.kernels import common
from xbitops.models import llama
from xbitops.utils import compile_cache


@pytest.mark.parametrize("backend,interpret", [("cpu", True), ("gpu", False), ("tpu", None)])
def test_interpret_choice(backend, interpret):
    """The CPU test harness interprets, the GPU compiles, and any other
    backend raises instead of falling back to the interpreter."""
    if interpret is None:
        with pytest.raises(RuntimeError):
            common.interpret_for(backend)
    else:
        assert common.interpret_for(backend) is interpret


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_compile_cache_default_is_fixed(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    first = compile_cache.cache_dir()
    assert first == compile_cache.cache_dir()
    root = os.path.dirname(os.path.dirname(os.path.abspath(llama.__file__)))
    assert first == os.path.join(os.path.dirname(root), ".jax_cache")
    assert str(os.getpid()) not in first


def _scatter_ref(cache, k, positions, li, rows):
    """numpy reference: cache[li, b, :, p, :] = k[b, t] for p < S."""
    out = np.array(cache)
    S = out.shape[3]
    for b, row in enumerate(rows):
        for t, p in enumerate(positions[b]):
            if p < S and row < out.shape[1]:
                out[li, row, :, p, :] = k[b, t]
    return out


@pytest.mark.parametrize("quantized", [False, True])
def test_write_kv_matches_scatter(quantized):
    """Decode (T=1) and prefill-slab (T=8) writes land exactly where a
    plain scatter puts them, drop positions >= S and leave everything else
    untouched — for the bf16 cache and the packed int8 cache."""
    L, B, Hkv, S, D, li = 2, 3, 2, 32, 16, 1
    rng = np.random.default_rng(quantized)
    cfg = llama.LlamaConfig(num_layers=L, num_kv_heads=Hkv, head_dim=D,
                            max_seq_len=S)
    cache = llama.KVCache.init(cfg, B, quantized=quantized)
    if not quantized:
        cache = llama.KVCache(
            k=jnp.asarray(rng.standard_normal(cache.k.shape), jnp.bfloat16),
            v=jnp.asarray(rng.standard_normal(cache.v.shape), jnp.bfloat16),
            lengths=cache.lengths)
    kv = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    rows = np.array([2, 0, 1])
    for positions in (np.array([[5], [S], [31]]),
                      np.array([[8 + t for t in range(8)], [0 + t for t in range(8)],
                                [S] * 8])):
        T = positions.shape[1]
        k = jnp.asarray(rng.standard_normal((B, T, Hkv, D)), jnp.bfloat16)
        v = jnp.asarray(rng.standard_normal((B, T, Hkv, D)), jnp.bfloat16)
        pos = jnp.asarray(positions, jnp.int32)
        out = jax.jit(llama.write_kv, static_argnums=(4,))(
            kv, k, v, pos, li, jnp.asarray(rows, jnp.int32))
        if quantized:
            # dequantize the written cache and compare with the quantized rows
            kd = np.asarray(llama._unpack_kv_words(out[0][li], out[2][li]))
            kq, ks = llama._quant_kv(k)
            want = ((np.asarray(kq) - 128) * np.asarray(
                ks.astype(jnp.bfloat16), np.float32)[..., None])
            base = np.asarray(llama._unpack_kv_words(kv[0][li], kv[2][li]))
            ref = _scatter_ref(base[None], np.asarray(want), positions, 0, rows)[0]
            np.testing.assert_allclose(kd, ref, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(
                np.asarray(out[0], np.float32),
                _scatter_ref(np.asarray(kv[0], np.float32),
                             np.asarray(k, np.float32), positions, li, rows))
            np.testing.assert_array_equal(
                np.asarray(out[1][1 - li]), np.asarray(kv[1][1 - li]))
        kv = out
