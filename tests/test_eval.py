"""Act-order path + perplexity parity (model level).

A randomly-initialized model has near-uniform output, so perplexity parity is
checked as: quantized perplexities (plain and act-order) stay within a small
envelope of the dense model's on the same token stream, and the act-order
model's forward equals a manual gather-based oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import xbitops as xb
from xbitops import formats
from xbitops.models import llama
from xbitops.utils.evaluate import perplexity, sequence_nll

CFG = llama.LlamaConfig.tiny()


@pytest.fixture(scope="module")
def token_stream():
    return jax.random.randint(jax.random.PRNGKey(0), (4, 24), 0, CFG.vocab_size)


def test_act_order_quantize_array_roundtrip():
    """act_order QTensor dequantizes to the logical (unpermuted) weight and
    matmuls equal the gather-oracle."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((256, 128)) * 0.1).astype(np.float32)
    qt = xb.quantize_array(jnp.asarray(w), 4, 64, act_order=True)
    assert qt.perm is not None
    wd = np.asarray(formats.dequant_qtensor_reference(qt, out_dtype=jnp.float32))
    # quantization error bounded by half a step of each group's scale
    step = np.asarray(formats.decode_scale_store(qt.scales)).max()
    assert np.abs(wd - w).max() <= 0.6 * step

    a = (rng.standard_normal((4, 256)) * 0.5).astype(np.float32)
    got = np.asarray(xb.qmatmul(jnp.asarray(a), qt, out_dtype=jnp.float32, precise=True))
    np.testing.assert_allclose(got, a @ wd, rtol=1e-5, atol=3e-4)


def test_perplexity_parity_quantized(token_stream):
    dense = llama.init_params(jax.random.PRNGKey(1), CFG, bits=None)
    # quantize THE SAME dense weights (not re-drawn) for a true parity check
    q_plain = _quantize_params(dense, act_order=False)
    q_ao = _quantize_params(dense, act_order=True)

    p_dense = perplexity(dense, CFG, token_stream)
    p_plain = perplexity(q_plain, CFG, token_stream)
    p_ao = perplexity(q_ao, CFG, token_stream)
    # 4-bit on a random tiny model: distributions stay close to dense
    assert abs(np.log(p_plain) - np.log(p_dense)) < 0.15, (p_plain, p_dense)
    assert abs(np.log(p_ao) - np.log(p_dense)) < 0.15, (p_ao, p_dense)
    # act-order should not be (much) worse than plain grouping
    assert np.log(p_ao) < np.log(p_plain) + 0.1, (p_ao, p_plain)


def _quantize_params(dense: dict, act_order: bool) -> dict:
    def qz(w):
        return xb.quantize_array(jnp.asarray(w, jnp.float32), 4, 32, act_order=act_order)

    layers = []
    for layer in dense["layers"]:
        nl = dict(layer)
        for key in ("wqkv", "w_gateup", "wo", "w_down"):
            nl[key] = qz(layer[key])
        layers.append(nl)
    return dict(dense, layers=layers, lm_head=qz(dense["lm_head"]))


def test_act_order_decode_runs(token_stream):
    params = llama.init_params(jax.random.PRNGKey(2), CFG, bits=4, group_size=32,
                               act_order=True)
    cache = llama.KVCache.init(CFG, 2)
    logits, cache = llama.decode_step(params, CFG, jnp.zeros(2, jnp.int32), cache)
    assert bool(jnp.all(jnp.isfinite(logits.astype(jnp.float32))))
    nll = sequence_nll(params, CFG, token_stream)
    assert nll.shape == (4,) and bool(jnp.all(jnp.isfinite(nll)))


def test_perplexity_parity_a8_prefill(token_stream):
    """W4A8 prefill (int8 activations): perplexity within noise of the
    W4A16 model on the same stream (VERDICT round-2 item 2's gate)."""
    import dataclasses

    dense = llama.init_params(jax.random.PRNGKey(1), CFG, bits=None)
    q = _quantize_params(dense, act_order=False)
    cfg8 = dataclasses.replace(CFG, prefill_a8=True)
    # T must clear the a8 activation threshold (32) or the flag is inert
    stream = jax.random.randint(jax.random.PRNGKey(7), (2, 48), 0, CFG.vocab_size)
    p_w4a16 = perplexity(q, CFG, stream)
    p_w4a8 = perplexity(q, cfg8, stream)
    assert p_w4a8 != p_w4a16  # the int8 path actually ran
    assert abs(np.log(p_w4a8) - np.log(p_w4a16)) < 0.05, (p_w4a8, p_w4a16)
