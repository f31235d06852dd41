"""Mixture-of-Experts tests: routed FFN vs a per-token dense oracle, model
integration (prefill/decode/engine), capacity drops, expert parallelism on
the 8-virtual-device CPU mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xbitops import formats
from xbitops.engine.engine import Engine, Request
from xbitops.models import llama, moe

CFG = moe.MoeConfig.tiny_moe()


@pytest.fixture(scope="module")
def params():
    return moe.init_moe_params(jax.random.PRNGKey(0), CFG, bits=4,
                               group_size=32)


def _dense_expert(qt, e):
    """Dequantized f32 weight of expert e from the stacked QTensor."""
    one = jax.tree.map(lambda x: x[e], qt)
    return formats.dequant_qtensor_reference(one, out_dtype=jnp.float32)


def _oracle_ffn(hx, layer, cfg):
    """Per-token loop: softmax(top-k router) mixture of dense expert FFNs
    (no capacity limit)."""
    B, T, h = hx.shape
    x = np.asarray(hx.reshape(B * T, h), np.float32)
    logits = x @ np.asarray(layer["router"], np.float32)
    E, k, ffn = cfg.n_experts, cfg.experts_per_token, cfg.intermediate_size
    gus = [np.asarray(_dense_expert(layer["w_experts_gateup"], e)) for e in range(E)]
    downs = [np.asarray(_dense_expert(layer["w_experts_down"], e)) for e in range(E)]
    out = np.zeros_like(x)
    for n in range(x.shape[0]):
        top = np.argsort(-logits[n])[:k]
        p = np.exp(logits[n][top] - logits[n][top].max())
        p /= p.sum()
        for w, e in zip(p, top):
            gu = x[n] @ gus[e]
            gate, up = gu[:ffn], gu[ffn:]
            act = gate / (1 + np.exp(-gate)) * up
            out[n] += w * (act @ downs[e])
    return out.reshape(B, T, h)


def test_moe_ffn_matches_dense_oracle(params):
    layer = params["layers"][0]
    hx = jax.random.normal(jax.random.PRNGKey(3), (2, 5, CFG.hidden_size),
                           jnp.bfloat16) * 0.5
    cfg = dataclasses.replace(CFG, capacity_factor=float(CFG.n_experts))
    got = np.asarray(moe.moe_ffn(hx, layer, cfg), np.float32)
    want = _oracle_ffn(hx, layer, cfg)
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


def _qmatmul_oracle(hx, layer, cfg):
    """Per-token loop through the SAME qmatmul the dispatch path uses —
    isolates the routing/scatter/combine machinery at f32-tight tolerance
    (quantization numerics are gated separately vs the dense oracle)."""
    from xbitops.ops.qmatmul import qmatmul

    B, T, h = hx.shape
    k, ffn = cfg.experts_per_token, cfg.intermediate_size
    x = hx.reshape(B * T, h)
    logits = jnp.dot(
        x.astype(jnp.float32), layer["router"].astype(jnp.float32))
    # identical routing ops to moe_ffn (bitwise-equal gate weights)
    gate, idx = jax.lax.top_k(logits, k)
    probs = np.asarray(jax.nn.softmax(gate, axis=-1))
    out = np.zeros((B * T, h), np.float32)
    for n in range(x.shape[0]):
        for w, e in zip(probs[n], np.asarray(idx[n])):
            gu = qmatmul(x[n : n + 1], layer["w_experts_gateup"],
                         out_dtype=hx.dtype, layer=int(e))
            act = (jax.nn.silu(gu[..., :ffn].astype(jnp.float32))
                   * gu[..., ffn:].astype(jnp.float32)).astype(hx.dtype)
            y = qmatmul(act, layer["w_experts_down"],
                        out_dtype=jnp.float32, layer=int(e))
            out[n] += w * np.asarray(y[0], np.float32)
    return out.reshape(B, T, h)


def test_moe_nodrop_exact_vs_per_token(params):
    """capacity_factor=None (inference no-drop mode): the batched dispatch
    must match the per-token evaluation at f32-tight tolerance — nothing
    drops, every route's contribution is exact."""
    layer = params["layers"][0]
    # f32 activations: no output-dtype rounding masks a dispatch bug
    hx = jax.random.normal(jax.random.PRNGKey(11), (2, 7, CFG.hidden_size),
                           jnp.float32) * 0.5
    cfg = dataclasses.replace(CFG, capacity_factor=None)
    got = np.asarray(moe.moe_ffn(hx, layer, cfg), np.float32)
    want = _qmatmul_oracle(hx, layer, cfg)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_moe_nodrop_adversarial_routing(params):
    """All tokens routed to the SAME experts (identical inputs) — the case
    capacity factors drop hardest; no-drop mode must stay exact."""
    layer = params["layers"][0]
    row = jax.random.normal(jax.random.PRNGKey(12), (1, 1, CFG.hidden_size),
                            jnp.float32) * 0.5
    hx = jnp.broadcast_to(row, (1, 9, CFG.hidden_size))
    cfg = dataclasses.replace(CFG, capacity_factor=None)
    got = np.asarray(moe.moe_ffn(hx, layer, cfg), np.float32)
    want = _qmatmul_oracle(hx, layer, cfg)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # a finite capacity factor WOULD have dropped here: 9 tokens * 2 routes
    # onto the same 2 experts exceeds ceil(9*2*1.0/4) = 5 slots per expert
    dropped = np.asarray(
        moe.moe_ffn(hx, layer, dataclasses.replace(CFG, capacity_factor=1.0)),
        np.float32)
    assert np.abs(dropped - want).max() > 1e-3


def test_moe_capacity_drops(params):
    """With capacity 1 most routes drop; kept routes still match the oracle
    contribution-for-contribution (drop = zero contribution, never garbage)."""
    layer = params["layers"][0]
    N = 6
    hx = jax.random.normal(jax.random.PRNGKey(4), (1, N, CFG.hidden_size),
                           jnp.bfloat16) * 0.5
    tiny_cap = dataclasses.replace(
        CFG, capacity_factor=CFG.n_experts / (N * CFG.experts_per_token))
    got = np.asarray(moe.moe_ffn(hx, layer, tiny_cap), np.float32)
    assert np.isfinite(got).all()
    # the first token routed to each expert is always kept: token 0's
    # contributions are complete, so its output matches the oracle
    want = _oracle_ffn(hx, layer, tiny_cap)
    np.testing.assert_allclose(got[0, 0], want[0, 0], rtol=5e-2, atol=5e-2)


def test_moe_model_decode_and_engine(params):
    """Full model path: prefill + decode through llama.forward, then the
    continuous-batching engine (which falls back to unrolled layers)."""
    B, T = 2, 6
    tokens = jax.random.randint(jax.random.PRNGKey(5), (B, T), 0,
                                CFG.vocab_size)
    cache = llama.KVCache.init(CFG, B)
    logits, cache = llama.prefill(params, CFG, tokens, cache)
    assert np.isfinite(np.asarray(logits, np.float32)).all()
    toks = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    logits2, cache = llama.decode_step(params, CFG, toks, cache)
    assert logits2.shape == (B, CFG.vocab_size)

    eng = Engine(params, CFG, slots=2, prefill_buckets=[8])
    out = eng.generate([
        Request(prompt=[3, 1, 4], max_new_tokens=4, id=0),
        Request(prompt=[2, 7], max_new_tokens=4, id=1),
    ])
    assert len(out) == 2 and all(len(c.tokens) == 4 for c in out)
    # greedy engine tokens == raw greedy decode (content equivalence)
    toks0, cache0 = None, llama.KVCache.init(CFG, 1)
    lg, cache0 = llama.prefill_slots(
        params, CFG, jnp.asarray([[3, 1, 4]]), jnp.asarray([3]),
        jnp.asarray([0]), cache0)
    seq = [int(jnp.argmax(lg[0]))]
    for _ in range(3):
        lg, cache0 = llama.decode_step(
            params, CFG, jnp.asarray([seq[-1]], jnp.int32), cache0)
        seq.append(int(jnp.argmax(lg[0])))
    assert out[0].tokens == seq


def test_moe_rejects_stacking(params):
    with pytest.raises(ValueError, match="unrolled"):
        llama.stack_layers(params)


def test_moe_expert_parallel(params):
    """EP over an 8-device expert mesh == single-chip (4 experts -> use a
    4-device submesh axis)."""
    from xbitops.parallel import mesh as meshlib

    mesh = meshlib.make_mesh((4,), ("expert",))
    B, T = 2, 5
    tokens = jax.random.randint(jax.random.PRNGKey(7), (B, T), 0,
                                CFG.vocab_size)
    lens = jnp.full((B,), T, jnp.int32)
    want_lg, want_cache = llama.prefill_slots(
        params, CFG, tokens, lens, jnp.arange(B), llama.KVCache.init(CFG, B))
    got_lg, got_cache = moe.ep_prefill_slots(
        params, CFG, mesh, tokens, lens, jnp.arange(B),
        llama.KVCache.init(CFG, B))
    np.testing.assert_allclose(
        np.asarray(got_lg, np.float32), np.asarray(want_lg, np.float32),
        rtol=5e-2, atol=5e-2)
    toks = jnp.argmax(want_lg, -1).astype(jnp.int32)
    want_d, _ = llama.decode_step(params, CFG, toks, want_cache)
    got_d, _ = moe.ep_decode_step(params, CFG, mesh, toks, got_cache)
    assert (
        np.asarray(jnp.argmax(got_d, -1)) == np.asarray(jnp.argmax(want_d, -1))
    ).all()
    np.testing.assert_allclose(
        np.asarray(got_cache.k, np.float32),
        np.asarray(want_cache.k, np.float32), rtol=5e-2, atol=3e-2)
