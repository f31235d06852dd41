"""Structured synthetic models: dense checkpoints with *learnable sequence
structure* (deterministic token-successor cycles) instead of random-normal
noise.

Why this exists (round-2 verdict items 2 and 6): the zero-egress environment
blocks real checkpoint downloads, and a random-weight model has near-uniform
logits — perplexity parity is vacuous and the n-gram speculative draft never
matches.  A successor-structured model gives both surfaces teeth:

- the dense model predicts each token's successor with ~certainty, so
  quantize -> generate has a REAL perplexity to preserve (the reference's own
  validation was against real model-layer fixtures, /root/reference/src/main.cc:11-82);
- greedy continuations are periodic with period ``cycle``, so the engine's
  prompt-lookup draft achieves high acceptance — speculative decoding can be
  demonstrated honestly end-to-end.

Token space is partitioned into blocks of ``cycle`` consecutive ids; the
successor of token t is the next id within its block (wrapping), so greedy
generation walks t's block forever: ``16 17 18 19 20 21 22 23 16 17 ...``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from xbitops.models.llama import LlamaConfig


def successor(tok, cycle: int):
    """Next token id in ``tok``'s cycle block (vectorized, numpy or jnp)."""
    base = (tok // cycle) * cycle
    return base + (tok - base + 1) % cycle


def successor_stream(start: int, n: int, cycle: int) -> np.ndarray:
    """n-token greedy continuation the structured model should emit."""
    out = np.empty(n, np.int64)
    t = start
    for i in range(n):
        t = int(successor(t, cycle))
        out[i] = t
    return out


def structured_dense_params(
    cfg: LlamaConfig,
    cycle: int = 8,
    seed: int = 0,
    logit_scale: float = 0.1,
    layer_scale: float = 0.02,
) -> dict:
    """Dense bf16 params whose greedy output is the successor walk.

    embed rows are random (quasi-orthogonal at hidden >= 128); lm_head column
    v is ``logit_scale * embed[predecessor(v)]`` so after the residual stream
    (small random layers riding on the embedding) the argmax logit is the
    successor.  Layer weights are small-but-nonzero so GPTQ has real weights
    to quantize and the structure survives 4-bit rounding.
    """
    V, h = cfg.vocab_size, cfg.hidden_size
    if cfg.vocab_size % cycle:
        raise ValueError("vocab_size must be a multiple of cycle")
    rng = np.random.default_rng(seed)
    embed = rng.standard_normal((V, h)).astype(np.float32)
    pred = np.asarray(
        [(v // cycle) * cycle + (v - (v // cycle) * cycle - 1) % cycle
         for v in range(V)], np.int64
    )
    lm_head = (logit_scale * embed[pred]).T.astype(np.float32)  # [h, V]

    def dense(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    qdim = cfg.num_heads * cfg.head_dim
    kvdim = cfg.num_kv_heads * cfg.head_dim
    ffn = cfg.intermediate_size
    layers = []
    for _ in range(cfg.num_layers):
        layers.append(
            dict(
                wq=jnp.asarray(dense((h, qdim), layer_scale), jnp.bfloat16),
                wk=jnp.asarray(dense((h, kvdim), layer_scale), jnp.bfloat16),
                wv=jnp.asarray(dense((h, kvdim), layer_scale), jnp.bfloat16),
                wo=jnp.asarray(dense((qdim, h), layer_scale), jnp.bfloat16),
                w_gate=jnp.asarray(dense((h, ffn), layer_scale), jnp.bfloat16),
                w_up=jnp.asarray(dense((h, ffn), layer_scale), jnp.bfloat16),
                w_down=jnp.asarray(dense((ffn, h), layer_scale), jnp.bfloat16),
                ln_attn=jnp.ones((h,), jnp.float32),
                ln_mlp=jnp.ones((h,), jnp.float32),
            )
        )
    return dict(
        embed=jnp.asarray(embed, jnp.bfloat16),
        lm_head=jnp.asarray(lm_head, jnp.bfloat16),
        ln_final=jnp.ones((h,), jnp.float32),
        layers=layers,
    )


def write_hf_dense_checkpoint(params: dict, cfg: LlamaConfig, path: str) -> None:
    """Write ``params`` as a dense HF-layout safetensors dir (the input format
    of the ``quantize`` CLI; weights stored [out, in] like HF Linear)."""
    from safetensors import numpy as st_np

    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    t = {}
    for i, layer in enumerate(params["layers"]):
        pre = f"model.layers.{i}"
        t[f"{pre}.self_attn.q_proj.weight"] = np.asarray(layer["wq"], np.float32).T.copy()
        t[f"{pre}.self_attn.k_proj.weight"] = np.asarray(layer["wk"], np.float32).T.copy()
        t[f"{pre}.self_attn.v_proj.weight"] = np.asarray(layer["wv"], np.float32).T.copy()
        t[f"{pre}.self_attn.o_proj.weight"] = np.asarray(layer["wo"], np.float32).T.copy()
        t[f"{pre}.mlp.gate_proj.weight"] = np.asarray(layer["w_gate"], np.float32).T.copy()
        t[f"{pre}.mlp.up_proj.weight"] = np.asarray(layer["w_up"], np.float32).T.copy()
        t[f"{pre}.mlp.down_proj.weight"] = np.asarray(layer["w_down"], np.float32).T.copy()
        t[f"{pre}.input_layernorm.weight"] = np.asarray(layer["ln_attn"], np.float32)
        t[f"{pre}.post_attention_layernorm.weight"] = np.asarray(layer["ln_mlp"], np.float32)
    t["model.embed_tokens.weight"] = np.asarray(params["embed"], np.float32)
    t["lm_head.weight"] = np.asarray(params["lm_head"], np.float32).T.copy()
    t["model.norm.weight"] = np.asarray(params["ln_final"], np.float32)
    st_np.save_file(t, str(p / "model.safetensors"))
    (p / "config.json").write_text(
        json.dumps(
            dict(
                model_type="llama",
                vocab_size=cfg.vocab_size,
                hidden_size=cfg.hidden_size,
                intermediate_size=cfg.intermediate_size,
                num_hidden_layers=cfg.num_layers,
                num_attention_heads=cfg.num_heads,
                num_key_value_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim,
                rope_theta=cfg.rope_theta,
                rms_norm_eps=cfg.rms_eps,
                max_position_embeddings=cfg.max_seq_len,
            )
        )
    )


def structured_moe_params(
    cfg,
    cycle: int = 8,
    seed: int = 0,
    logit_scale: float = 0.1,
    layer_scale: float = 0.02,
) -> dict:
    """Mixtral-shaped structured model: the dense successor model's attention
    + embed/lm_head, with each layer's FFN replaced by a router + stacked
    DENSE experts (``moe_ffn`` runs them through its dense branch).  The
    successor structure rides the residual stream exactly as in
    :func:`structured_dense_params`, so the MoE quantize -> generate proxy
    has a real perplexity to lose."""
    from xbitops.models.moe import MoeConfig

    assert isinstance(cfg, MoeConfig)
    params = structured_dense_params(
        cfg, cycle=cycle, seed=seed, logit_scale=logit_scale,
        layer_scale=layer_scale)
    rng = np.random.default_rng(seed + 1)
    h, ffn, E = cfg.hidden_size, cfg.intermediate_size, cfg.n_experts

    def dense(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    for layer in params["layers"]:
        for k in ("w_gate", "w_up", "w_down"):
            del layer[k]
        layer["router"] = jnp.asarray(dense((h, E), h ** -0.5), jnp.float32)
        layer["w_experts_gateup"] = jnp.asarray(
            dense((E, h, 2 * ffn), layer_scale), jnp.bfloat16)
        layer["w_experts_down"] = jnp.asarray(
            dense((E, ffn, h), layer_scale), jnp.bfloat16)
    return params


def write_hf_mixtral_checkpoint(params: dict, cfg, path: str) -> None:
    """Write a dense structured MoE model as an HF-layout Mixtral checkpoint
    (``block_sparse_moe.gate`` + ``experts.{e}.w1/w2/w3``, weights [out, in]
    like HF Linear) — the input format of the ``quantize`` CLI for MoE."""
    from safetensors import numpy as st_np

    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    ffn = cfg.intermediate_size
    t = {}
    for i, layer in enumerate(params["layers"]):
        pre = f"model.layers.{i}"
        t[f"{pre}.self_attn.q_proj.weight"] = np.asarray(layer["wq"], np.float32).T.copy()
        t[f"{pre}.self_attn.k_proj.weight"] = np.asarray(layer["wk"], np.float32).T.copy()
        t[f"{pre}.self_attn.v_proj.weight"] = np.asarray(layer["wv"], np.float32).T.copy()
        t[f"{pre}.self_attn.o_proj.weight"] = np.asarray(layer["wo"], np.float32).T.copy()
        t[f"{pre}.block_sparse_moe.gate.weight"] = np.asarray(
            layer["router"], np.float32).T.copy()
        gu = np.asarray(layer["w_experts_gateup"], np.float32)  # [E, h, 2ffn]
        down = np.asarray(layer["w_experts_down"], np.float32)  # [E, ffn, h]
        for e in range(cfg.n_experts):
            ep = f"{pre}.block_sparse_moe.experts.{e}"
            t[f"{ep}.w1.weight"] = gu[e, :, :ffn].T.copy()
            t[f"{ep}.w3.weight"] = gu[e, :, ffn:].T.copy()
            t[f"{ep}.w2.weight"] = down[e].T.copy()
        t[f"{pre}.input_layernorm.weight"] = np.asarray(layer["ln_attn"], np.float32)
        t[f"{pre}.post_attention_layernorm.weight"] = np.asarray(layer["ln_mlp"], np.float32)
    t["model.embed_tokens.weight"] = np.asarray(params["embed"], np.float32)
    t["lm_head.weight"] = np.asarray(params["lm_head"], np.float32).T.copy()
    t["model.norm.weight"] = np.asarray(params["ln_final"], np.float32)
    st_np.save_file(t, str(p / "model.safetensors"))
    (p / "config.json").write_text(
        json.dumps(
            dict(
                model_type="mixtral",
                vocab_size=cfg.vocab_size,
                hidden_size=cfg.hidden_size,
                intermediate_size=cfg.intermediate_size,
                num_hidden_layers=cfg.num_layers,
                num_attention_heads=cfg.num_heads,
                num_key_value_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim,
                rope_theta=cfg.rope_theta,
                rms_norm_eps=cfg.rms_eps,
                max_position_embeddings=cfg.max_seq_len,
                num_local_experts=cfg.n_experts,
                num_experts_per_tok=cfg.experts_per_token,
            )
        )
    )


def structured_calib_tokens(
    cfg: LlamaConfig, cycle: int, n_rows: int, seq_len: int, seed: int = 1
) -> np.ndarray:
    """Calibration streams that follow the successor structure (random block
    starts, then the deterministic walk) — the data distribution the model
    'was trained on'."""
    rng = np.random.default_rng(seed)
    rows = np.empty((n_rows, seq_len), np.int64)
    for r in range(n_rows):
        t = int(rng.integers(0, cfg.vocab_size))
        rows[r, 0] = t
        for i in range(1, seq_len):
            t = int(successor(t, cycle))
            rows[r, i] = t
    return rows
