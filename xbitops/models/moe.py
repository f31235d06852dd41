"""Mixtral-style sparse Mixture-of-Experts on the quantized stack.

The reference is a kernel library with no model code at all (SURVEY §1); the
rebuild's Llama decoder gains an MoE FFN here:

- Expert weights are ONE stacked :class:`~xbitops.formats.QTensor` per
  projection with a leading expert axis — the fused matmul reads expert
  ``e``'s planes IN PLACE via the same index operand the
  scan-over-layers path uses (``qmatmul(layer=e)``), so expert loops carry
  zero weight copies.
- Dispatch is scatter/gather based (token ``n``'s k-th route lands in slot
  ``e*C + position_among_e``; over-capacity routes drop, the standard
  top-k trade) — no materialized ``[N, k, E, C]`` dispatch tensor, so
  chunked prefill shapes stay cheap.
- Expert parallelism shards the EXPERT axis of the stacked QTensors over a
  mesh axis: each device runs its local experts on the (replicated) token
  batch and the combine ``psum``s partial outputs — the weight-memory win
  EP exists for, with no all-to-all on the replicated-batch inference path.

MoE layers run UNROLLED (``stack_layers`` rejects them: a second stacking
axis would break the expert index); the engine's try/except falls back to
the per-layer list automatically, so continuous batching, spec decoding and
the int8/paged caches all work unchanged on MoE models.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from xbitops.formats import QTensor
from xbitops.models import llama
from xbitops.ops.qmatmul import qmatmul
from xbitops.ops.quantize import quantize_array

__all__ = ["MoeConfig", "init_moe_params", "moe_ffn", "expert_pspecs",
           "ep_decode_step", "ep_prefill_slots"]


@dataclasses.dataclass(frozen=True)
class MoeConfig(llama.LlamaConfig):
    n_experts: int = 8
    experts_per_token: int = 2
    # capacity per expert = ceil(tokens * k / E * capacity_factor); routes
    # past an expert's capacity drop (keep only the token's other routes).
    # None = NO-DROP mode (capacity = token count: top-k routes are distinct
    # experts, so an expert sees at most N routes) — exact inference
    # semantics matching dense per-token evaluation; checkpoint loads
    # default to it (io/gptq_loader.py) since real Mixtral inference never
    # drops routes.
    capacity_factor: Optional[float] = 2.0

    @staticmethod
    def mixtral_like(**kw) -> "MoeConfig":
        """Mixtral-8x7B-shaped: Llama-7B attention dims, 8 experts, top-2."""
        return MoeConfig(
            intermediate_size=14336, num_kv_heads=8, n_experts=8,
            experts_per_token=2, **kw,
        )

    @staticmethod
    def tiny_moe(vocab: int = 256, seq: int = 64) -> "MoeConfig":
        return MoeConfig(
            vocab_size=vocab, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
            max_seq_len=seq, n_experts=4, experts_per_token=2,
        )


def stack_experts(qts) -> QTensor:
    """Stack per-expert QTensors into one with a leading expert axis (the
    same leaf-stacking ``stack_layers`` does for layers)."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *qts)


def init_moe_params(
    key: jax.Array,
    cfg: MoeConfig,
    bits: Optional[int] = 4,
    group_size: int = 128,
    dtype=jnp.bfloat16,
) -> dict:
    """Random MoE model: Llama attention + router + E quantized experts per
    layer.  Layer dicts carry ``router`` / ``w_experts_gateup`` /
    ``w_experts_down`` — ``llama.forward`` routes the FFN through
    :func:`moe_ffn` when it sees them."""
    h, ffn, E = cfg.hidden_size, cfg.intermediate_size, cfg.n_experts
    qdim = cfg.num_heads * cfg.head_dim
    kvdim = cfg.num_kv_heads * cfg.head_dim
    s = h ** -0.5

    def q(key, kdim, ndim, scale):
        w = (jax.random.normal(key, (kdim, ndim), jnp.float32) * scale)
        if bits is None:
            return w.astype(dtype)
        return quantize_array(w, bits, group_size)

    keys = jax.random.split(key, cfg.num_layers * (3 + 2 * E) + 3)
    ki = iter(range(len(keys)))
    layers = []
    for _ in range(cfg.num_layers):
        gu = stack_experts(
            [q(keys[next(ki)], h, 2 * ffn, s) for _ in range(E)])
        down = stack_experts(
            [q(keys[next(ki)], ffn, h, ffn ** -0.5) for _ in range(E)])
        layers.append(dict(
            wqkv=q(keys[next(ki)], h, qdim + 2 * kvdim, s),
            wo=q(keys[next(ki)], qdim, h, s),
            router=(jax.random.normal(
                keys[next(ki)], (h, E), jnp.float32) * s).astype(jnp.float32),
            w_experts_gateup=gu,
            w_experts_down=down,
            ln_attn=jnp.ones((h,), jnp.float32),
            ln_mlp=jnp.ones((h,), jnp.float32),
        ))
    return dict(
        embed=(jax.random.normal(keys[-3], (cfg.vocab_size, h), jnp.float32)
               * 0.02).astype(dtype),
        lm_head=q(keys[-2], h, cfg.vocab_size, s),
        ln_final=jnp.ones((h,), jnp.float32),
        layers=layers,
    )


def moe_ffn(
    hx: jax.Array,  # [B, T, h] (post-norm residual input)
    layer: dict,
    cfg: MoeConfig,
    expert_axis: Optional[str] = None,
    a8: bool = False,
) -> jax.Array:
    """Top-k routed expert FFN; returns the FFN output [B, T, h].

    With ``expert_axis`` the stacked expert QTensors are LOCAL shards of the
    expert axis (E_local = E / axis size); each device computes its experts'
    contributions and the result is ``psum``-combined."""
    B, T, h = hx.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    w_gu, w_down = layer["w_experts_gateup"], layer["w_experts_down"]
    dense = not isinstance(w_gu, QTensor)  # [E, K, N] stacked dense experts
    if not dense and w_gu.planes[0].ndim > 3:
        raise ValueError(
            "MoE expert QTensors must keep a single (expert) stacking axis — "
            "MoE layers run unrolled, not through stack_layers"
        )
    N = B * T
    if cfg.capacity_factor is None:
        C = N  # no-drop: top-k indices are distinct -> <= N routes/expert
    else:
        C = max(1, math.ceil(N * k * cfg.capacity_factor / E))
    x = hx.reshape(N, h)
    logits = jnp.dot(
        x.astype(jnp.float32), layer["router"].astype(jnp.float32)
    )  # [N, E]
    gate, idx = lax.top_k(logits, k)  # [N, k]
    probs = jax.nn.softmax(gate, axis=-1).astype(jnp.float32)
    # slot assignment: the j-th token routed to expert e takes slot e*C + j
    # (j counted row-major over (n, k)); slots past capacity drop
    onehot = (idx[..., None] == jnp.arange(E)[None, None, :])  # [N, k, E]
    flat = onehot.reshape(N * k, E).astype(jnp.int32)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat) * flat, axis=1)  # [N*k]
    pos = pos.reshape(N, k)
    keep = pos < C
    n_stacked = w_gu.shape[0] if dense else w_gu.planes[0].shape[0]
    if expert_axis is not None:
        El = n_stacked
        e0 = lax.axis_index(expert_axis) * El
        local = (idx >= e0) & (idx < e0 + El)
        slot = jnp.where(keep & local, (idx - e0) * C + pos, El * C)
    else:
        El = E
        slot = jnp.where(keep, idx * C + pos, E * C)  # OOB drops (positive!)
    x_rep = jnp.broadcast_to(x[:, None, :], (N, k, h)).reshape(N * k, h)
    xe = jnp.zeros((El * C, h), hx.dtype).at[slot.reshape(-1)].add(
        x_rep.astype(hx.dtype), mode="drop"
    ).reshape(El, C, h)

    ffn = cfg.intermediate_size

    def one_expert(_, e):
        if dense:
            gu = jnp.dot(xe[e], w_gu[e].astype(hx.dtype))
        else:
            gu = qmatmul(xe[e], w_gu, out_dtype=hx.dtype, layer=e, a8=a8)
        act = (jax.nn.silu(gu[..., :ffn].astype(jnp.float32))
               * gu[..., ffn:].astype(jnp.float32)).astype(hx.dtype)
        if dense:
            return None, jnp.dot(act, w_down[e].astype(hx.dtype),
                                 preferred_element_type=jnp.float32)
        return None, qmatmul(act, w_down, out_dtype=jnp.float32, layer=e,
                             a8=a8)

    _, ye = lax.scan(one_expert, None, jnp.arange(El))  # [El, C, h] f32
    y_nk = ye.reshape(El * C, h).at[slot].get(
        mode="fill", fill_value=0.0
    )  # [N, k, h]; dropped/non-local routes contribute zero
    y = jnp.sum(y_nk * probs[..., None], axis=1)  # [N, h]
    if expert_axis is not None:
        y = lax.psum(y, expert_axis)
    return y.reshape(B, T, h).astype(hx.dtype)


# --- expert parallelism (shard_map entry points) ---


def expert_pspecs(params: dict, axis: str = "expert") -> dict:
    """Specs: expert-stacked QTensor leaves shard dim 0 over ``axis``;
    everything else (attention, router, embed, head, cache) replicates —
    EP trades replicated activations for sharded expert weights."""
    def layer_specs(layer):
        out = {}
        for key, w in layer.items():
            if key.startswith("w_experts"):
                out[key] = jax.tree.map(lambda _: P(axis), w)
            else:
                out[key] = jax.tree.map(lambda _: P(None), w) if isinstance(
                    w, QTensor) else P(None)
        return out

    return dict(
        embed=P(None),
        lm_head=jax.tree.map(lambda _: P(None), params["lm_head"])
        if isinstance(params["lm_head"], QTensor) else P(None),
        ln_final=P(None),
        layers=[layer_specs(l) for l in params["layers"]],
    )


def _ep_call(params, cfg, mesh, cache, axis, fn):
    pspecs = expert_pspecs(params, axis)
    cspecs = jax.tree.map(lambda _: P(None), cache)

    rt = llama.Runtime()
    rt.expert_axis = axis

    def wrapped(params_l, cache_l, *args):
        return fn(params_l, cache_l, rt, *args)

    return pspecs, cspecs, wrapped


def ep_decode_step(
    params: dict,
    cfg: MoeConfig,
    mesh: Mesh,
    tokens: jax.Array,
    cache: llama.KVCache,
    axis: str = "expert",
    active: Optional[jax.Array] = None,
):
    """Expert-parallel :func:`~xbitops.models.llama.decode_step`."""
    pspecs, cspecs, wrapped = _ep_call(
        params, cfg, mesh, cache, axis,
        lambda p, c, rt, t, a: llama.decode_step(p, cfg, t, c, rt, active=a),
    )
    if active is None:
        active = jnp.ones(tokens.shape, bool)
    f = shard_map(
        wrapped, mesh=mesh,
        in_specs=(pspecs, cspecs, P(None), P(None)),
        out_specs=(P(None, None), cspecs),
        check_vma=False,
    )
    return f(params, cache, tokens, jnp.asarray(active))


def ep_prefill_slots(
    params: dict,
    cfg: MoeConfig,
    mesh: Mesh,
    tokens: jax.Array,
    true_lens: jax.Array,
    slots: jax.Array,
    cache: llama.KVCache,
    axis: str = "expert",
):
    """Expert-parallel :func:`~xbitops.models.llama.prefill_slots`."""
    pspecs, cspecs, wrapped = _ep_call(
        params, cfg, mesh, cache, axis,
        lambda p, c, rt, t, tl, sl: llama.prefill_slots(
            p, cfg, t, tl, sl, c, rt),
    )
    f = shard_map(
        wrapped, mesh=mesh,
        in_specs=(pspecs, cspecs, P(None, None), P(None), P(None)),
        out_specs=(P(None, None), cspecs),
        check_vma=False,
    )
    return f(params, cache, tokens, jnp.asarray(true_lens),
             jnp.asarray(slots))
