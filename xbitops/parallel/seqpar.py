"""Sequence (context) parallelism: ring attention + context-parallel prefill.

The reference has no sequence axis at all (SURVEY §5 "Long-context /
sequence parallelism: absent"); this module adds it:
long-prompt prefill with the SEQUENCE dimension sharded over a mesh axis, so
the O(T^2) attention FLOPs and the per-chunk projection FLOPs split across
chips.  Composes with tensor parallelism on a ``(seq, model)`` mesh — the
linears psum over the model axis exactly as in ``model_tp``, while k/v
chunks rotate around the seq axis.

Design (standard ring attention, blockwise online softmax):

- Each device holds a contiguous chunk of the prompt: q/k/v ``[B, T/n, ...]``.
- n steps: attend local q against the RESIDENT k/v chunk (f32 running
  max/denominator/accumulator — the same online-softmax update as the
  flash-decode kernel), then ``ppermute`` the k/v chunk to the next device
  on the ring.  ICI traffic per step is one k/v chunk; XLA overlaps the
  permute with the next step's attention math.
- Causality rides on GLOBAL positions (chunk offset + local index), so the
  mask needs no materialized [T, T] tensor — each step masks its own
  [B, Tq_local, Tk_local] window.

``sp_prefill`` runs the full model this way and produces (a) the last
token's logits and (b) the engine's replicated head-major
:class:`~xbitops.models.llama.KVCache` (k/v chunks all-gather along S at
write time — the cache feeding single-chip-per-replica decode is replicated
over the seq axis, so the gather is the price of leaving prefill).
Decode itself stays tp/dp-parallel: one token per step has no sequence
axis to shard (SURVEY §5 defers decode-time SP past the north-star configs;
prefill is where the sequence axis exists).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from xbitops.formats import QTensor
from xbitops.models import llama
from xbitops.parallel import model_tp

NEG_INF = -1e30

__all__ = ["ring_attention", "sp_prefill"]


def _ring_attention_local(q, k, v, q_pos, kv_pos, axis, scale,
                          window=None):
    """Inside shard_map: q [B, Tq, H, D] local queries, k/v [B, Tc, Hkv, D]
    the local kv chunk, positions global int32.  Returns [B, Tq, H, D].
    ``window``: sliding-window attention — query p attends (p-W, p] only
    (global positions make the mask shard-oblivious)."""
    n = jax.lax.axis_size(axis)
    B, Tq, H, D = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    qf = q.astype(jnp.float32)
    m = jnp.full((B, Tq, H, 1), NEG_INF, jnp.float32)
    l = jnp.zeros((B, Tq, H, 1), jnp.float32)
    acc = jnp.zeros((B, Tq, H, D), jnp.float32)
    perm = [(i, (i + 1) % n) for i in range(n)]
    kc, vc, pc = k, v, kv_pos
    for step in range(n):
        kk = kc.astype(jnp.float32)
        vv = vc.astype(jnp.float32)
        if rep > 1:
            kk = jnp.repeat(kk, rep, axis=2)
            vv = jnp.repeat(vv, rep, axis=2)
        s = jnp.einsum("bqhd,bkhd->bqhk", qf, kk) * scale
        vis = pc[:, None, :] <= q_pos[:, :, None]
        if window is not None:
            vis &= q_pos[:, :, None] - pc[:, None, :] < window
        s = jnp.where(vis[:, :, None, :], s, NEG_INF)
        m_new = jnp.maximum(m, jnp.max(s, axis=-1, keepdims=True))
        alpha = jnp.exp(m - m_new)
        p = jnp.exp(s - m_new)
        l = l * alpha + jnp.sum(p, axis=-1, keepdims=True)
        acc = acc * alpha + jnp.einsum("bqhk,bkhd->bqhd", p, vv)
        m = m_new
        if step < n - 1:  # after n-1 rotations every chunk has visited
            kc = jax.lax.ppermute(kc, axis, perm)
            vc = jax.lax.ppermute(vc, axis, perm)
            pc = jax.lax.ppermute(pc, axis, perm)
    return (acc / jnp.maximum(l, 1e-30)).astype(q.dtype)


def ring_attention(
    q: jax.Array,  # [B, T, H, D] (T sharded over `axis`)
    k: jax.Array,  # [B, T, Hkv, D]
    v: jax.Array,
    q_pos: jax.Array,  # int32 [B, T] global positions
    kv_pos: jax.Array,
    mesh: Mesh,
    axis: str = "seq",
    window=None,
) -> jax.Array:
    """Causal attention with the sequence axis sharded over ``axis``: each
    query attends every kv whose global position <= its own (within
    ``window`` positions when set).  Equivalent to dense causal attention
    over the gathered sequence (tests assert parity against
    :func:`~xbitops.models.llama._attention`)."""
    D = q.shape[-1]
    spec4 = P(None, axis, None, None)
    spec2 = P(None, axis)
    f = shard_map(
        partial(_ring_attention_local, axis=axis, scale=D ** -0.5,
                window=window),
        mesh=mesh,
        in_specs=(spec4, spec4, spec4, spec2, spec2),
        out_specs=spec4,
        check_vma=False,
    )
    return f(q, k, v, q_pos.astype(jnp.int32), kv_pos.astype(jnp.int32))


def _sp_block(layer, cfg, rt, x, positions, seq_axis):
    """One transformer block on a local sequence chunk: projections/MLP are
    per-chunk (mirroring ``models.llama._block``'s prefill path), attention
    rides the ring.  Returns (x, k_chunk, v_chunk head-major-less [B,Tl,Hkv,D])."""
    B, Tl, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qdim, kvdim = H * D, Hkv * D
    hx = llama.rms_norm(x, layer["ln_attn"], cfg.rms_eps)
    if "wqkv" in layer:
        qkv = rt.col(hx, layer["wqkv"])
        q = qkv[..., :qdim].reshape(B, Tl, H, D)
        k = qkv[..., qdim : qdim + kvdim].reshape(B, Tl, Hkv, D)
        v = qkv[..., qdim + kvdim :].reshape(B, Tl, Hkv, D)
    else:
        q = rt.col(hx, layer["wq"]).reshape(B, Tl, H, D)
        k = rt.col(hx, layer["wk"]).reshape(B, Tl, Hkv, D)
        v = rt.col(hx, layer["wv"]).reshape(B, Tl, Hkv, D)
    q = llama._rope(q, positions, cfg.rope_theta, cfg.rope_scaling_type,
                    cfg.rope_scaling_factor)
    k = llama._rope(k, positions, cfg.rope_theta, cfg.rope_scaling_type,
                    cfg.rope_scaling_factor)
    att = _ring_attention_local(q, k, v, positions, positions, seq_axis,
                                D ** -0.5, window=cfg.sliding_window)
    x = x + rt.row(att.reshape(B, Tl, H * D), layer["wo"])
    hx = llama.rms_norm(x, layer["ln_mlp"], cfg.rms_eps)
    if "w_gateup" in layer:
        gu = rt.col(hx, layer["w_gateup"])
        gate, up = gu[..., : cfg.intermediate_size], gu[..., cfg.intermediate_size :]
    else:
        gate = rt.col(hx, layer["w_gate"])
        up = rt.col(hx, layer["w_up"])
    act = (jax.nn.silu(gate.astype(jnp.float32)) * up.astype(jnp.float32)).astype(x.dtype)
    x = x + rt.row(act, layer["w_down"])
    return x, k, v


def sp_prefill(
    params: dict,
    cfg: llama.LlamaConfig,
    mesh: Mesh,
    tokens: jax.Array,  # int32 [B, T], T % mesh.shape[seq_axis] == 0
    cache: llama.KVCache,  # dense, slots >= B
    seq_axis: str = "seq",
    tp_axis: Optional[str] = None,
) -> Tuple[jax.Array, llama.KVCache]:
    """Context-parallel prefill of a full [B, T] prompt (all rows length T,
    like :func:`~xbitops.models.llama.prefill`): the sequence axis is
    sharded over ``seq_axis``, the linears optionally tensor-parallel over
    ``tp_axis``.  Returns (last-token logits [B, V], updated cache) — both
    replicated over the seq axis, cache head-sharded over ``tp_axis``.

    Dense bf16 caches only (the packed int8 cache quantizes per written
    block; quantized long prompts go through the engine's chunked path)."""
    if cache.quantized or cache.paged:
        raise ValueError("sp_prefill writes dense caches only")
    sp = mesh.shape[seq_axis]
    tp = mesh.shape[tp_axis] if tp_axis else 1
    local_cfg = cfg.local(tp) if tp > 1 else cfg
    rt = llama.TPRuntime(tp_axis) if tp_axis else llama.Runtime()
    B, T = tokens.shape
    if T % sp:
        raise ValueError(f"prompt length {T} must divide the seq axis ({sp})")
    if T > cache.S:
        raise ValueError(f"prompt length {T} exceeds cache capacity {cache.S}")
    if tp_axis:
        param_specs = model_tp.param_pspecs(params, tp_axis)
    else:
        param_specs = jax.tree.map(lambda _: P(), params)
    cache_specs = model_tp.cache_pspecs(tp_axis)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(param_specs, P(None, seq_axis), cache_specs),
        out_specs=(P(None, None), cache_specs),
        check_vma=False,
    )
    def f(params_l, tokens_l, cache_l):
        Tl = tokens_l.shape[1]
        off = jax.lax.axis_index(seq_axis) * Tl
        positions = jnp.broadcast_to(
            off + jnp.arange(Tl)[None, :], tokens_l.shape
        ).astype(jnp.int32)
        x = params_l["embed"][tokens_l].astype(jnp.bfloat16)
        k_all, v_all = cache_l.k, cache_l.v

        def write(k_all, v_all, li, k, v):
            # the decode cache is replicated over seq (each replica decodes
            # alone) — gather the chunks along T and store head-major
            kg = jax.lax.all_gather(k, seq_axis, axis=1, tiled=True)
            vg = jax.lax.all_gather(v, seq_axis, axis=1, tiled=True)
            k_all = jax.lax.dynamic_update_slice(
                k_all,
                jnp.swapaxes(kg, 1, 2)[None].astype(k_all.dtype),
                (li, 0, 0, 0, 0),
            )
            v_all = jax.lax.dynamic_update_slice(
                v_all,
                jnp.swapaxes(vg, 1, 2)[None].astype(v_all.dtype),
                (li, 0, 0, 0, 0),
            )
            return k_all, v_all

        layers = params_l["layers"]
        if isinstance(layers, (list, tuple)):
            for li, layer in enumerate(layers):
                x, k, v = _sp_block(layer, local_cfg, rt, x, positions,
                                    seq_axis)
                k_all, v_all = write(k_all, v_all, li, k, v)
        else:
            # stacked layers: scan with in-place packed-plane indexing, the
            # same pattern as models.llama.forward
            qt_stacked = {
                key: val for key, val in layers.items()
                if isinstance(val, QTensor)
            }
            others = {
                key: val for key, val in layers.items()
                if not isinstance(val, QTensor)
            }
            L = cache_l.k.shape[0]

            def body(carry, xs):
                x, k_all, v_all = carry
                li, other = xs
                layer = dict(other)
                for key, qtv in qt_stacked.items():
                    layer[key] = llama.IndexedQTensor(qtv, li)
                x, k, v = _sp_block(layer, local_cfg, rt, x, positions,
                                    seq_axis)
                k_all, v_all = write(k_all, v_all, li, k, v)
                return (x, k_all, v_all), None

            (x, k_all, v_all), _ = jax.lax.scan(
                body, (x, k_all, v_all), (jnp.arange(L), others)
            )

        x = llama.rms_norm(x, params_l["ln_final"], cfg.rms_eps)
        logits = llama._linear(x, params_l["lm_head"])
        logits = rt.logits_gather(logits)
        # the prompt's last token lives on the last seq device; replicate its
        # logits row with a masked psum
        is_last = (jax.lax.axis_index(seq_axis) == sp - 1).astype(jnp.float32)
        last = jax.lax.psum(
            logits[:, -1, :].astype(jnp.float32) * is_last, seq_axis
        )
        lengths = cache_l.lengths.at[:B].set(T)
        new_cache = llama.KVCache(k=k_all, v=v_all, lengths=lengths)
        return last, new_cache

    return f(params, tokens, cache)
