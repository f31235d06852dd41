"""Pipeline parallelism: layers sharded over a ``pipe`` mesh axis.

The reference has no parallelism of any kind (SURVEY §2 checklist:
"DP / TP / PP / SP / EP: absent"); this module adds the PP entry the same
way ``model_tp`` adds TP and ``seqpar`` adds SP — layers of the STACKED
parameter pytree (and the ``[L, ...]`` KV cache) shard their leading layer
axis over ``pipe``, so each stage holds ``L/P`` contiguous layers, and
microbatches of the slot batch rotate stage-to-stage on ``ppermute``
(1F pipeline: round r, stage s works microbatch r-s; 2P-1 rounds drain a
full batch).  Composes with tensor parallelism on a ``(pipe, model)`` mesh
— the TP collectives stay inside each stage.

Intended use is multi-host serving where layers don't fit one host's chips
or DCN latency favors layer sharding over TP's per-layer collectives; the
single-chip decode/TP paths stay the throughput-optimal configuration
(each PP round runs the XLA slot-subset attention path, and the last
stage's lm_head runs once per round — pipeline bubbles and uniform-SPMD
waste are the usual PP taxes).  Paged caches are not supported under PP.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from xbitops.formats import QTensor
from xbitops.models import llama
from xbitops.parallel import model_tp

__all__ = ["pp_param_pspecs", "pp_cache_pspecs", "pp_decode_step",
           "pp_decode_burst", "pp_prefill_slots"]


def pp_param_pspecs(params: dict, pipe_axis: str, tp_axis: Optional[str]):
    """Specs for a STACKED param pytree: layer leaves shard dim 0 over
    ``pipe_axis`` (on top of the TP column/row specs when ``tp_axis`` is
    set); embed / lm_head / ln_final replicate over pipe (stage 0 embeds,
    the last stage projects — replication keeps the SPMD body uniform)."""
    if isinstance(params["layers"], (list, tuple)):
        raise ValueError("pipeline parallelism needs stacked layers "
                         "(llama.stack_layers)")
    if tp_axis is not None:
        base = model_tp.param_pspecs(params, tp_axis)
    else:
        base = jax.tree.map(lambda _: P(None), params)
        base["layers"] = jax.tree.map(lambda _: P(None), params["layers"])
    layers = jax.tree.map(
        lambda s: P(pipe_axis, *tuple(s)[1:]),
        base["layers"],
        is_leaf=lambda x: isinstance(x, P),
    )
    return dict(base, layers=layers)


def pp_cache_pspecs(pipe_axis: str, tp_axis: Optional[str],
                    quantized: bool = False) -> llama.KVCache:
    """Stacked-cache specs with the layer axis sharded over ``pipe_axis``
    (kv heads over ``tp_axis`` as in model_tp)."""
    sc = P(pipe_axis, None, None, tp_axis, None) if quantized else None
    return llama.KVCache(
        k=P(pipe_axis, None, tp_axis, None, None),
        v=P(pipe_axis, None, tp_axis, None, None),
        lengths=P(None),
        k_scale=sc,
        v_scale=sc,
        page_table=None,
    )


def _stage_apply(layers, cfg, rt, x, positions, kv, mask, slot_ids,
                 self_attend):
    """Run this stage's stacked layer slab on x (the same scan-with-
    IndexedQTensor pattern as ``llama.forward``)."""
    qt_stacked = {k: v for k, v in layers.items() if isinstance(v, QTensor)}
    others = {k: v for k, v in layers.items() if not isinstance(v, QTensor)}
    Lp = kv[0].shape[0]

    def body(carry, xs):
        x, kv = carry
        li, other = xs
        layer = dict(other)
        for key, qtv in qt_stacked.items():
            layer[key] = llama.IndexedQTensor(qtv, li)
        x, kv = llama._block(
            layer, cfg, rt, x, positions, kv, li, mask,
            slot_ids=slot_ids, self_attend=self_attend,
        )
        return (x, kv), None

    (x, kv), _ = lax.scan(body, (x, kv), (jnp.arange(Lp), others))
    return x, kv


def _pp_forward(params_l, local_cfg, cfg, rt, pipe_axis, n_stages, mb, T,
                tokens_l, cache_l, positions_of, self_attend):
    """The shared stage loop: microbatch j enters stage 0 at round j,
    finishes at round j + P - 1; x rotates stage-to-stage each round.
    ``positions_of(rows, stage_active)`` supplies each round's positions
    (decode: current lengths; prefill: 0..T masked by true lengths)."""
    s = lax.axis_index(pipe_axis)
    h = params_l["embed"].shape[1]
    V = cfg.vocab_size
    B = tokens_l.shape[0]
    S = cache_l.S
    kv0 = (cache_l.k, cache_l.v, cache_l.k_scale, cache_l.v_scale)
    x0 = jnp.zeros((mb, T, h), jnp.bfloat16)
    outs0 = jnp.zeros((B, V), jnp.float32)
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def round_body(r, carry):
        x, kv, outs = carry
        j = jnp.clip(r - s, 0, n_stages - 1)  # this stage's microbatch
        stage_active = jnp.logical_and(r - s >= 0, r - s < n_stages)
        rows = j * mb + jnp.arange(mb)
        tok_mb = lax.dynamic_slice(tokens_l, (j * mb, 0), (mb, T))
        fresh = params_l["embed"][tok_mb].astype(jnp.bfloat16)
        x_in = jnp.where(s == 0, fresh, x)
        positions, last_idx = positions_of(rows, stage_active)
        if self_attend:
            mask = (positions[:, None, :] <= positions[:, :, None]) & (
                positions[:, None, :] < S
            )
        else:
            mask = jnp.arange(S)[None, None, :] <= positions[:, :, None]
        xo, kv = _stage_apply(
            params_l["layers"], local_cfg, rt, x_in, positions, kv, mask,
            rows, self_attend,
        )
        xn = llama.rms_norm(xo, params_l["ln_final"], cfg.rms_eps)
        logits = rt.logits_gather(llama._linear(xn, params_l["lm_head"]))
        lg = jnp.take_along_axis(
            logits.astype(jnp.float32), last_idx[:, None, None], axis=1
        )[:, 0]
        write = jnp.logical_and(s == n_stages - 1, stage_active)
        prev = lax.dynamic_slice(outs, (j * mb, 0), (mb, V))
        outs = lax.dynamic_update_slice(
            outs, jnp.where(write, lg, prev), (j * mb, 0)
        )
        x = lax.ppermute(xo, pipe_axis, perm)
        return x, kv, outs

    x, kv, outs = lax.fori_loop(
        0, 2 * n_stages - 1, round_body, (x0, kv0, outs0)
    )
    # only the last stage's rows are real — replicate them over the pipe
    outs = lax.psum(
        jnp.where(s == n_stages - 1, outs, 0.0), pipe_axis
    )
    return outs, kv


def _mesh_setup(params, mesh, cache, pipe_axis, tp_axis):
    n_stages = mesh.shape[pipe_axis]
    tp = mesh.shape[tp_axis] if tp_axis else 1

    def local_cfg_of(cfg):
        return cfg.local(tp) if tp > 1 else cfg

    rt = llama.TPRuntime(tp_axis) if tp_axis else llama.Runtime()
    pspecs = pp_param_pspecs(params, pipe_axis, tp_axis)
    cspecs = pp_cache_pspecs(pipe_axis, tp_axis, cache.quantized)
    if cache.paged:
        raise ValueError("paged KV caches are not supported under PP")
    return n_stages, local_cfg_of, rt, pspecs, cspecs


def pp_decode_step(
    params: dict,
    cfg: llama.LlamaConfig,
    mesh: Mesh,
    tokens: jax.Array,  # int32 [B]
    cache: llama.KVCache,
    pipe_axis: str = "pipe",
    tp_axis: Optional[str] = None,
    active: Optional[jax.Array] = None,
) -> Tuple[jax.Array, llama.KVCache]:
    """One decode step with layers pipeline-sharded: microbatches of
    ``B / n_stages`` slots flow through the stages.  Same semantics as
    :func:`~xbitops.models.llama.decode_step` (active masking, drop
    semantics for full slots)."""
    n_stages, lcf, rt, pspecs, cspecs = _mesh_setup(
        params, mesh, cache, pipe_axis, tp_axis)
    local_cfg = lcf(cfg)
    B = tokens.shape[0]
    if B % n_stages:
        raise ValueError(f"batch {B} must divide the pipe axis ({n_stages})")
    mb = B // n_stages
    if active is None:
        active = jnp.ones((B,), bool)

    @partial(
        shard_map, mesh=mesh,
        in_specs=(pspecs, P(None), P(None), cspecs),
        out_specs=(P(None, None), cspecs, P(None)),
        check_vma=False,
    )
    def f(params_l, tokens_l, active_l, cache_l):
        S = cache_l.S
        lengths = cache_l.lengths

        def positions_of(rows, stage_active):
            row_act = jnp.logical_and(stage_active, active_l[rows])
            pos = jnp.where(row_act, lengths[rows], S)[:, None]
            return pos, jnp.zeros((pos.shape[0],), jnp.int32)

        outs, kv = _pp_forward(
            params_l, local_cfg, cfg, rt, pipe_axis, n_stages, mb, 1,
            tokens_l[:, None], cache_l, positions_of, self_attend=False,
        )
        new_lens = jnp.where(
            jnp.logical_and(active_l, lengths < S), lengths + 1, lengths
        ).astype(jnp.int32)
        new_cache = llama.KVCache(
            k=kv[0], v=kv[1], lengths=new_lens, k_scale=kv[2], v_scale=kv[3]
        )
        return outs, new_cache, new_lens

    logits, new_cache, _ = f(params, tokens, jnp.asarray(active), cache)
    return logits, new_cache


def pp_decode_burst(
    params: dict,
    cfg: llama.LlamaConfig,
    mesh: Mesh,
    tokens: jax.Array,  # int32 [B] current token per slot
    cache: llama.KVCache,
    n_steps: int,
    pipe_axis: str = "pipe",
    tp_axis: Optional[str] = None,
    active: Optional[jax.Array] = None,
) -> Tuple[jax.Array, llama.KVCache]:
    """``n_steps`` chained greedy decode steps, SOFTWARE-PIPELINED across the
    stages — the steady-state PP decode schedule.

    :func:`pp_decode_step` drains the pipeline every step (one batch costs
    ``2P - 1`` rounds, stages busy ``P`` of them); here microbatch ``m``
    re-enters stage 0 with its NEXT token the round after it leaves the last
    stage (the token rides the same ``ppermute`` rotation the hidden state
    uses, last → 0 in one hop), so at round ``r`` stage ``s`` works
    microbatch ``(r - s) mod P`` at step ``(r - s) // P``: every stage does
    useful work every round once the pipe fills.  Busy fraction is
    ``n_steps·P / (n_steps·P + P - 1) → 1``, vs the drained schedule's
    ``P / (2P - 1) ≈ 1/2``.  Greedy only (the serving default; sampling
    would thread a key through the rotation).  Tokens are bit-identical to
    ``n_steps`` calls of :func:`pp_decode_step`.

    The last stage's lm_head stays on every stage's program (uniform SPMD);
    it is NOT the wall-clock bound — rounds synchronize on the ``ppermute``,
    and the last stage's lm_head sits on that critical path either way.
    """
    n_stages, lcf, rt, pspecs, cspecs = _mesh_setup(
        params, mesh, cache, pipe_axis, tp_axis)
    local_cfg = lcf(cfg)
    B = tokens.shape[0]
    if B % n_stages:
        raise ValueError(f"batch {B} must divide the pipe axis ({n_stages})")
    mb = B // n_stages
    if active is None:
        active = jnp.ones((B,), bool)

    @partial(
        shard_map, mesh=mesh,
        in_specs=(pspecs, P(None), P(None), cspecs),
        out_specs=(P(None, None), cspecs),
        check_vma=False,
    )
    def f(params_l, tokens_l, active_l, cache_l):
        s = lax.axis_index(pipe_axis)
        h = params_l["embed"].shape[1]
        S = cache_l.S
        len0 = cache_l.lengths
        kv0 = (cache_l.k, cache_l.v, cache_l.k_scale, cache_l.v_scale)
        x0 = jnp.zeros((mb, 1, h), jnp.bfloat16)
        tok0 = jnp.zeros((mb,), jnp.int32)
        outs0 = jnp.zeros((n_steps, B), jnp.int32)
        perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
        total = n_steps * n_stages

        def round_body(r, carry):
            x, tok_in, kv, outs = carry
            v = r - s
            stage_active = jnp.logical_and(v >= 0, v < total)
            vc = jnp.clip(v, 0, total - 1)
            t = vc // n_stages  # this microbatch's step index
            m = vc % n_stages  # microbatch
            rows = m * mb + jnp.arange(mb)
            row_act = jnp.logical_and(stage_active, active_l[rows])
            # step 0 tokens come from the host; later steps from the token
            # the last stage rotated in (its argmax for this microbatch's
            # previous step, one round ago)
            tok_fresh = lax.dynamic_slice(tokens_l, (m * mb,), (mb,))
            tok_use = jnp.where(t == 0, tok_fresh, tok_in)
            fresh = params_l["embed"][tok_use][:, None, :].astype(jnp.bfloat16)
            x_in = jnp.where(s == 0, fresh, x)
            pos = jnp.where(
                jnp.logical_and(row_act, len0[rows] + t < S),
                len0[rows] + t, S,
            )[:, None]
            mask = jnp.arange(S)[None, None, :] <= pos[:, :, None]
            xo, kv = _stage_apply(
                params_l["layers"], local_cfg, rt, x_in, pos, kv, mask,
                rows, False,
            )
            xn = llama.rms_norm(xo, params_l["ln_final"], cfg.rms_eps)
            logits = rt.logits_gather(llama._linear(xn, params_l["lm_head"]))
            nxt = jnp.argmax(
                logits[:, 0].astype(jnp.float32), axis=-1
            ).astype(jnp.int32)
            nxt = jnp.where(row_act, nxt, 0)
            write = jnp.logical_and(s == n_stages - 1, stage_active)
            prev = lax.dynamic_slice(outs, (t, m * mb), (1, mb))
            outs = lax.dynamic_update_slice(
                outs, jnp.where(write, nxt, prev[0])[None], (t, m * mb)
            )
            x = lax.ppermute(xo, pipe_axis, perm)
            tok_out = lax.ppermute(nxt, pipe_axis, perm)
            return x, tok_out, kv, outs

        _, _, kv, outs = lax.fori_loop(
            0, total + n_stages - 1, round_body, (x0, tok0, kv0, outs0)
        )
        outs = lax.psum(
            jnp.where(s == n_stages - 1, outs, 0), pipe_axis
        )
        new_lens = jnp.where(
            active_l,
            jnp.minimum(len0 + n_steps, S),
            len0,
        ).astype(jnp.int32)
        new_cache = llama.KVCache(
            k=kv[0], v=kv[1], lengths=new_lens, k_scale=kv[2], v_scale=kv[3]
        )
        return outs, new_cache

    return f(params, tokens, jnp.asarray(active), cache)


def pp_prefill_slots(
    params: dict,
    cfg: llama.LlamaConfig,
    mesh: Mesh,
    tokens: jax.Array,  # int32 [B, T] zero-padded
    true_lens: jax.Array,  # int32 [B]
    cache: llama.KVCache,
    pipe_axis: str = "pipe",
    tp_axis: Optional[str] = None,
) -> Tuple[jax.Array, llama.KVCache]:
    """Batched admission under PP: microbatches of fresh requests prefill
    into their own slots (rows == slots, like
    :func:`~xbitops.models.llama.prefill_slots` with ``slots =
    arange(B)``); returns last-token logits [B, V] and the updated cache."""
    n_stages, lcf, rt, pspecs, cspecs = _mesh_setup(
        params, mesh, cache, pipe_axis, tp_axis)
    local_cfg = lcf(cfg)
    B, T = tokens.shape
    if B % n_stages:
        raise ValueError(f"batch {B} must divide the pipe axis ({n_stages})")
    mb = B // n_stages

    @partial(
        shard_map, mesh=mesh,
        in_specs=(pspecs, P(None, None), P(None), cspecs),
        out_specs=(P(None, None), cspecs, P(None)),
        check_vma=False,
    )
    def f(params_l, tokens_l, lens_l, cache_l):
        S = cache_l.S

        def positions_of(rows, stage_active):
            tl = jnp.where(stage_active, lens_l[rows], 0)
            pos = jnp.arange(T)[None, :]
            pos = jnp.where(pos < tl[:, None], pos, S)
            return pos, jnp.maximum(tl - 1, 0).astype(jnp.int32)

        outs, kv = _pp_forward(
            params_l, local_cfg, cfg, rt, pipe_axis, n_stages, mb, T,
            tokens_l, cache_l, positions_of, self_attend=True,
        )
        new_lens = lens_l.astype(jnp.int32)  # rows == slots, fresh requests
        new_cache = llama.KVCache(
            k=kv[0], v=kv[1], lengths=new_lens, k_scale=kv[2], v_scale=kv[3]
        )
        return outs, new_cache, new_lens

    logits, new_cache, _ = f(
        params, tokens, jnp.asarray(true_lens, jnp.int32), cache
    )
    return logits, new_cache
