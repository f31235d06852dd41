"""Tensor-parallel execution of the quantized Llama model over a mesh.

Megatron-style layout, one psum per matmul pair:
  - wq/wk/wv, w_gate/w_up, lm_head: column-parallel (heads / ffn / vocab sharded)
  - wo, w_down: row-parallel (psum inside the block)
  - KV cache sharded over the kv-head axis; embeddings and norms replicated.

The forward code itself is the single-chip implementation in
``models/llama.py`` — running it inside ``shard_map`` with a local config and a
:class:`~xbitops.models.llama.TPRuntime` is the whole trick.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from xbitops.formats import QTensor
from xbitops.models import llama
from xbitops.parallel.tp import qtensor_pspecs


def _w_spec(w, col=None, row=None):
    if isinstance(w, QTensor):
        return qtensor_pspecs(w, col_axis=col, row_axis=row)
    return P(row, col)  # dense fallback


_COL_KEYS = {"wq", "wk", "wv", "wqkv", "w_gate", "w_up", "w_gateup"}
_ROW_KEYS = {"wo", "w_down"}


def _layer_pspecs(layer: dict, axis: str) -> dict:
    specs = {}
    for key, w in layer.items():
        if key in _COL_KEYS:
            specs[key] = _w_spec(w, col=axis)
        elif key in _ROW_KEYS:
            specs[key] = _w_spec(w, row=axis)
        else:
            specs[key] = P(None)
    return specs


def param_pspecs(params: dict, axis: str = "model") -> dict:
    """PartitionSpec pytree mirroring ``init_params`` output (fused or not,
    per-layer list or stacked — stacked leaves get a leading replicated axis)."""
    layer_params = params["layers"]
    if isinstance(layer_params, (list, tuple)):
        layers = [_layer_pspecs(layer, axis) for layer in layer_params]
    else:
        layer0 = jax.tree.map(lambda x: x[0], layer_params)
        base = _layer_pspecs(layer0, axis)
        layers = jax.tree.map(
            lambda s: P(None, *s), base, is_leaf=lambda x: isinstance(x, P)
        )
    return dict(
        embed=P(None, None),
        lm_head=_w_spec(params["lm_head"], col=axis),
        ln_final=P(None),
        layers=layers,
    )


def cache_pspecs(
    axis: str = "model", data_axis=None, quantized: bool = False,
    paged: bool = False,
) -> llama.KVCache:
    # head-major cache [L, B, n_kv, S, D] / words [L, B, n_kv, S/4, D]:
    # kv heads shard over the model axis; scales [L, B, 4, n_kv, S/4]
    sc = P(None, data_axis, None, axis, None) if quantized else None
    if paged:
        # pool [L, n_pages, n_kv, psz(/4), D]: kv heads sharded, pages and
        # in-page rows replicated-local; page tables are tiny, replicated
        sc_pool = P(None, None, None, axis, None) if quantized else None
        return llama.KVCache(
            k=P(None, None, axis, None, None),
            v=P(None, None, axis, None, None),
            lengths=P(data_axis),
            k_scale=sc_pool,
            v_scale=sc_pool,
            page_table=P(data_axis, None),
        )
    return llama.KVCache(
        k=P(None, data_axis, axis, None, None),
        v=P(None, data_axis, axis, None, None),
        lengths=P(data_axis),
        k_scale=sc,
        v_scale=sc,
        page_table=None,
    )


def shard_params(params: dict, mesh: Mesh, axis: str = "model") -> dict:
    specs = param_pspecs(params, axis)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params, specs
    )


def shard_cache(cache: llama.KVCache, mesh: Mesh, axis: str = "model") -> llama.KVCache:
    specs = cache_pspecs(axis, quantized=cache.quantized, paged=cache.paged)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), cache, specs
    )


def tp_forward(
    params: dict,
    cfg: llama.LlamaConfig,
    mesh: Mesh,
    tokens: jax.Array,
    cache: llama.KVCache,
    positions: jax.Array,
    axis: str = "model",
    data_axis: Optional[str] = None,
) -> Tuple[jax.Array, llama.KVCache]:
    """Sharded forward: logits replicated over model, cache stays head-sharded.

    ``data_axis`` additionally shards the batch dimension (dp x tp mesh); the
    model axis collectives stay within each data-parallel replica.
    """
    tp = mesh.shape[axis]
    local_cfg = cfg.local(tp)
    rt = llama.TPRuntime(axis)
    da = data_axis

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            param_pspecs(params, axis),
            P(da, None),
            cache_pspecs(axis, da, cache.quantized, cache.paged),
            P(da, None),
        ),
        out_specs=(P(da, None, None), cache_pspecs(axis, da, cache.quantized, cache.paged)),
        check_vma=False,
    )
    def f(params_l, tokens_l, cache_l, positions_l):
        return llama.forward(params_l, local_cfg, tokens_l, cache_l, positions_l, rt)

    return f(params, tokens, cache, positions)


def tp_decode_step(
    params, cfg, mesh, tokens, cache, axis: str = "model", data_axis=None, active=None
):
    positions = cache.lengths[:, None]
    if active is not None:
        positions = jnp.where(active[:, None], positions, cache.S)
    logits, cache = tp_forward(
        params, cfg, mesh, tokens[:, None], cache, positions, axis, data_axis
    )
    return logits[:, -1, :], cache


def tp_spec_verify_step(
    params, cfg, mesh, tokens, cache, axis: str = "model", active=None
):
    """Sharded :func:`~xbitops.models.llama.spec_verify_step` — the
    accept/rollback logic runs replicated per shard (deterministic), only the
    forward is sharded."""
    tp = mesh.shape[axis]
    local_cfg = cfg.local(tp)
    rt = llama.TPRuntime(axis)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(param_pspecs(params, axis), P(None, None), P(None),
                  cache_pspecs(axis, quantized=cache.quantized, paged=cache.paged)),
        out_specs=(P(None, None), P(None),
                   cache_pspecs(axis, quantized=cache.quantized, paged=cache.paged)),
        check_vma=False,
    )
    def f(params_l, tokens_l, active_l, cache_l):
        return llama.spec_verify_step(
            params_l, local_cfg, tokens_l, cache_l, rt, active=active_l
        )

    if active is None:
        active = jnp.ones((tokens.shape[0],), bool)
    return f(params, tokens, jnp.asarray(active), cache)


def tp_prefill_slot_chunk(
    params, cfg, mesh, tokens, start, true_len, slot, cache, axis: str = "model",
    reset=False,
):
    """Sharded :func:`~xbitops.models.llama.prefill_slot_chunk`."""
    tp = mesh.shape[axis]
    local_cfg = cfg.local(tp)
    rt = llama.TPRuntime(axis)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            param_pspecs(params, axis), P(None), P(), P(), P(), P(),
            cache_pspecs(axis, quantized=cache.quantized, paged=cache.paged),
        ),
        out_specs=(P(None), cache_pspecs(axis, quantized=cache.quantized, paged=cache.paged)),
        check_vma=False,
    )
    def f(params_l, tokens_l, start_l, true_len_l, slot_l, reset_l, cache_l):
        return llama.prefill_slot_chunk(
            params_l, local_cfg, tokens_l, start_l, true_len_l, slot_l, cache_l,
            rt, reset=reset_l,
        )

    return f(
        params, tokens, jnp.asarray(start), jnp.asarray(true_len),
        jnp.asarray(slot), jnp.asarray(reset), cache,
    )


def tp_prefill_slots_chunk(
    params, cfg, mesh, tokens, starts, true_lens, slots, cache,
    axis: str = "model", resets=None,
):
    """Sharded :func:`~xbitops.models.llama.prefill_slots_chunk` (one
    chunk each for n long prompts in one forward)."""
    tp = mesh.shape[axis]
    local_cfg = cfg.local(tp)
    rt = llama.TPRuntime(axis)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(param_pspecs(params, axis), P(None, None), P(None), P(None),
                  P(None), P(None),
                  cache_pspecs(axis, quantized=cache.quantized, paged=cache.paged)),
        out_specs=(P(None, None), cache_pspecs(axis, quantized=cache.quantized, paged=cache.paged)),
        check_vma=False,
    )
    def f(params_l, tokens_l, starts_l, lens_l, slots_l, resets_l, cache_l):
        return llama.prefill_slots_chunk(
            params_l, local_cfg, tokens_l, starts_l, lens_l, slots_l, cache_l,
            rt, resets=resets_l,
        )

    n = tokens.shape[0]
    if resets is None:
        resets = jnp.zeros((n,), bool)
    return f(
        params, tokens, jnp.asarray(starts), jnp.asarray(true_lens),
        jnp.asarray(slots), jnp.asarray(resets), cache,
    )


def tp_prefill_slots(
    params, cfg, mesh, tokens, true_lens, slots, cache, axis: str = "model"
):
    """Sharded :func:`~xbitops.models.llama.prefill_slots` (batched
    admission: n requests into n cache slots in one forward)."""
    tp = mesh.shape[axis]
    local_cfg = cfg.local(tp)
    rt = llama.TPRuntime(axis)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(param_pspecs(params, axis), P(None, None), P(None), P(None),
                  cache_pspecs(axis, quantized=cache.quantized, paged=cache.paged)),
        out_specs=(P(None, None), cache_pspecs(axis, quantized=cache.quantized, paged=cache.paged)),
        check_vma=False,
    )
    def f(params_l, tokens_l, lens_l, slots_l, cache_l):
        return llama.prefill_slots(
            params_l, local_cfg, tokens_l, lens_l, slots_l, cache_l, rt
        )

    return f(params, tokens, jnp.asarray(true_lens), jnp.asarray(slots), cache)


def tp_prefill_slot(
    params, cfg, mesh, tokens, true_len, slot, cache, axis: str = "model"
):
    """Sharded :func:`~xbitops.models.llama.prefill_slot` (one request into
    one cache slot; tokens/scalars replicated, cache head-sharded)."""
    tp = mesh.shape[axis]
    local_cfg = cfg.local(tp)
    rt = llama.TPRuntime(axis)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(param_pspecs(params, axis), P(None), P(), P(),
                  cache_pspecs(axis, quantized=cache.quantized, paged=cache.paged)),
        out_specs=(P(None), cache_pspecs(axis, quantized=cache.quantized, paged=cache.paged)),
        check_vma=False,
    )
    def f(params_l, tokens_l, true_len_l, slot_l, cache_l):
        return llama.prefill_slot(
            params_l, local_cfg, tokens_l, true_len_l, slot_l, cache_l, rt
        )

    return f(params, tokens, jnp.asarray(true_len), jnp.asarray(slot), cache)


def tp_prefill(params, cfg, mesh, tokens, cache, axis: str = "model", data_axis=None):
    B, T = tokens.shape
    positions = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    return tp_forward(params, cfg, mesh, tokens, cache, positions, axis, data_axis)
