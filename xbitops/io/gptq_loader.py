"""AutoGPTQ / GPTQ-for-LLaMa checkpoint ingestion → packed params.

The reference consumes pre-quantized GPTQ tensors but ships no loader — the
caller hands ``qweight/scales/qzeros`` to the ops (``dq_torch_ops.cc:23-78``).
Here ingestion is part of the framework: a HuggingFace-layout AutoGPTQ Llama
checkpoint (``*.safetensors`` + ``config.json`` + ``quantize_config.json``) is
converted straight into the native plane layout (``formats.from_gptq``),
including the act-order (``g_idx``) row pre-sort and optional row-parallel
repacking for tensor parallelism.

Zero-point convention: AutoGPTQ's packer stores ``zero - 1`` in ``qzeros`` (its
CUDA dequant adds the +1 back — the same convention as the reference's
``add_zero_bias=1``, ``unpack_weight_2_to_7.cu:60``); newer "v2"/sym formats
store true zeros.  ``add_zero_bias=None`` auto-detects from
``quantize_config.json`` (``checkpoint_format``/``version``), defaulting to 1.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from xbitops import formats
from xbitops.models.llama import LlamaConfig

__all__ = ["load_autogptq", "llama_config_from_hf"]


def _load_safetensors_dir(path: Path) -> dict:
    from safetensors import numpy as st_np

    files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    tensors = {}
    for f in files:
        tensors.update(st_np.load_file(str(f)))
    return tensors


def llama_config_from_hf(cfg: dict, max_seq_len: Optional[int] = None) -> LlamaConfig:
    heads = cfg["num_attention_heads"]
    # HF rope_scaling: {"type"|"rope_type": "linear"|"dynamic", "factor": f};
    # "dynamic" is NTK-aware scaling
    rs = cfg.get("rope_scaling") or {}
    rs_type = {"linear": "linear", "dynamic": "ntk", "ntk": "ntk"}.get(
        rs.get("type", rs.get("rope_type"))
    )
    fields = dict(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=cfg.get("num_key_value_heads", heads),
        head_dim=cfg.get("head_dim", cfg["hidden_size"] // heads),
        rope_theta=cfg.get("rope_theta", 10000.0),
        rms_eps=cfg.get("rms_norm_eps", 1e-5),
        max_seq_len=max_seq_len or min(cfg.get("max_position_embeddings", 2048), 4096),
        rope_scaling_type=rs_type,
        rope_scaling_factor=float(rs.get("factor", 1.0)),
        # Mistral-v0.1-style sliding window (null/absent on llama and on
        # mistral >= v0.2 checkpoints -> full attention)
        sliding_window=cfg.get("sliding_window"),
    )
    if cfg.get("model_type") == "mixtral":
        from xbitops.models.moe import MoeConfig

        return MoeConfig(
            **fields,
            n_experts=cfg.get("num_local_experts", 8),
            experts_per_token=cfg.get("num_experts_per_tok", 2),
            # real Mixtral inference drops nothing: checkpoint loads run the
            # exact no-drop dispatch (capacity = token count)
            capacity_factor=None,
        )
    return LlamaConfig(**fields)


def _detect_zero_bias(qcfg: dict) -> int:
    # AutoGPTQ "gptq" format stores zero-1; "gptq_v2" stores true zeros.
    fmt = qcfg.get("checkpoint_format", "gptq")
    if fmt == "gptq_v2":
        return 0
    return 1


def _nontrivial_gidx(tensors: dict, prefix: str, in_features: int, group_size: int):
    """The checkpoint's ``g_idx`` for ``prefix`` as int32, or None when absent
    or trivial (a monotone ``k // group_size`` map is not act-order)."""
    g_idx = tensors.get(f"{prefix}.g_idx")
    if g_idx is None:
        return None
    arr = np.asarray(g_idx, np.int64)
    if np.array_equal(arr, np.arange(in_features) // group_size):
        return None
    return jnp.asarray(arr, jnp.int32)


def _to_qtensor(
    tensors: dict,
    prefix: str,
    in_features: int,
    bits: int,
    group_size: int,
    add_zero_bias: int,
    tp: int,
    scale_store_dtype,
    storage_bits=None,
    col_perm=None,
    fold: bool = False,
    gathered_ok: bool = False,
):
    qweight = jnp.asarray(tensors[f"{prefix}.qweight"])
    scales = jnp.asarray(tensors[f"{prefix}.scales"])
    qzeros = jnp.asarray(tensors[f"{prefix}.qzeros"])
    g_idx = _nontrivial_gidx(tensors, prefix, in_features, group_size)
    if tp > 1:
        assert col_perm is None  # col_perm callers are column-parallel (tp=1)
        if g_idx is not None and not fold:
            if not gathered_ok:
                raise NotImplementedError(
                    "act-order (g_idx) on this row-parallel projection cannot "
                    "fold into an upstream layer; load with tp=1 or "
                    "re-quantize without desc_act"
                )
            # gathered-column execution: keep the full tensor + runtime perm,
            # shard its COLUMNS at placement (parallel.tp.qtensor_pspecs
            # falls back to col specs for act-order row weights) and let
            # TPRuntime.row all-gather the input/output instead of psumming
            return formats.from_gptq(
                qweight, scales, qzeros, bits, group_size, in_features,
                add_zero_bias=add_zero_bias, g_idx=g_idx,
                scale_store_dtype=scale_store_dtype, storage_bits=storage_bits,
            )
        wq = formats.gptq_unpack_weight(qweight, bits, in_features)
        zeros = formats.gptq_unpack_zeros(qzeros, bits, scales.shape[1])
        if fold and g_idx is not None:
            # rows pre-sorted into contiguous groups; the activation arrives
            # already sorted (the order was folded into the upstream layer's
            # output columns), so no runtime perm is stored
            order = jnp.argsort(g_idx, stable=True)
            wq = jnp.take(wq, order, axis=0)
        return formats.make_row_sharded_qtensor(
            wq, scales, zeros, bits, group_size, tp,
            add_zero_bias=add_zero_bias, scale_store_dtype=scale_store_dtype,
            storage_bits=storage_bits,
        )
    return formats.from_gptq(
        qweight, scales, qzeros, bits, group_size, in_features,
        add_zero_bias=add_zero_bias, g_idx=g_idx,
        scale_store_dtype=scale_store_dtype, storage_bits=storage_bits,
        col_perm=col_perm, fold_perm=fold,
    )


def _try_fuse(parts, sizes, tp):
    """Fuse column-parallel QTensors ([q|k|v] or [gate|up]) into one matmul,
    per-shard interleaved under TP.  Returns None when fusion isn't possible
    (dense fallback weights or act-order perms)."""
    from xbitops.models.llama import interleave_order

    if not all(isinstance(p, formats.QTensor) for p in parts):
        return None
    if any(p.perm is not None for p in parts):
        return None
    metas = {(p.bits, p.group_size, p.tile_k, p.K, p.K_logical) for p in parts}
    if len(metas) != 1:
        return None
    order = interleave_order(sizes, tp) if tp > 1 else None
    return formats.concat_qtensors(parts, order=order)


def load_autogptq(
    path: str,
    tp: int = 1,
    max_seq_len: Optional[int] = None,
    add_zero_bias: Optional[int] = None,
    dtype=jnp.bfloat16,
    scale_store_dtype=None,
    fuse: bool = True,
    storage_bits=None,
) -> Tuple[dict, LlamaConfig]:
    """Load an AutoGPTQ Llama/Mistral/Mixtral checkpoint directory into
    (params, config).

    ``tp > 1`` repacks the row-parallel projections (o_proj, down_proj)
    shard-stacked for a ``tp``-way model axis (``formats.make_row_sharded_
    qtensor``); column-parallel tensors shard at placement time, no repack.
    ``fuse`` merges q|k|v and gate|up into single fused matmuls where legal
    (skipped per-layer for act-order or dense-fallback projections).

    Mixtral checkpoints return a :class:`~xbitops.models.moe.MoeConfig`
    and layers carrying ``router`` + stacked expert QTensors; they shard
    over the EXPERT axis (``models.moe.expert_pspecs``), so ``tp`` must be 1.
    """
    p = Path(path)
    hf_cfg = json.loads((p / "config.json").read_text())
    if hf_cfg.get("model_type", "llama") not in ("llama", "mistral", "mixtral"):
        raise ValueError(f"unsupported model_type {hf_cfg.get('model_type')}")
    is_moe = hf_cfg.get("model_type") == "mixtral"
    if is_moe and tp > 1:
        raise NotImplementedError(
            "Mixtral checkpoints shard over the EXPERT axis "
            "(models.moe.expert_pspecs), not row-parallel TP; load with tp=1"
        )
    qcfg_path = p / "quantize_config.json"
    qcfg = json.loads(qcfg_path.read_text()) if qcfg_path.exists() else {}
    bits = qcfg.get("bits", 4)
    group_size = qcfg.get("group_size", 128)
    if add_zero_bias is None:
        add_zero_bias = _detect_zero_bias(qcfg)
    cfg = llama_config_from_hf(hf_cfg, max_seq_len)
    tensors = _load_safetensors_dir(p)

    h = cfg.hidden_size

    def q(prefix: str, k_dim: int, row_parallel: bool = False,
          col_perm=None, fold: bool = False, gathered_ok: bool = False):
        if f"{prefix}.qweight" in tensors:
            return _to_qtensor(
                tensors, prefix, k_dim, bits, group_size, add_zero_bias,
                tp if row_parallel else 1, scale_store_dtype, storage_bits,
                col_perm=col_perm, fold=fold, gathered_ok=gathered_ok,
            )
        # dense fallback (e.g. lm_head kept fp16 in many GPTQ checkpoints);
        # HF stores [out, in] — transpose to [in, out]
        w = jnp.asarray(tensors[f"{prefix}.weight"]).T.astype(dtype)
        return w if col_perm is None else jnp.take(w, col_perm, axis=1)

    qdim = cfg.num_heads * cfg.head_dim
    kvdim = cfg.num_kv_heads * cfg.head_dim

    def moe_ffn_entries(pre: str) -> dict:
        """Mixtral block_sparse_moe: router + per-expert w1 (gate) | w3 (up)
        fused, w2 (down) — experts stacked into single QTensors the fused
        matmul indexes in place (models/moe.py)."""
        from xbitops.models.moe import stack_experts

        E = cfg.n_experts
        router = jnp.asarray(
            tensors[f"{pre}.block_sparse_moe.gate.weight"]
        ).T.astype(jnp.float32)
        gus, downs = [], []
        for e in range(E):
            ep = f"{pre}.block_sparse_moe.experts.{e}"
            w1 = q(f"{ep}.w1", h)
            w3 = q(f"{ep}.w3", h)
            if not isinstance(w1, formats.QTensor):
                # dense checkpoint (quantizer input): stacked dense experts
                gus.append(jnp.concatenate([w1, w3], axis=1))
                downs.append(q(f"{ep}.w2", cfg.intermediate_size))
                continue
            gu = _try_fuse([w1, w3], (cfg.intermediate_size,) * 2, 1)
            if gu is None:
                raise NotImplementedError(
                    "Mixtral experts must be quantized and non-act-order "
                    "(the stacked expert matmul fuses w1|w3)"
                )
            gus.append(gu)
            downs.append(q(f"{ep}.w2", cfg.intermediate_size))
        return dict(
            router=router,
            w_experts_gateup=stack_experts(gus),
            w_experts_down=stack_experts(downs),
        )

    layers = []
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}"
        wq_ = q(f"{pre}.self_attn.q_proj", h)
        wk_ = q(f"{pre}.self_attn.k_proj", h)
        wv_ = q(f"{pre}.self_attn.v_proj", h)
        attn_mlp = {}
        if fuse:
            wqkv = _try_fuse([wq_, wk_, wv_], (qdim, kvdim, kvdim), tp)
            if wqkv is not None:
                attn_mlp["wqkv"] = wqkv
            else:
                attn_mlp.update(wq=wq_, wk=wk_, wv=wv_)
        else:
            attn_mlp.update(wq=wq_, wk=wk_, wv=wv_)
        if is_moe:
            attn_mlp.update(moe_ffn_entries(pre))
        else:
            # desc_act down_proj: fold its row sort into gate/up's output
            # columns (a column permutation commutes with silu(g)*u), so the
            # down matmul runs gather-free — and row-shards cleanly under TP
            # (shard boundaries land in the SORTED order, where groups are
            # contiguous).  Exact; also removes the tp=1 runtime gather.
            down_pre = f"{pre}.mlp.down_proj"
            down_gidx = _nontrivial_gidx(
                tensors, down_pre, cfg.intermediate_size, group_size
            )
            col_perm = None
            if down_gidx is not None and f"{down_pre}.qweight" in tensors:
                col_perm = jnp.argsort(down_gidx, stable=True).astype(jnp.int32)
            wgate = q(f"{pre}.mlp.gate_proj", h, col_perm=col_perm)
            wup = q(f"{pre}.mlp.up_proj", h, col_perm=col_perm)
            wgu = _try_fuse(
                [wgate, wup], (cfg.intermediate_size,) * 2, tp
            ) if fuse else None
            if wgu is not None:
                attn_mlp["w_gateup"] = wgu
            else:
                attn_mlp.update(w_gate=wgate, w_up=wup)
            attn_mlp["w_down"] = q(
                down_pre, cfg.intermediate_size,
                row_parallel=True, fold=col_perm is not None,
            )
        layers.append(
            dict(
                **attn_mlp,
                # desc_act o_proj can't fold (its perm crosses attention
                # heads): under TP it loads full + perm and runs gathered-
                # column (TPRuntime.row all-gathers in/out; comm volume ~= the
                # psum it replaces)
                wo=q(f"{pre}.self_attn.o_proj", qdim, row_parallel=True,
                     gathered_ok=True),
                ln_attn=jnp.asarray(tensors[f"{pre}.input_layernorm.weight"]).astype(
                    jnp.float32
                ),
                ln_mlp=jnp.asarray(
                    tensors[f"{pre}.post_attention_layernorm.weight"]
                ).astype(jnp.float32),
            )
        )
    embed = jnp.asarray(tensors["model.embed_tokens.weight"]).astype(dtype)
    if "lm_head.weight" in tensors or "lm_head.qweight" in tensors:
        lm_head = q("lm_head", h)
    else:  # tied embeddings
        lm_head = embed.T
    params = dict(
        embed=embed,
        lm_head=lm_head,
        ln_final=jnp.asarray(tensors["model.norm.weight"]).astype(jnp.float32),
        layers=layers,
    )
    return params, cfg
