"""GPTQ quantization (Hessian error compensation) on the accelerator.

The reference consumes GPTQ checkpoints but cannot create them; this module
implements the GPTQ algorithm (Frantar et al., 2022 — the method behind the
AutoGPTQ checkpoints the reference targets) natively in JAX:

  for each input row k (our weights are [K, N], quantized along K):
    quantize row k against its group's scale/zero;
    propagate the rounding error to later rows, weighted by the inverse
    Hessian of the layer inputs (H = 2 X^T X), so later rows compensate.

Blocked exactly like the standard implementation: an inner sequential pass
inside each 128-row block (a ``lax.fori_loop``), then one matmul pushes the
block's accumulated error to all remaining rows (``lax.scan`` over blocks —
one compiled body regardless of K).

Act-order (``desc_act``) quantizes rows by descending Hessian diagonal; the
permutation is returned in the :class:`~xbitops.formats.QTensor`
convention (stored row k = logical row perm[k]).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from xbitops import formats
from xbitops.formats import QTensor


def hessian_from_inputs(x: jax.Array, prev: Optional[jax.Array] = None) -> jax.Array:
    """Accumulate the GPTQ Hessian ``H = 2 X^T X`` from inputs ``x [..., K]``."""
    x2 = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
    h = 2.0 * jnp.dot(x2.T, x2, precision=jax.lax.Precision.HIGHEST)
    return h if prev is None else prev + h


def _find_params(wg: jax.Array, maxq: int) -> Tuple[jax.Array, jax.Array]:
    """Asymmetric per-column min/max scale/zero over group rows ``wg [g, N]``."""
    lo = jnp.minimum(jnp.min(wg, axis=0), 0.0)
    hi = jnp.maximum(jnp.max(wg, axis=0), 0.0)
    scale = jnp.maximum((hi - lo) / maxq, 1e-8)
    # fp16 scale BEFORE q/zero so they compensate the deployed (FP16_BITS)
    # value — keeps the identity-Hessian == formats.quantize gate exact
    scale = scale.astype(jnp.float16).astype(jnp.float32)
    zero = jnp.clip(jnp.round(-lo / scale), 0, maxq)
    return scale, zero


@partial(jax.jit, static_argnames=("bits", "group_size", "block_size", "act_order"))
def gptq_quantize_weight(
    w: jax.Array,  # [K, N] float
    H: jax.Array,  # [K, K] Hessian of the layer inputs (2 X^T X)
    bits: int,
    group_size: int = 128,
    act_order: bool = False,
    percdamp: float = 0.01,
    block_size: int = 128,
):
    """GPTQ-quantize ``w`` along K.  Returns ``(wq int32 [K,N], scales [G,N],
    zeros [G,N], perm or None)`` — feed straight into ``formats.make_qtensor``
    (with the same ``perm``) or compare against RTN.
    """
    K, N = w.shape
    if K % group_size:
        raise ValueError(
            f"K={K} must be a multiple of group_size={group_size} "
            f"(pad the weight rows first)"
        )
    bs = min(block_size, group_size, K)
    if K % bs or group_size % bs:
        raise ValueError(f"K={K} and group_size={group_size} must be multiples "
                         f"of block_size={bs}")
    maxq = (1 << bits) - 1
    w = w.astype(jnp.float32)
    H = H.astype(jnp.float32)

    diag = jnp.diagonal(H)
    perm = None
    if act_order:
        perm = jnp.argsort(-diag).astype(jnp.int32)
        w = jnp.take(w, perm, axis=0)
        H = jnp.take(jnp.take(H, perm, axis=0), perm, axis=1)
        diag = jnp.diagonal(H)

    # dead inputs: no signal, pin the diagonal and zero the weight row
    dead = diag == 0
    H = H + jnp.diag(jnp.where(dead, 1.0, 0.0))
    w = jnp.where(dead[:, None], 0.0, w)
    # dampening (standard GPTQ): percdamp * mean(diag) on the diagonal
    H = H + jnp.eye(K) * (percdamp * jnp.mean(jnp.diagonal(H)))

    # U = upper Cholesky factor of H^-1 (H^-1 = U^T U = L L^T with U = L^T):
    # the error-propagation weights.  Force true-f32 matmuls throughout the
    # linear algebra (f32 matmuls may run as TF32 or bf16 by default).
    with jax.default_matmul_precision("float32"):
        Linv = jnp.linalg.inv(jnp.linalg.cholesky(H))  # H = C C^T, Linv = C^-1
        Hinv = jnp.dot(Linv.T, Linv)  # H^-1
        U = jnp.linalg.cholesky(Hinv).T  # upper: H^-1 = U^T U

    n_blocks = K // bs
    hi_p = jax.lax.Precision.HIGHEST

    def block_step(carry, b):
        W, scale_cur, zero_cur = carry
        k0 = b * bs
        Wb = jax.lax.dynamic_slice(W, (k0, 0), (bs, N))
        Ub = jax.lax.dynamic_slice(U, (k0, k0), (bs, bs))

        # group boundary at this block? recompute scale/zero from the current
        # (error-compensated) values of the next group_size rows
        is_group_start = (k0 % group_size) == 0
        g_rows = jax.lax.dynamic_slice(W, (k0, 0), (min(group_size, K), N))
        s_new, z_new = _find_params(g_rows[: group_size], maxq)
        scale_cur = jnp.where(is_group_start, s_new, scale_cur)
        zero_cur = jnp.where(is_group_start, z_new, zero_cur)

        def row_step(i, st):
            Wb, Q, Err = st
            wr = Wb[i]  # (N,)
            q = jnp.clip(jnp.round(wr / scale_cur + zero_cur), 0, maxq)
            dq = (q - zero_cur) * scale_cur
            d = Ub[i, i]
            err = (wr - dq) / d
            # push the error to the REST of this block (rows > i)
            row_ids = jnp.arange(bs)
            upd = jnp.where((row_ids > i)[:, None], Ub[i][:, None] * err[None, :], 0.0)
            Wb = Wb - upd
            Q = Q.at[i].set(q)
            Err = Err.at[i].set(err)
            return Wb, Q, Err

        Wb, Q, Err = jax.lax.fori_loop(
            0, bs, row_step,
            (Wb, jnp.zeros((bs, N), jnp.float32), jnp.zeros((bs, N), jnp.float32)),
        )

        # push the block's error to all LATER rows: W -= U[blk, :].T @ Err,
        # masked to rows past the block (one dense matmul, then mask)
        U_rows = jax.lax.dynamic_slice(U, (k0, 0), (bs, K))  # (bs, K)
        full_upd = jnp.dot(U_rows.T, Err, precision=hi_p)  # (K, N)
        later = (jnp.arange(K) >= k0 + bs)[:, None]
        W = W - jnp.where(later, full_upd, 0.0)

        return (W, scale_cur, zero_cur), (Q, scale_cur, zero_cur)

    init = (w, jnp.ones(N, jnp.float32), jnp.zeros(N, jnp.float32))
    _, (Qb, s_b, z_b) = jax.lax.scan(block_step, init, jnp.arange(n_blocks))

    wq = Qb.reshape(K, N).astype(jnp.int32)
    m = group_size // bs  # blocks per group: keep the first block's params
    scales = s_b.reshape(n_blocks // m, m, N)[:, 0, :]
    zeros = z_b.reshape(n_blocks // m, m, N)[:, 0, :].astype(jnp.int32)
    return wq, scales, zeros, perm


def gptq_quantize_array(
    w: jax.Array,
    H: jax.Array,
    bits: int,
    group_size: int = 128,
    act_order: bool = False,
    percdamp: float = 0.01,
    tile_k: Optional[int] = None,
    scale_store_dtype=formats.FP16_BITS,
) -> QTensor:
    """GPTQ-quantize and pack into the native layout in one step."""
    wq, scales, zeros, perm = gptq_quantize_weight(
        w, H, bits, group_size, act_order=act_order, percdamp=percdamp
    )
    return formats.make_qtensor(
        wq, scales, zeros, bits, group_size, tile_k=tile_k, perm=perm,
        scale_store_dtype=scale_store_dtype,
    )


# ---------------------------------------------------------------------------
# Model-level driver: calibrate + quantize a dense Llama layer by layer
# ---------------------------------------------------------------------------


def quantize_model_gptq(
    params: dict,
    cfg,
    calib_tokens: jax.Array,  # int32 [B, T] calibration prompts
    bits: int = 4,
    group_size: int = 128,
    act_order: bool = False,
    percdamp: float = 0.01,
    verbose: bool = False,
) -> dict:
    """GPTQ-quantize a DENSE Llama param tree (``init_params(bits=None)`` /
    dense checkpoint), layer by layer, in the standard sequential fashion:
    each projection's Hessian comes from ITS actual inputs, and each layer's
    outputs are recomputed with the already-quantized weights so later layers
    compensate earlier quantization error.

    Supports the fused (wqkv / w_gateup) and unfused layouts; embeddings and
    norms stay dense; requires tp == 1 (quantize first, shard after).
    """
    from xbitops.models import llama
    from xbitops.ops.qmatmul import qmatmul

    B, T = calib_tokens.shape
    H_, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = params["embed"][calib_tokens].astype(jnp.bfloat16)
    positions = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    causal = jnp.tril(jnp.ones((T, T), bool))[None]

    def gq(w, h_in):
        return gptq_quantize_array(
            jnp.asarray(w, jnp.float32), h_in, bits, group_size,
            act_order=act_order, percdamp=percdamp,
        )

    def mm(a, qt):
        return qmatmul(a, qt, out_dtype=a.dtype)

    new_layers = []
    for li, layer in enumerate(params["layers"]):
        hx = llama.rms_norm(x, layer["ln_attn"], cfg.rms_eps)
        h_attn = hessian_from_inputs(hx)
        nl = dict(ln_attn=layer["ln_attn"], ln_mlp=layer["ln_mlp"])
        if "wqkv" in layer:
            nl["wqkv"] = gq(layer["wqkv"], h_attn)
            qkv = mm(hx, nl["wqkv"])
            qdim, kvdim = H_ * D, Hkv * D
            q = qkv[..., :qdim]
            k = qkv[..., qdim : qdim + kvdim]
            v = qkv[..., qdim + kvdim :]
        else:
            nl["wq"] = gq(layer["wq"], h_attn)
            nl["wk"] = gq(layer["wk"], h_attn)
            nl["wv"] = gq(layer["wv"], h_attn)
            q, k, v = mm(hx, nl["wq"]), mm(hx, nl["wk"]), mm(hx, nl["wv"])
        q = llama._rope(q.reshape(B, T, H_, D), positions, cfg.rope_theta)
        k = llama._rope(k.reshape(B, T, Hkv, D), positions, cfg.rope_theta)
        v = v.reshape(B, T, Hkv, D)
        # _attention consumes head-major k/v (cache layout); fresh projections
        # transpose their small [B, T, Hkv, D] tensors
        att = llama._attention(
            q, jnp.swapaxes(k, 1, 2), jnp.swapaxes(v, 1, 2), causal, D ** -0.5
        ).reshape(B, T, H_ * D)

        nl["wo"] = gq(layer["wo"], hessian_from_inputs(att))
        x = x + mm(att, nl["wo"])

        hx2 = llama.rms_norm(x, layer["ln_mlp"], cfg.rms_eps)
        if "router" in layer:
            # sparse MoE FFN: each expert's Hessian comes from the tokens the
            # router actually sends it (its true input distribution); layer
            # output recombines with the router weights so later layers see
            # the quantized-expert residual stream.
            ffn = cfg.intermediate_size
            x2 = hx2.reshape(-1, hx2.shape[-1])
            logits = jnp.dot(
                x2.astype(jnp.float32), layer["router"].astype(jnp.float32)
            )
            gate, idx = jax.lax.top_k(logits, cfg.experts_per_token)
            probs = jax.nn.softmax(gate, axis=-1)
            idx_np = jnp.asarray(idx)
            y = jnp.zeros(x2.shape, jnp.float32)
            gus, downs = [], []
            for e in range(cfg.n_experts):
                routed = (idx_np == e).any(-1)
                sel = jnp.nonzero(routed)[0]
                # unrouted experts still get quantized — against the full
                # token stream (no better input distribution available)
                xe = x2[sel] if sel.size else x2
                qgu = gq(layer["w_experts_gateup"][e], hessian_from_inputs(xe))
                gu = mm(xe, qgu)
                act = (jax.nn.silu(gu[..., :ffn].astype(jnp.float32))
                       * gu[..., ffn:].astype(jnp.float32)).astype(x2.dtype)
                qdown = gq(layer["w_experts_down"][e],
                           hessian_from_inputs(act))
                gus.append(qgu)
                downs.append(qdown)
                if sel.size:
                    pe = jnp.sum(
                        jnp.where(idx[sel] == e, probs[sel], 0.0), axis=-1
                    )
                    y = y.at[sel].add(
                        pe[:, None]
                        * mm(act, qdown).astype(jnp.float32)
                    )
            from xbitops.models.moe import stack_experts

            nl["router"] = layer["router"]
            nl["w_experts_gateup"] = stack_experts(gus)
            nl["w_experts_down"] = stack_experts(downs)
            x = x + y.reshape(x.shape).astype(x.dtype)
            new_layers.append(nl)
            if verbose:
                print(f"  gptq layer {li + 1}/{len(params['layers'])} (moe)",
                      flush=True)
            continue
        h_mlp = hessian_from_inputs(hx2)
        if "w_gateup" in layer:
            nl["w_gateup"] = gq(layer["w_gateup"], h_mlp)
            gu = mm(hx2, nl["w_gateup"])
            gate, up = gu[..., : cfg.intermediate_size], gu[..., cfg.intermediate_size :]
        else:
            nl["w_gate"] = gq(layer["w_gate"], h_mlp)
            nl["w_up"] = gq(layer["w_up"], h_mlp)
            gate, up = mm(hx2, nl["w_gate"]), mm(hx2, nl["w_up"])
        act = (jax.nn.silu(gate.astype(jnp.float32)) * up.astype(jnp.float32)).astype(x.dtype)
        nl["w_down"] = gq(layer["w_down"], hessian_from_inputs(act))
        x = x + mm(act, nl["w_down"])
        new_layers.append(nl)
        if verbose:
            print(f"  gptq layer {li + 1}/{len(params['layers'])}", flush=True)

    hxf = llama.rms_norm(x, params["ln_final"], cfg.rms_eps)
    lm_head = params["lm_head"]
    if hasattr(lm_head, "dtype"):  # dense head -> quantize against final acts
        lm_head = gq(lm_head, hessian_from_inputs(hxf))
    return dict(
        embed=params["embed"],
        lm_head=lm_head,
        ln_final=params["ln_final"],
        layers=new_layers,
    )
