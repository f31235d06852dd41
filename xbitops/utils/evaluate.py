"""Model-quality evaluation: next-token NLL / perplexity.

The reference validates kernels numerically (golden-file element compares);
model-level quality — "does quantization preserve the distribution" — is the
framework's job.  This is the harness behind the act-order/config-4 parity
check (BASELINE.json): perplexity of a quantized model vs its dense source on
the same token stream.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from xbitops.models import llama


def sequence_nll(
    params: dict,
    cfg: llama.LlamaConfig,
    tokens: jax.Array,  # int32 [B, T]
    rt=None,
) -> jax.Array:
    """Mean next-token negative log-likelihood over positions 0..T-2, f32 [B]."""
    B, T = tokens.shape
    cache = llama.KVCache.init(cfg, B)
    logits, _ = llama.prefill(params, cfg, tokens, cache, rt)
    logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), axis=-1)
    tgt = tokens[:, 1:]
    nll = -jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
    return jnp.mean(nll, axis=1)


def perplexity(
    params: dict,
    cfg: llama.LlamaConfig,
    tokens: jax.Array,
    rt=None,
) -> float:
    """Corpus perplexity: exp(mean NLL) over all rows of ``tokens``."""
    return float(jnp.exp(jnp.mean(sequence_nll(params, cfg, tokens, rt))))
