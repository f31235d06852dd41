"""Dense (unquantized) matmul baseline — the a16w16 comparator.

Role of the reference's fp16 dense GEMV benchmark kernel (``gemv_fp16.cu:54-130``):
the speed baseline the fused quantized path is measured against (the README's
"2x faster than a16w16", ``README.md:19-20``).  The idiomatic dense path is a
bf16 ``jnp.dot``, which XLA hands to the library GEMM — there is nothing to
hand-write.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def dense_matmul(a: jax.Array, w: jax.Array) -> jax.Array:
    """``a[..., K] @ w[K, N]`` in bf16 with f32 accumulation."""
    return jnp.dot(
        a.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    ).astype(a.dtype)
