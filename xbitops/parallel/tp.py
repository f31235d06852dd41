"""Tensor-parallel quantized matmuls over a device mesh.

The communication backend the reference never had (SURVEY §2 "Parallelism
strategies — the reference has none"): packed ``QTensor`` shards live on a
``jax.sharding.Mesh`` and the kernels run under ``shard_map`` so XLA emits the
collectives (``psum`` / ``reduce_scatter`` / ``all_gather``), which run on
NCCL between GPUs.

Two classic layouts (Megatron-style), chosen so one transformer block needs only
one collective per matmul *pair*:

- **column parallel** — shard N.  Every packed array has N as its minor axis,
  so the shard boundary is free as long as the fused kernel can block the
  shard's columns (``N_shard % 16 == 0``; contrast the reference's qzeros,
  which pack N into int32 words and would force 32/bits-aligned shards,
  ``unpack_weight_2_to_7.cu:56`` — this layout stores scale-zeros unpacked
  precisely so sharding stays trivial).
- **row parallel** — shard K.  Each device holds whole K-tiles
  (``K/tile_k % n_shards == 0``), computes a partial GEMM, and the results are
  ``psum``-ed (replicated out) or ``reduce_scatter``-ed (sharded out, to feed the
  next column-parallel layer without an all-gather).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from xbitops.formats import QTensor, is_row_sharded
from xbitops.ops.qmatmul import qmatmul

__all__ = [
    "qtensor_pspecs",
    "shard_qtensor",
    "squeeze_row_shard",
    "column_parallel_qmatmul",
    "row_parallel_qmatmul",
]


def qtensor_pspecs(
    qt: QTensor, col_axis: Optional[str] = None, row_axis: Optional[str] = None
) -> QTensor:
    """A QTensor-shaped pytree of ``PartitionSpec``s for the chosen layout.

    ``col_axis`` shards N (minor axis of every array).  ``row_axis`` shards the
    leading shard axis of a row-sharded QTensor (built by
    ``formats.make_row_sharded_qtensor``, whose leaves carry that extra axis).
    """
    if row_axis is not None and not is_row_sharded(qt):
        if qt.perm is None:
            raise ValueError(
                "row-parallel requires a row-sharded QTensor "
                "(formats.make_row_sharded_qtensor / quantize_array(row_shards=...))"
            )
        # act-order row op (desc_act o_proj): the runtime perm crosses shard
        # boundaries, so the tensor loads full and executes gathered-COLUMN
        # (TPRuntime.row all-gathers activation + output); shard its N axis
        return qtensor_pspecs(qt, col_axis=row_axis)
    lead = (row_axis,) if is_row_sharded(qt) else ()
    return QTensor(
        planes=tuple(P(*lead, None, col_axis) for _ in qt.planes),
        scales=P(*lead, None, None, col_axis),
        scale_zeros=P(*lead, None, None, col_axis),
        bits=qt.bits,
        group_size=qt.group_size,
        tile_k=qt.tile_k,
        K=qt.K,
        K_logical=qt.K_logical,
        # row-sharded act-order perms are shard-local [row_shards, Ks]
        perm=None if qt.perm is None else P(*lead, None),
        N_logical=qt.N_logical,
    )


def squeeze_row_shard(qt: QTensor) -> QTensor:
    """Inside shard_map: drop the (length-1) leading shard axis, yielding the
    self-consistent local QTensor (the stacked metadata already describes one
    shard)."""
    if qt.planes[0].shape[0] != 1:
        raise ValueError(
            f"local row-shard axis is {qt.planes[0].shape[0]}, expected 1 — the "
            f"QTensor's shard count does not match the mesh axis it was mapped "
            f"over (was the checkpoint packed for a different --tp?)"
        )
    return dataclasses.replace(
        qt,
        planes=tuple(p[0] for p in qt.planes),
        scales=qt.scales[0],
        scale_zeros=qt.scale_zeros[0],
        perm=None if qt.perm is None else qt.perm[0],
    )


def _check_shardable(qt: QTensor, mesh: Mesh, col_axis, row_axis):
    if col_axis is not None:
        n = mesh.shape[col_axis]
        if qt.N % (n * 16):
            raise ValueError(f"N={qt.N} must split into {n} shards of 16-column blocks")
    if row_axis is not None:
        n = mesh.shape[row_axis]
        if not is_row_sharded(qt):
            raise ValueError(
                "row-parallel requires a row-sharded QTensor "
                "(formats.make_row_sharded_qtensor / quantize_array(row_shards=...))"
            )
        if qt.planes[0].shape[0] != n:
            raise ValueError(
                f"QTensor has {qt.planes[0].shape[0]} row shards, mesh axis has {n}"
            )


def shard_qtensor(
    qt: QTensor,
    mesh: Mesh,
    col_axis: Optional[str] = None,
    row_axis: Optional[str] = None,
) -> QTensor:
    """Place a QTensor's arrays on the mesh with the given TP layout."""
    _check_shardable(qt, mesh, col_axis, row_axis)
    specs = qtensor_pspecs(qt, col_axis, row_axis)
    return jax.tree.map(
        lambda x, s: None if x is None else jax.device_put(x, NamedSharding(mesh, s)),
        qt, specs, is_leaf=lambda x: x is None,
    )




def column_parallel_qmatmul(
    a: jax.Array,
    qt: QTensor,
    mesh: Mesh,
    axis: str = "model",
    out_dtype=None,
    gather: bool = False,
    precise: bool = False,
) -> jax.Array:
    """``a (replicated) @ W (N-sharded) -> out`` sharded on N (or all-gathered).

    Keeping the output N-sharded feeds a following row-parallel matmul with zero
    collectives — the Megatron pairing.
    """
    _check_shardable(qt, mesh, col_axis=axis, row_axis=None)
    out_dtype = out_dtype or a.dtype
    specs = qtensor_pspecs(qt, col_axis=axis)
    out_spec = P(*([None] * (a.ndim - 1)), None if gather else axis)

    if qt.perm is not None:
        a = jnp.take(a, qt.perm, axis=-1)
        qt = dataclasses.replace(qt, perm=None)
        specs = dataclasses.replace(specs, perm=None)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(*([None] * a.ndim)), specs),
        out_specs=out_spec,
        check_vma=False,
    )
    def f(a_l, qt_l):
        o = qmatmul(a_l, qt_l, out_dtype=out_dtype, precise=precise)
        if gather:
            o = jax.lax.all_gather(o, axis, axis=o.ndim - 1, tiled=True)
        return o

    return f(a, qt)


def row_parallel_qmatmul(
    a: jax.Array,
    qt: QTensor,
    mesh: Mesh,
    axis: str = "model",
    out_dtype=None,
    reduce: str = "psum",
    precise: bool = False,
) -> jax.Array:
    """``a (K-sharded) @ W (K-sharded) -> partial sums`` reduced over the mesh.

    ``a``'s last axis is the *unpadded* global K (``row_shards * K_logical``);
    each device gets a contiguous slice matching its weight shard (which may be
    tile-padded internally — the local qmatmul zero-pads its activations).
    ``reduce='psum'`` replicates the output; ``reduce='reduce_scatter'`` leaves it
    N-sharded (rides ICI at half the bytes, pairs with a following column layer).
    """
    _check_shardable(qt, mesh, col_axis=None, row_axis=axis)
    n_shards = mesh.shape[axis]
    if a.shape[-1] != n_shards * qt.K_logical:
        raise ValueError(
            f"a K={a.shape[-1]} != row_shards*K_logical = {n_shards * qt.K_logical}"
        )
    out_dtype = out_dtype or a.dtype
    specs = qtensor_pspecs(qt, row_axis=axis)
    a_spec = P(*([None] * (a.ndim - 1)), axis)
    if reduce == "psum":
        out_spec = P(*([None] * a.ndim))
    elif reduce == "reduce_scatter":
        out_spec = P(*([None] * (a.ndim - 1)), axis)
    else:
        raise ValueError(f"unknown reduce {reduce!r}")

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(a_spec, specs),
        out_specs=out_spec,
        check_vma=False,
    )
    def f(a_l, qt_l):
        local = squeeze_row_shard(qt_l)
        o = qmatmul(a_l, local, out_dtype=jnp.float32, precise=precise)
        if reduce == "psum":
            o = jax.lax.psum(o, axis)
        else:
            o = jax.lax.psum_scatter(o, axis, scatter_dimension=o.ndim - 1, tiled=True)
        return o.astype(out_dtype)

    return f(a, qt)
