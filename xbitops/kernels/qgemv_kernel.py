"""Fused dequantize + matmul (A16Wx GEMV/GEMM), Pallas through Triton.

Built like the reference's fused GEMV (``gemv_w4a16_pt.cu:36-147``): every
packed word is read from device memory once, decoded in registers, and no
dense weight is ever written.  Where the reference scales each decoded
weight with ``__hfma2``, this kernel feeds the raw integers (exact in bf16)
to the tensor cores and applies the group scale to the dot's output:

    out = sum_g s_g * (a_g @ wq_g) - (sum_{k in g} a_k) * sz_g

which is the reference's ``sum a*(wq*s - sz)`` (``unpack_weight_2_to_7.cu:75``)
with f32 everywhere after the dot.

It runs the single-plane widths (1, 2, 4 and 8 bits), not only the
reference's bits=4 / group_size=128 (``gemv_w4a16_pt.cu:152-155``).  The
multi-plane widths (3/5/6/7) take the plain path or, with
``storage_bits="auto"``, are stored in the next single-plane width: on the
card a kernel over several planes compiled for minutes and ran slower than
dequant-then-GEMM (PERF.md).

QTensor planes (``formats.py``): within a K-tile, slot ``j`` of a word row of
a ``pb``-bit plane holds a contiguous run of ``wt = tile_k*pb/32`` K rows, so
one word block (``R`` rows x ``BN`` columns) decodes into ``32/pb`` value
blocks by a shift and a mask each, and each value block is one dot with a
contiguous activation slice.  The paired 4-bit plane holds rows ``2r`` and
``2r+1`` in the low and high 16-bit halves; the wrapper hands the kernel its
activations reordered to match (``pair_order``), so its halves are dots with
contiguous slices too.

Work is cut into *units*: one unit is ``R`` word rows of one K-tile and every
slot of those rows — each word is loaded once and all of its values are used
from registers.  A program owns ``BN`` output columns and a contiguous range
of units; with few column tiles the K range splits across programs (split-K)
and a second pass sums the partials, so that a 4096-column projection still
fills the card.  The stacked layer index of a scanned model is read from an
operand.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from xbitops.formats import QTensor
from xbitops.kernels import common

# Word rows per unit are capped so a (rows, BN) int32 block stays in registers.
MAX_UNIT_ROWS = 64
BLOCK_N = 128
# Decode-sized M runs in one M tile; larger M tiles at BLOCK_M_MAX rows.
BLOCK_M_MAX = 64
# Aim for this many programs when choosing the split-K factor: two per SM
# of a 132-SM card keeps every SM busy through the tail.
TARGET_PROGRAMS = 264
NUM_WARPS = 4
NUM_STAGES = 3


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    pb: int  # plane bits
    paired: bool  # paired 4-bit layout
    wt: int  # word rows per K-tile
    rows: int  # word rows per unit
    units_per_tile: int
    g_tile: int  # K rows per scale row


def kernel_plan(qt: QTensor) -> Optional[KernelPlan]:
    """The unit structure for ``qt``, or None when it is multi-plane or its
    tile geometry has no power-of-two blocks of 16+ rows (Triton needs them)
    — those take the plain path."""
    if len(qt.plane_bits) != 1:
        return None
    pb = qt.plane_bits[0]
    tk = qt.tile_k
    g_tile = tk // qt.groups_per_tile
    if not (common.is_pow2(tk) and common.is_pow2(g_tile)):
        return None
    paired = qt.paired
    wt = tk // 8 if paired else tk * pb // 32
    # a unit's rows of one slot must stay inside one scale group
    rows = min(MAX_UNIT_ROWS, wt, g_tile // 2 if paired else g_tile)
    if rows < 16:
        return None
    return KernelPlan(pb, paired, wt, rows, wt // rows, g_tile)


def pair_order(a: jax.Array, tile_k: int) -> jax.Array:
    """Reorder activation columns ``(M, K)`` to the paired 4-bit plane's
    order: inside each K-tile, local row ``j*tile_k/4 + 2r + h`` moves to
    column ``j*tile_k/4 + h*tile_k/8 + r``."""
    M, K = a.shape
    wt = tile_k // 8
    return (
        a.reshape(M, K // tile_k, 4, wt, 2).swapaxes(-1, -2).reshape(M, K)
    )


def block_n(N: int) -> Optional[int]:
    """Output columns per program: BLOCK_N, or the largest smaller power of
    two >= 16 that divides N (a tensor-parallel shard's N need not be a
    multiple of BLOCK_N); None when no such block exists."""
    bn = BLOCK_N
    while bn >= 16:
        if N % bn == 0:
            return bn
        bn //= 2
    return None


def split_plan(n_col_tiles: int, n_m_tiles: int, units: int) -> int:
    """Split-K factor: enough K splits to bring the grid up to
    TARGET_PROGRAMS (1 when the columns alone fill the card), each split at
    least one unit."""
    return max(1, min(units, TARGET_PROGRAMS // (n_col_tiles * n_m_tiles)))


def _f32_scale(x):
    """Stored scale row -> f32 (fp16 bit patterns in int16, or floats)."""
    if x.dtype == jnp.int16:
        return jax.lax.bitcast_convert_type(x, jnp.float16).astype(jnp.float32)
    return x.astype(jnp.float32)


def _kernel(plan: KernelPlan, tk, units, ups, BM, BN, compute_dtype, split,
            *refs):
    li_ref, a_ref, p_ref, s_ref, sz_ref, o_ref = refs
    li = li_ref[0]
    cols = pl.ds(pl.program_id(0) * BN, BN)
    sp = pl.program_id(1)
    m_rows = pl.ds(pl.program_id(2) * BM, BM)
    R, wt, n_u = plan.rows, plan.wt, plan.units_per_tile
    prec = jax.lax.Precision.HIGHEST if compute_dtype == jnp.float32 else None
    # per slot: (shift, first K row, first activation column, K-row stride)
    if plan.paired:
        ph = 2 * wt  # K rows per pair slot
        slots = [(4 * j + 16 * h, j * ph, j * ph + h * wt, 2)
                 for j in range(4) for h in range(2)]
        mask = 15
    else:
        slots = [(plan.pb * j, j * wt, j * wt, 1) for j in range(32 // plan.pb)]
        mask = (1 << plan.pb) - 1

    def scale_row(ref, t, g):
        return _f32_scale(ref[li, t, g, cols])

    def unit(u, acc):
        t = u // n_u
        rc = u % n_u
        words = p_ref[li, pl.ds(t * wt + rc * R, R), cols]  # (R, BN)
        for sh, row0, col0, stride in slots:
            q = (words if sh == 0 else words >> sh) & mask
            ablk = a_ref[m_rows, pl.ds(t * tk + col0 + rc * R, R)]
            d = pl.dot(ablk, q.astype(compute_dtype), precision=prec)
            g = (row0 + stride * rc * R) // plan.g_tile
            # each K row passes through exactly one block: its zero term
            # rides along with the block's activation sums
            asum = ablk.astype(jnp.float32).sum(axis=1)[:, None]
            acc = (acc + d * scale_row(s_ref, t, g)[None, :]
                   - asum * scale_row(sz_ref, t, g)[None, :])
        return acc

    u0 = sp * ups
    acc = jax.lax.fori_loop(
        u0, jnp.minimum(u0 + ups, units), unit, jnp.zeros((BM, BN), jnp.float32)
    )
    if split:
        o_ref[sp, m_rows, cols] = acc
    else:
        o_ref[m_rows, cols] = acc.astype(o_ref.dtype)


@functools.partial(
    jax.jit, static_argnames=("out_dtype", "precise", "interpret", "n_split")
)
def qmatmul_kernel(
    a: jax.Array,
    qt: QTensor,
    out_dtype=jnp.bfloat16,
    precise: bool = False,
    interpret: Optional[bool] = None,
    layer_idx: Optional[jax.Array] = None,
    n_split: Optional[int] = None,
) -> jax.Array:
    """``a (M, K) @ dequant(qt) (K, N) -> (M, N)``, fused; ``a`` in stored row
    order and padded to ``qt.K`` columns (the public op in ``ops/qmatmul.py``
    does both).  ``precise=True`` runs f32 operands and IEEE f32 dots (the
    reference's f32-accumulation variant, ``gemv_w4a16_c32.cu``); otherwise
    activations round to bf16 and the integer weights are exact.

    ``layer_idx`` (traced int32 scalar): the QTensor leaves carry a leading
    layer axis and the kernel reads that layer in place.
    """
    if interpret is None:
        interpret = common.interpret_default()
    plan = kernel_plan(qt)
    if plan is None:
        raise ValueError(f"no kernel plan for tile_k={qt.tile_k}, "
                         f"group_size={qt.group_size}, bits={qt.bits}")
    stacked = layer_idx is not None
    assert qt.planes[0].ndim == (3 if stacked else 2), "layer_idx vs rank"
    plane, scales, zeros = qt.planes[0], qt.scales, qt.scale_zeros
    if not stacked:  # one code path: a layer axis of 1
        plane, scales, zeros = plane[None], scales[None], zeros[None]
        layer_idx = 0
    M, K = a.shape
    N = plane.shape[-1]
    assert K == qt.K, f"activation K={K} != packed K={qt.K}"
    compute_dtype = jnp.float32 if precise else jnp.bfloat16
    a = a.astype(compute_dtype)

    BM = common.round_up(M, 16) if M <= BLOCK_M_MAX else BLOCK_M_MAX
    Mp = common.round_up(M, BM)
    if Mp != M:
        a = jnp.pad(a, ((0, Mp - M), (0, 0)))
    if plan.paired:
        a = pair_order(a, qt.tile_k)
    BN = block_n(N)
    units = (K // qt.tile_k) * plan.units_per_tile
    n_col, n_m = N // BN, Mp // BM
    n_split = n_split or split_plan(n_col, n_m, units)
    ups = common.cdiv(units, n_split)
    n_split = common.cdiv(units, ups)  # no empty splits
    split = n_split > 1
    out_shape = (
        jax.ShapeDtypeStruct((n_split, Mp, N), jnp.float32) if split
        else jax.ShapeDtypeStruct((Mp, N), out_dtype)
    )
    out = pl.pallas_call(
        functools.partial(
            _kernel, plan, qt.tile_k, units, ups, BM, BN, compute_dtype, split,
        ),
        grid=(n_col, n_split, n_m),
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        cost_estimate=pl.CostEstimate(
            flops=2 * Mp * N * K,
            bytes_accessed=plane[0].size * 4 + Mp * K * a.dtype.itemsize
            + Mp * N * 4,
            transcendentals=0,
        ),
        interpret=interpret,
        backend="triton",
        name="qmatmul",
    )(jnp.asarray(layer_idx, jnp.int32).reshape(1), a, plane, scales, zeros)
    if split:
        out = out.sum(axis=0).astype(out_dtype)
    return out[:M]
