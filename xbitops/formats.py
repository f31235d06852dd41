"""Quantized-weight formats: the GPTQ interchange layout and the native plane layout.

Two layouts live here:

1. **GPTQ interchange format** — bit-for-bit the layout the reference library
   consumes (see reference ``dq_torch_ops.cc:23-78`` for the signature contract and
   ``unpack_weight_2_to_7.cu:45-120`` for the packing rule):

   - ``qweight``: ``int32[ceil(K*bits/32), N]`` — values packed **along K** inside
     each int32 column word, low bits first.  For bit-widths that don't divide 32
     (3/5/6/7), values straddle word boundaries.
   - ``scales``: ``f16|bf16[ceil(K/group_size), N]``.
   - ``qzeros``: ``int32[ceil(K/group_size), ceil(N*bits/32)]`` — zero-points packed
     **along N**.
   - Dequant rule: ``w = wq*s - (z + add_zero_bias)*s``
     (reference ``unpack_weight_2_to_7.cu:75``); ``add_zero_bias`` is 1 for old GPTQ
     checkpoints that store ``zero-1``.
   - Act-order: an optional ``g_idx: int32[K]`` maps each row to its group
     (semantics of the reference's disabled ``VecQuant4MatMulKernel_G``,
     ``quant_cuda_kernel.cu:257-336``).

2. **Native plane layout** (``QTensor``) — what every hot kernel consumes.  It is
   *derived* from the interchange format at load time and designed so that
   unpacking is nothing but elementwise shift/mask, with no shuffles:

   - Each b-bit value is decomposed into **bit-planes** of power-of-two widths
     (``PLANE_DECOMP``): e.g. 5-bit = a 4-bit plane + a 1-bit plane.  Every plane
     packs exactly ``32/pb`` values per int32 word, so there are never cross-word
     reads, and total storage is exactly ``bits`` bits/weight (the reference instead
     stages word pairs in CUDA shared memory for 3/5/6/7,
     ``unpack_weight_2_to_7.cu:224-239``).
   - Within each K-tile of ``tile_k`` rows, values are packed **slot-strided**:
     local row ``k`` lives in bit-slot ``k // (tile_k/ratio)`` of word-row
     ``k % (tile_k/ratio)``.  Unpacking a tile is then
     ``concat([(w >> pb*j) & mask for j in range(ratio)], axis=0)`` — each slot
     decodes to a *contiguous* run of K rows, which the fused kernel multiplies
     with one contiguous activation slice.
   - Zero-points are not stored packed; instead ``scale_zeros = (z + bias) * s`` is
     precomputed (rounded through the source dtype to preserve the reference's
     ``__hfma2(wq, s, -s*z)`` numerics), so the kernel's dequant is a single FMA.
   - Act-order rows are pre-sorted by group at pack time (the exllama trick) and the
     permutation is stored so activations can be gathered instead of the weights.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "PLANE_DECOMP",
    "QTensor",
    "quantize",
    "gptq_pack",
    "gptq_unpack_weight",
    "gptq_unpack_zeros",
    "dequant_reference",
    "concat_qtensors",
    "pack_planes",
    "paired_plane_layout",
    "unpack_planes_reference",
    "from_gptq",
    "default_tile_k",
]

# Bit-plane decomposition for every supported width.  Planes are listed with their
# in-value bit offsets accumulating left to right: value = sum(plane_j << offset_j).
PLANE_DECOMP: dict[int, Tuple[int, ...]] = {
    1: (1,),
    2: (2,),
    3: (2, 1),
    4: (4,),
    5: (4, 1),
    6: (4, 2),
    7: (4, 2, 1),
    8: (8,),
}

SUPPORTED_BITS = tuple(sorted(PLANE_DECOMP))

# Storage-width policy.  A multi-plane width can decode slower than the next
# power-of-two width (one extraction and dot per plane); for speed-critical
# deployments the quantized VALUES stay b-bit but are STORED in the next
# power-of-two's planes — trading bytes for the wider kernel's wall-clock.
# ``"auto"`` pads the widths in AUTO_PAD_WIDTHS (see PERF.md for the
# measurement that chose them); ``"packed"`` always keeps exact b-bit
# storage.
POW2_STORAGE = {1: 1, 2: 2, 3: 4, 4: 4, 5: 8, 6: 8, 7: 8, 8: 8}
AUTO_PAD_WIDTHS = frozenset({3, 5, 6, 7})

# Default scale storage: binary16 BIT PATTERNS in int16 arrays.  GPTQ
# checkpoints carry fp16 scales, and the reference's dequant FMA uses the
# fp16 ``s`` / ``-s*z`` operands directly (``unpack_weight_2_to_7.cu:64,75``)
# — storing the bits is therefore exact-to-reference AND halves the scale
# stream vs f32.  Kernels bitcast the rows to fp16 and widen them to f32.
FP16_BITS = "fp16_bits"


def encode_scale_store(arr: jax.Array, store_dtype) -> jax.Array:
    """Encode a float scale array for storage (see ``FP16_BITS``)."""
    if store_dtype == FP16_BITS:
        return jax.lax.bitcast_convert_type(
            arr.astype(jnp.float16), jnp.int16
        )
    return arr.astype(store_dtype)


def decode_scale_store(arr: jax.Array) -> jax.Array:
    """Stored scale array -> f32."""
    if arr.dtype == jnp.int16:
        return jax.lax.bitcast_convert_type(arr, jnp.float16).astype(
            jnp.float32
        )
    return arr.astype(jnp.float32)


def resolve_storage_bits(bits: int, storage_bits) -> int:
    """Resolve a ``storage_bits`` spec (None/"packed", "auto", or an int) to the
    plane width actually used for packing."""
    if storage_bits in (None, "packed"):
        return bits
    if storage_bits == "auto":
        return POW2_STORAGE[bits] if bits in AUTO_PAD_WIDTHS else bits
    sb = int(storage_bits)
    if sb not in PLANE_DECOMP or sb < bits:
        raise ValueError(f"storage_bits={storage_bits} invalid for bits={bits}")
    return sb


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tile_group_compatible(tile_k: int, group_size: int) -> bool:
    return tile_k % group_size == 0 or group_size % tile_k == 0


def min_tile_k(bits: int) -> int:
    """Smallest legal K-tile: every plane's word block spans >= 8 word rows,
    so the narrowest plane (ratio = 32/pb values per word) needs
    tile_k >= 8 * 32/min(plane_bits)."""
    return 8 * (32 // min(PLANE_DECOMP[bits]))


def default_tile_k(K: int, group_size: int, bits: int = 1) -> int:
    """Pick a K-tile size: >= min_tile_k(bits), aligned with group boundaries.

    Strongly prefers the **ratio-aligned** tile ``max_ratio * group_size``
    (max_ratio = values/word of the narrowest plane): then every plane slot
    holds whole scale groups (see ``kernels.qgemv_kernel.kernel_plan``).  K
    pads up to a tile multiple; the aligned tile is used when that wastes
    <= 1/8 of K.  Falls back to the largest K-dividing group-compatible tile."""
    floor = min_tile_k(bits)
    max_ratio = 32 // min(PLANE_DECOMP[bits])
    aligned = max_ratio * group_size
    if aligned % floor == 0 and aligned <= 4096:
        pad = _round_up(K, aligned) - K
        if pad * 8 <= K:
            return aligned
    cands = [c for c in (1024, 512, 256, 128, 64, 32) if c >= floor]
    for cand in cands:
        if K % cand == 0 and _tile_group_compatible(cand, group_size):
            return cand
    for cand in cands:
        if _tile_group_compatible(cand, group_size):
            return cand
    import math

    return math.lcm(group_size, floor)


# ---------------------------------------------------------------------------
# Quantization (float -> (wq, scales, zeros)) — used for tests, fixtures and
# on-the-fly model quantization.  Asymmetric per-group min/max, GPTQ conventions.
# ---------------------------------------------------------------------------


def quantize(
    w: np.ndarray, bits: int, group_size: int, sym: bool = False
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantize a float weight ``w[K, N]`` to ``bits`` with per-group scale/zero.

    Returns ``(wq uint8[K,N], scales f32[G,N], zeros uint8[G,N])`` satisfying
    ``w ≈ (wq - z) * s`` (the reference dequant rule with ``add_zero_bias=0``).
    """
    K, N = w.shape
    G = _cdiv(K, group_size)
    maxq = (1 << bits) - 1
    wq = np.zeros((K, N), np.uint8)
    scales = np.zeros((G, N), np.float32)
    zeros = np.zeros((G, N), np.uint8)
    for g in range(G):
        blk = w[g * group_size : (g + 1) * group_size].astype(np.float64)
        if sym:
            amax = np.abs(blk).max(axis=0)
            scale = np.maximum(amax / (maxq / 2), 1e-8)
            # fp16 scale BEFORE choosing q: deployed scales are fp16 (GPTQ
            # checkpoint convention / FP16_BITS storage), so q and zero must
            # compensate the rounded scale, like real GPTQ quantizers
            scale = scale.astype(np.float16).astype(np.float64)
            zero = np.full(N, (maxq + 1) // 2, np.float64)
        else:
            lo, hi = blk.min(axis=0), blk.max(axis=0)
            lo = np.minimum(lo, 0)
            hi = np.maximum(hi, 0)
            scale = np.maximum((hi - lo) / maxq, 1e-8)
            scale = scale.astype(np.float16).astype(np.float64)  # see above
            zero = np.clip(np.round(-lo / scale), 0, maxq)
        q = np.clip(np.round(blk / scale + zero), 0, maxq)
        wq[g * group_size : (g + 1) * group_size] = q.astype(np.uint8)
        scales[g] = scale.astype(np.float32)
        zeros[g] = zero.astype(np.uint8)
    return wq, scales, zeros


# ---------------------------------------------------------------------------
# GPTQ interchange packing (numpy; offline/tooling path)
# ---------------------------------------------------------------------------


def _pack_bits_np(vals: np.ndarray, bits: int, axis: int) -> np.ndarray:
    """Pack integer ``vals`` (< 2**bits) into int32 words along ``axis``, low bits
    first, values straddling word boundaries for bits not dividing 32 — the
    reference's packing rule (``unpack_weight_2_to_7.cu:88-102``)."""
    vals = np.moveaxis(vals, axis, 0)
    K = vals.shape[0]
    nwords = _cdiv(K * bits, 32)
    out = np.zeros((nwords,) + vals.shape[1:], np.uint64)
    for k in range(K):
        p = k * bits
        wi, off = divmod(p, 32)
        v = vals[k].astype(np.uint64)
        out[wi] |= (v << off) & 0xFFFFFFFF
        if off + bits > 32:
            out[wi + 1] |= v >> (32 - off)
    # contiguous: downstream serializers (safetensors) mishandle strided views
    return np.ascontiguousarray(
        np.moveaxis(out.astype(np.uint32).view(np.int32), 0, axis)
    )


def gptq_pack(
    wq: np.ndarray,
    scales: np.ndarray,
    zeros: np.ndarray,
    bits: int,
    scale_dtype=np.float16,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Produce reference-layout ``(qweight, scales, qzeros)`` from integer values.

    ``qweight`` packs along K (``dq_torch_ops.cc:31``), ``qzeros`` packs along N
    (``unpack_weight_2_to_7.cu:56``).
    """
    qweight = _pack_bits_np(wq.astype(np.uint32), bits, axis=0)
    qzeros = _pack_bits_np(zeros.astype(np.uint32), bits, axis=1)
    return qweight, scales.astype(scale_dtype), qzeros


# ---------------------------------------------------------------------------
# GPTQ interchange unpacking (jnp; load path + numerical oracle)
# ---------------------------------------------------------------------------


def _unpack_bits_jnp(words: jax.Array, bits: int, n_vals: int, axis: int) -> jax.Array:
    """Inverse of :func:`_pack_bits_np` in jnp (vectorized gather; handles
    word-straddling values for 3/5/6/7 bits)."""
    w = jnp.moveaxis(words, axis, 0).astype(jnp.uint32)
    k = jnp.arange(n_vals, dtype=jnp.uint32)
    bitpos = k * np.uint32(bits)
    wi = (bitpos // 32).astype(jnp.int32)
    off = bitpos % 32
    mask = jnp.uint32((1 << bits) - 1)
    lo = jnp.take(w, wi, axis=0)
    extra = tuple([1] * (w.ndim - 1))
    off_b = off.reshape((-1,) + extra)
    vals = (lo >> off_b) & mask
    need_hi = off + bits > 32
    hi_idx = jnp.minimum(wi + 1, w.shape[0] - 1)
    hi = jnp.take(w, hi_idx, axis=0)
    shift_hi = jnp.where(need_hi, 32 - off, 0).reshape((-1,) + extra)
    hi_part = jnp.where(need_hi.reshape((-1,) + extra), (hi << shift_hi) & mask, 0)
    vals = vals | hi_part
    return jnp.moveaxis(vals.astype(jnp.int32), 0, axis)


def gptq_unpack_weight(qweight: jax.Array, bits: int, K: int) -> jax.Array:
    """``int32[ceil(K*bits/32), N]`` → integer values ``int32[K, N]``."""
    return _unpack_bits_jnp(qweight, bits, K, axis=0)


def gptq_unpack_zeros(qzeros: jax.Array, bits: int, N: int) -> jax.Array:
    """``int32[G, ceil(N*bits/32)]`` → zero-points ``int32[G, N]``."""
    return _unpack_bits_jnp(qzeros, bits, N, axis=1)


def dequant_reference(
    qweight: jax.Array,
    scales: jax.Array,
    qzeros: jax.Array,
    group_size: int,
    bits: int,
    in_features: int,
    add_zero_bias: int = 0,
    g_idx: Optional[jax.Array] = None,
    out_dtype=None,
) -> jax.Array:
    """Pure-jnp numerical oracle for the reference's ``dequant`` op.

    Matches ``w = wq*s - (z+bias)*s`` (``unpack_weight_2_to_7.cu:75``) with the
    product ``s*(z+bias)`` rounded through the scale dtype first, mirroring the
    reference's ``__hmul2`` → ``__hfma2`` sequence.  With ``g_idx`` given, groups are
    taken per-row (act-order, ``quant_cuda_kernel.cu:311-323`` semantics).
    """
    K = in_features
    N = scales.shape[1]
    out_dtype = out_dtype or scales.dtype
    wq = gptq_unpack_weight(qweight, bits, K).astype(jnp.float32)
    z = gptq_unpack_zeros(qzeros, bits, N).astype(jnp.float32) + add_zero_bias
    s = scales.astype(jnp.float32)
    sz = (scales * z.astype(scales.dtype)).astype(scales.dtype).astype(jnp.float32)
    if g_idx is None:
        gid = jnp.arange(K) // group_size
    else:
        gid = g_idx.astype(jnp.int32)
    w = wq * jnp.take(s, gid, axis=0) - jnp.take(sz, gid, axis=0)
    return w.astype(out_dtype)


# ---------------------------------------------------------------------------
# Native plane packing
# ---------------------------------------------------------------------------


def paired_plane_layout(bits: int) -> bool:
    """True when ``bits``' FIRST (low) plane is the 4-bit plane, which uses
    the PAIRED word layout (see :func:`_pack_plane_paired`): each 16-bit
    half of a word holds the 4-bit value of one of two adjacent K rows.
    The 4-bit plane of the multi-plane widths (5/6/7) pairs too."""
    return PLANE_DECOMP[bits][0] == 4


def paired_ok(bits: int, tile_k: int, group_size: int) -> bool:
    """Whether this (bits, tile_k, group_size) combination stores its 4-bit
    plane PAIRED.

    Pure function of QTensor static metadata (so it needs no extra field,
    checkpoint entry, or pytree aux change): a kernel chunk
    ``cs = min(tile_k/4, rows-per-scale-group, slot height of every other
    plane)`` must be a multiple of 16 so its word-row slice (``cs/2``) spans
    8 word rows — odd group sizes (not multiples of 16) fall back to the slot
    layout."""
    if not paired_plane_layout(bits):
        return False
    gt = max(1, tile_k // group_size)
    g_tile = tile_k // gt
    ph = tile_k // 4  # K rows per pair slot
    cs = min(ph, g_tile)
    for pb in PLANE_DECOMP[bits][1:]:  # 5/6/7-bit: the 1/2-bit slot planes
        cs = min(cs, tile_k // (32 // pb))
    if cs % 16 or ph % cs or g_tile % cs:
        return False
    return all(
        (tile_k // (32 // pb)) % cs == 0 for pb in PLANE_DECOMP[bits][1:]
    )


def _pack_plane(vals: jax.Array, pb: int, tile_k: int) -> jax.Array:
    """Pack per-plane values ``int[K, N]`` (< 2**pb) into the slot-strided word
    layout ``int32[K/(32/pb), N]`` (see module docstring)."""
    K, N = vals.shape
    ratio = 32 // pb
    if K % tile_k or tile_k % ratio:
        raise ValueError(f"K={K} and tile_k={tile_k} must be multiples of {ratio}")
    wt = tile_k // ratio
    v = vals.astype(jnp.uint32).reshape(K // tile_k, ratio, wt, N)
    words = v[:, 0]
    for j in range(1, ratio):
        words = words | (v[:, j] << np.uint32(pb * j))
    return words.reshape(K // ratio, N).astype(jnp.int32)


def _pack_plane_paired(vals: jax.Array, tile_k: int) -> jax.Array:
    """Pack 4-bit values ``int[K, N]`` into the PAIRED word layout
    ``int32[K/8, N]``: within a K-tile, local row ``k = j*(tile_k/4) + 2r + h``
    lives at bit ``4j + 16h`` of word-row ``r`` (j = pair slot 0..3,
    h = 16-bit half).  Half ``h`` of pair slot ``j`` over all word rows is
    then the K rows ``j*tile_k/4 + 2r + h``: the fused kernel multiplies it
    with the activations reordered to match (``qgemv_kernel.pair_order``)."""
    K, N = vals.shape
    if K % tile_k or tile_k % 8:
        raise ValueError(f"K={K} and tile_k={tile_k} must be multiples of 8")
    wt = tile_k // 8
    v = vals.astype(jnp.uint32).reshape(K // tile_k, 4, wt, 2, N)
    words = None
    for j in range(4):
        for h in (0, 1):
            part = v[:, j, :, h] << np.uint32(4 * j + 16 * h)
            words = part if words is None else words | part
    return words.reshape(K // 8, N).astype(jnp.int32)


def pack_planes(
    wq: jax.Array, bits: int, tile_k: int, paired: Optional[bool] = None
) -> Tuple[jax.Array, ...]:
    """Decompose integer values ``wq[K, N]`` into bit-planes and pack each.

    ``paired=None`` pairs whenever the width admits it; callers with a group
    size must pass :func:`paired_ok` (as :func:`make_qtensor` does) so odd
    group sizes keep the slot layout the kernels can chunk."""
    if paired is None:
        paired = paired_plane_layout(bits)
    planes = []
    shift = 0
    for pi, pb in enumerate(PLANE_DECOMP[bits]):
        pv = (wq >> shift) & ((1 << pb) - 1)
        if paired and pi == 0:  # the 4-bit plane (always first when present)
            planes.append(_pack_plane_paired(pv, tile_k))
        else:
            planes.append(_pack_plane(pv, pb, tile_k))
        shift += pb
    return tuple(planes)


def _unpack_plane_block(words: jax.Array, pb: int) -> jax.Array:
    """Unpack one K-tile of plane words ``(wt, n) int32`` → values ``(wt*ratio, n)``.

    This is the exact computation the Pallas kernels run per tile: ``ratio``
    shift/mask ops, one contiguous concatenate, no shuffles.
    """
    ratio = 32 // pb
    mask = (1 << pb) - 1
    parts = [(words >> (pb * j)) & mask for j in range(ratio)]
    return jnp.concatenate(parts, axis=0)


def _unpack_plane_block_paired(words: jax.Array) -> jax.Array:
    """Unpack one K-tile of PAIRED 4-bit words ``(tile_k/8, n)`` → values
    ``(tile_k, n)``: the jnp mirror of the kernels' bitcast decode."""
    wt, N = words.shape
    parts = []
    for j in range(4):
        lo = (words >> (4 * j)) & 15  # h=0 → local rows 2r
        hi = (words >> (4 * j + 16)) & 15  # h=1 → local rows 2r+1
        parts.append(jnp.stack([lo, hi], axis=1).reshape(2 * wt, N))
    return jnp.concatenate(parts, axis=0)


def unpack_planes_reference(
    planes: Sequence[jax.Array], bits: int, tile_k: int, K: int,
    paired: Optional[bool] = None,
) -> jax.Array:
    """jnp oracle: reconstruct integer values ``int32[K, N]`` from packed planes."""
    N = planes[0].shape[-1]
    if paired is None:
        paired = paired_plane_layout(bits)
    wq = jnp.zeros((K, N), jnp.int32)
    shift = 0
    for pi, (plane, pb) in enumerate(zip(planes, PLANE_DECOMP[bits])):
        ratio = 32 // pb
        tiles = plane.reshape(K // tile_k, tile_k // ratio, N)
        if paired and pi == 0:
            vals = jax.vmap(_unpack_plane_block_paired)(tiles)
        else:
            vals = jax.vmap(partial(_unpack_plane_block, pb=pb))(tiles)
        wq = wq | (vals.reshape(K, N) << shift)
        shift += pb
    return wq


# ---------------------------------------------------------------------------
# QTensor — the native quantized tensor (a pytree)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QTensor:
    """A quantized weight in the native plane layout.

    Logical value: ``dequant(qt)[k, n] = wq[k, n] * s[k, n] - sz[k, n]`` where
    ``wq`` is reconstructed from ``planes`` and ``s``/``sz`` come from the tiled
    scale arrays.  Scales are stored **per K-tile** as ``[K/tile_k, gt_pad, N]``
    with ``gt = max(1, tile_k/group_size)`` rows used per tile (padded to a
    multiple of 8); row ``r`` of tile ``t`` covers weight rows
    ``[t*tile_k + r*rows_per_group, ...)``.

    If ``perm`` is set (act-order), row ``k`` of the *stored* tensor corresponds to
    row ``perm[k]`` of the logical tensor: ``W_logical[perm[k], :] = W_stored[k, :]``
    — matmuls gather activations as ``a[..., perm]`` and dequant scatters rows back.
    """

    planes: Tuple[jax.Array, ...]  # int32[K/(32/pb), N] each, slot-strided
    scales: jax.Array  # [T, gt_pad, N] float
    scale_zeros: jax.Array  # [T, gt_pad, N] float, equals (z + bias) * s
    bits: int
    group_size: int
    tile_k: int
    K: int  # number of (padded) rows represented by `planes`
    K_logical: int  # rows before padding (== K unless padded)
    perm: Optional[jax.Array] = None  # int32[K_logical] act-order permutation
    N_logical: Optional[int] = None  # columns before lane padding (None = N)
    # Quantization width when stored wider than quantized (pad-to-pow2 storage;
    # see resolve_storage_bits).  None means values use the full `bits` range.
    value_bits: Optional[int] = None

    @property
    def N(self) -> int:
        return self.planes[0].shape[-1]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.K_logical, self.N_logical or self.N)

    @property
    def plane_bits(self) -> Tuple[int, ...]:
        return PLANE_DECOMP[self.bits]

    @property
    def groups_per_tile(self) -> int:
        """Scale rows actually used per K-tile (<= the padded row count)."""
        return max(1, self.tile_k // self.group_size)

    @property
    def paired(self) -> bool:
        """Whether ``planes`` use the PAIRED 4-bit layout (derived from the
        static metadata — see :func:`paired_ok`)."""
        return paired_ok(self.bits, self.tile_k, self.group_size)

    def bytes_packed(self) -> int:
        """HBM bytes a kernel must read per full pass (roofline numerator)."""
        n = sum(p.size * 4 for p in self.planes)
        n += self.scales.size * self.scales.dtype.itemsize
        n += self.scale_zeros.size * self.scale_zeros.dtype.itemsize
        return n


def tile_scales(scales: jax.Array, tile_k: int, group_size: int, K: int) -> jax.Array:
    """Reshape per-group scales ``[G, N]`` into the per-K-tile layout
    ``[K/tile_k, gt_pad, N]`` (gt_pad = round_up(max(1, tile_k/g), 8))."""
    G, N = scales.shape
    T = K // tile_k
    if tile_k % group_size == 0:
        gt = tile_k // group_size
        assert G == T * gt, (G, T, gt)
        out = scales.reshape(T, gt, N)
    else:
        assert group_size % tile_k == 0
        gt = 1
        idx = (jnp.arange(T) * tile_k) // group_size
        out = jnp.take(scales, idx, axis=0).reshape(T, 1, N)
    gt_pad = _round_up(gt, 8)
    if gt_pad != gt:
        out = jnp.pad(out, ((0, 0), (0, gt_pad - gt), (0, 0)))
    return out


def _qtensor_flatten(qt: QTensor):
    children = (qt.planes, qt.scales, qt.scale_zeros, qt.perm)
    aux = (
        qt.bits, qt.group_size, qt.tile_k, qt.K, qt.K_logical, qt.N_logical,
        qt.value_bits,
    )
    return children, aux


def _qtensor_unflatten(aux, children):
    planes, scales, scale_zeros, perm = children
    bits, group_size, tile_k, K, K_logical, N_logical, value_bits = aux
    return QTensor(
        tuple(planes), scales, scale_zeros, bits, group_size, tile_k, K,
        K_logical, perm, N_logical, value_bits,
    )


jax.tree_util.register_pytree_node(QTensor, _qtensor_flatten, _qtensor_unflatten)


def make_qtensor(
    wq: jax.Array,
    scales: jax.Array,
    zeros: jax.Array,
    bits: int,
    group_size: int,
    add_zero_bias: int = 0,
    tile_k: Optional[int] = None,
    perm: Optional[jax.Array] = None,
    scale_store_dtype=None,
    storage_bits=None,
) -> QTensor:
    """Build a QTensor from unpacked integer values + per-group scale/zero.

    ``scale_zeros`` is computed as ``round_to(scales.dtype, s*(z+bias))`` then stored
    in ``scale_store_dtype`` so fp16-checkpoint numerics survive exactly (mirrors the
    reference's half-precision ``-s*z`` operand, ``unpack_weight_2_to_7.cu:64,75``).
    ``None`` follows the scales dtype: fp16 in → ``FP16_BITS`` (bit-exact,
    half the f32 stream; see module constant), anything else → f32 (exact).

    ``storage_bits`` (None/"packed" | "auto" | int): plane width to store at —
    "auto" pads multi-plane widths (3/5/6/7) to the next power of two for the
    single-plane kernel's speed (see ``resolve_storage_bits``); the quantized
    values and scale/zero math are unchanged either way.
    """
    if scale_store_dtype is None:  # follow the source (see docstring)
        scale_store_dtype = (
            FP16_BITS if scales.dtype == jnp.float16 else jnp.float32
        )
    K_logical, N = wq.shape
    g = group_size
    value_bits = None
    sb = resolve_storage_bits(bits, storage_bits)
    if sb != bits:
        value_bits, bits = bits, sb
    tile_k = tile_k or default_tile_k(_round_up(K_logical, min_tile_k(bits)), g, bits)
    if not _tile_group_compatible(tile_k, g):
        raise ValueError(
            f"tile_k={tile_k} and group_size={g} must divide one another "
            "(tile boundaries must land on group boundaries)"
        )
    if tile_k < min_tile_k(bits) or tile_k % min_tile_k(bits):
        raise ValueError(
            f"tile_k={tile_k} must be a multiple of {min_tile_k(bits)} for bits={bits}"
        )
    K = _round_up(K_logical, tile_k)
    if K != K_logical:
        wq = jnp.pad(wq, ((0, K - K_logical), (0, 0)))
        gpad = _cdiv(K, g) - scales.shape[0]
        if gpad:
            scales = jnp.pad(scales, ((0, gpad), (0, 0)), constant_values=1)
            zeros = jnp.pad(zeros, ((0, gpad), (0, 0)))
    N_logical = None
    Np = _round_up(N, 128)  # whole 128-column kernel blocks
    if Np != N:
        N_logical = N
        wq = jnp.pad(wq, ((0, 0), (0, Np - N)))
        scales = jnp.pad(scales, ((0, 0), (0, Np - N)), constant_values=1)
        zeros = jnp.pad(zeros, ((0, 0), (0, Np - N)))
    z = zeros.astype(jnp.float32) + float(add_zero_bias)
    sz = (scales.astype(jnp.float32).astype(scales.dtype) * z.astype(scales.dtype)).astype(
        scales.dtype
    )
    return QTensor(
        planes=pack_planes(wq.astype(jnp.int32), bits, tile_k,
                           paired=paired_ok(bits, tile_k, g)),
        scales=encode_scale_store(
            tile_scales(scales.astype(jnp.float32), tile_k, g, K),
            scale_store_dtype,
        ),
        scale_zeros=encode_scale_store(
            tile_scales(sz.astype(jnp.float32), tile_k, g, K),
            scale_store_dtype,
        ),
        bits=bits,
        group_size=g,
        tile_k=tile_k,
        K=K,
        K_logical=K_logical,
        perm=perm,
        N_logical=N_logical,
        value_bits=value_bits,
    )


def _round_up(x: int, m: int) -> int:
    return _cdiv(x, m) * m


def from_gptq(
    qweight: jax.Array,
    scales: jax.Array,
    qzeros: jax.Array,
    bits: int,
    group_size: int,
    in_features: int,
    add_zero_bias: int = 0,
    g_idx: Optional[jax.Array] = None,
    tile_k: Optional[int] = None,
    scale_store_dtype=None,
    storage_bits=None,
    col_perm: Optional[jax.Array] = None,
    fold_perm: bool = False,
) -> QTensor:
    """Convert a GPTQ-format checkpoint tensor to the native plane layout.

    Act-order (``g_idx``) rows are sorted into contiguous groups here, at load time,
    so kernels stay gather-free (the exllama approach to the reference's
    ``VecQuant4MatMulKernel_G`` path, ``quant_cuda_kernel.cu:311-323``).

    ``scale_store_dtype=None`` follows the checkpoint: fp16 scales store as
    ``FP16_BITS`` (bit-exact, half the stream), anything else as f32 (exact).

    ``col_perm`` permutes the OUTPUT columns (N axis) — used to fold a
    downstream act-order layer's row sort into this layer's outputs so the
    downstream matmul needs no runtime activation gather (exact: a column
    permutation commutes with the elementwise ops between the layers).
    ``fold_perm=True`` says exactly that was done upstream for THIS tensor's
    ``g_idx``: rows are still sorted into contiguous groups, but no runtime
    perm is stored (the activation already arrives in sorted order).
    """
    if scale_store_dtype is None:
        scale_store_dtype = (
            FP16_BITS if scales.dtype == jnp.float16 else jnp.float32
        )
    K, N = in_features, scales.shape[1]
    wq = gptq_unpack_weight(qweight, bits, K)
    zeros = gptq_unpack_zeros(qzeros, bits, N)
    if col_perm is not None:
        wq = jnp.take(wq, col_perm, axis=1)
        scales = jnp.take(scales, col_perm, axis=1)
        zeros = jnp.take(zeros, col_perm, axis=1)
    perm = None
    if g_idx is not None:
        order = jnp.argsort(g_idx, stable=True).astype(jnp.int32)
        wq = jnp.take(wq, order, axis=0)
        perm = None if fold_perm else order
    return make_qtensor(
        wq, scales, zeros, bits, group_size, add_zero_bias,
        tile_k=tile_k, perm=perm, scale_store_dtype=scale_store_dtype,
        storage_bits=storage_bits,
    )


def make_row_sharded_qtensor(
    wq: jax.Array,
    scales: jax.Array,
    zeros: jax.Array,
    bits: int,
    group_size: int,
    row_shards: int,
    add_zero_bias: int = 0,
    tile_k: Optional[int] = None,
    scale_store_dtype=None,
    storage_bits=None,
    perm: Optional[jax.Array] = None,
) -> QTensor:
    """Pack ``wq[K, N]`` for **row-parallel** execution over ``row_shards`` devices.

    Real checkpoint shapes rarely let shard boundaries land on group boundaries
    (Llama-7B down-proj: K=11008, g=128, tp=8 → 1376 rows/shard = 10.75 groups), so
    each shard is repacked independently with a local group size
    ``g' = gcd(g, K/row_shards)`` and the global scales *duplicated exactly* onto
    the finer grid — numerics are unchanged, only scale storage grows.  Shards are
    padded to a common tile multiple individually.

    The result is one QTensor whose leaves carry a leading shard axis
    ``[row_shards, ...]`` (shard it with ``P(axis, ...)``); the static metadata
    describes ONE shard, so inside ``shard_map`` dropping the leading axis yields
    a self-consistent local QTensor (see ``parallel.tp.squeeze_row_shard``).

    ``perm`` (optional, ``[row_shards, K/row_shards]``): shard-LOCAL act-order
    permutations — ``wq`` rows must already be permuted accordingly (see
    ``ops.quantize.quantize_array(act_order=True, row_shards=...)``); each
    local matmul gathers its local activation slice through its own perm.
    """
    import math

    if scale_store_dtype is None:  # follow the checkpoint (see from_gptq)
        scale_store_dtype = (
            FP16_BITS if scales.dtype == jnp.float16 else jnp.float32
        )
    K, N = wq.shape
    if perm is not None and tuple(perm.shape) != (row_shards, K // row_shards):
        raise ValueError(
            f"perm shape {perm.shape} != ({row_shards}, {K // row_shards})"
        )
    if K % row_shards:
        raise ValueError(f"K={K} must divide into {row_shards} row shards")
    Ks = K // row_shards
    g_local = math.gcd(group_size, Ks)
    if g_local < 16:
        raise ValueError(
            f"shard-local group size gcd({group_size}, {Ks}) = {g_local} < 16"
        )
    sb = resolve_storage_bits(bits, storage_bits)
    tile = tile_k or default_tile_k(Ks, g_local, sb)
    shards = []
    row0 = np.arange(0, Ks, g_local)
    for i in range(row_shards):
        gidx = jnp.asarray((i * Ks + row0) // group_size, jnp.int32)
        shards.append(
            make_qtensor(
                wq[i * Ks : (i + 1) * Ks],
                jnp.take(scales, gidx, axis=0),
                jnp.take(zeros, gidx, axis=0),
                bits, g_local, add_zero_bias, tile_k=tile,
                scale_store_dtype=scale_store_dtype, storage_bits=sb,
            )
        )
    first = shards[0]
    return QTensor(
        planes=tuple(
            jnp.stack([s.planes[j] for s in shards]) for j in range(len(first.planes))
        ),
        scales=jnp.stack([s.scales for s in shards]),
        scale_zeros=jnp.stack([s.scale_zeros for s in shards]),
        bits=first.bits,
        group_size=g_local,
        tile_k=first.tile_k,
        K=first.K,
        K_logical=first.K_logical,
        perm=perm,
        N_logical=first.N_logical,
        value_bits=first.value_bits,
    )


def is_row_sharded(qt: QTensor) -> bool:
    return qt.planes[0].ndim == 3


def concat_qtensors(qts: Sequence[QTensor], order: Optional[np.ndarray] = None) -> QTensor:
    """Concatenate QTensors along N (shared K): fuses e.g. q/k/v projections
    into one matmul.  All static metadata must match; act-order tensors can't
    fuse (each carries its own row permutation).  ``order`` optionally permutes
    the fused columns (e.g. per-shard interleaving for tensor parallelism).
    """
    first = qts[0]
    for qt in qts[1:]:
        same = (
            qt.bits == first.bits and qt.group_size == first.group_size
            and qt.tile_k == first.tile_k and qt.K == first.K
            and qt.K_logical == first.K_logical
        )
        if not same:
            raise ValueError("concat_qtensors: mismatched quantization metadata")
        if qt.perm is not None or first.perm is not None:
            raise ValueError("concat_qtensors: act-order tensors cannot be fused")

    def cat(get):
        parts = []
        for qt in qts:
            x = get(qt)
            parts.append(x if qt.N_logical is None else x[..., : qt.N_logical])
        out = jnp.concatenate(parts, axis=-1)
        if order is not None:
            out = jnp.take(out, jnp.asarray(order), axis=-1)
        return out

    planes = tuple(cat(lambda q, i=i: q.planes[i]) for i in range(len(first.planes)))
    scales = cat(lambda q: q.scales)
    scale_zeros = cat(lambda q: q.scale_zeros)
    N = planes[0].shape[-1]
    N_logical = None
    Np = _round_up(N, 128)
    if Np != N:
        N_logical = N
        pad = [(0, 0)] * (planes[0].ndim - 1) + [(0, Np - N)]
        planes = tuple(jnp.pad(p, pad) for p in planes)
        scales = jnp.pad(scales, pad, constant_values=1)
        scale_zeros = jnp.pad(scale_zeros, pad)
    return QTensor(
        planes=planes, scales=scales, scale_zeros=scale_zeros,
        bits=first.bits, group_size=first.group_size, tile_k=first.tile_k,
        K=first.K, K_logical=first.K_logical, N_logical=N_logical,
    )


def _expand_tiled_scales(ts: jax.Array, qt: QTensor) -> jax.Array:
    """Tiled scales ``[T, gt_pad, N]`` → per-row ``[K, N]`` (oracle use only)."""
    gt = qt.groups_per_tile
    rows_per = qt.tile_k // gt
    s = decode_scale_store(ts[:, :gt, :])  # (T, gt, N)
    s = jnp.repeat(s.reshape(-1, qt.N), rows_per, axis=0)
    return s  # (K, N)


def dequant_qtensor_stored(qt: QTensor, out_dtype=jnp.float32) -> jax.Array:
    """Dense ``(K, N)`` weight in STORED row order, padding included — what a
    matmul against activations gathered through ``qt.perm`` needs."""
    wq = unpack_planes_reference(
        qt.planes, qt.bits, qt.tile_k, qt.K, paired=qt.paired
    ).astype(jnp.float32)
    w = wq * _expand_tiled_scales(qt.scales, qt) - _expand_tiled_scales(qt.scale_zeros, qt)
    return w.astype(out_dtype)


def dequant_qtensor_reference(qt: QTensor, out_dtype=jnp.bfloat16) -> jax.Array:
    """jnp oracle for dequantizing a QTensor (logical row/col order, unpadded)."""
    w = dequant_qtensor_stored(qt)
    w = w[: qt.K_logical, : qt.shape[1]]
    if qt.perm is not None:
        w = jnp.zeros_like(w).at[qt.perm].set(w)
    return w.astype(out_dtype)
