"""Format layer tests: GPTQ interchange pack/unpack, plane packing, QTensor.

The round-trip property (quantize → gptq_pack → unpack/dequant) plus
hand-computed word values pin down bit-exact layout compatibility with the
reference (``unpack_weight_2_to_7.cu:45-120``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from xbitops import formats

BITS = [1, 2, 3, 4, 5, 6, 7, 8]


def _rand_case(K=256, N=128, bits=4, group_size=64, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.1
    wq, scales, zeros = formats.quantize(w, bits, group_size)
    return w, wq, scales, zeros


@pytest.mark.parametrize("bits", BITS)
def test_gptq_pack_unpack_roundtrip(bits):
    K, N, g = 256, 128, 64
    _, wq, scales, zeros = _rand_case(bits=bits, K=K, N=N, group_size=g)
    qweight, s16, qzeros = formats.gptq_pack(wq, scales, zeros, bits)
    assert qweight.shape == ((K * bits + 31) // 32, N)
    assert qzeros.shape == (K // g, (N * bits + 31) // 32)
    wq2 = np.asarray(formats.gptq_unpack_weight(jnp.asarray(qweight), bits, K))
    z2 = np.asarray(formats.gptq_unpack_zeros(jnp.asarray(qzeros), bits, N))
    np.testing.assert_array_equal(wq2, wq)
    np.testing.assert_array_equal(z2, zeros)


def test_gptq_pack_hand_values_4bit():
    # 4-bit: word w holds rows 8w..8w+7, low nibble first (gemv_w4a16_pt.cu:90-94).
    K, N = 8, 1
    wq = np.arange(1, 9, dtype=np.uint8).reshape(K, N)
    qweight = formats._pack_bits_np(wq, 4, axis=0)
    assert qweight.shape == (1, 1)
    assert np.uint32(qweight[0, 0]) == np.uint32(0x87654321)


def test_gptq_pack_hand_values_3bit_cross_word():
    # 3-bit: row 10 straddles the word boundary (bits 30..32).
    K = 32
    wq = np.zeros((K, 1), np.uint8)
    wq[10, 0] = 0b111  # bitpos 30: low 2 bits in word0 (bits 30-31), high 1 in word1
    qweight = formats._pack_bits_np(wq, 3, axis=0).view(np.uint32)
    assert qweight[0, 0] == np.uint32(0b11) << 30
    assert qweight[1, 0] == np.uint32(0b1)
    wq2 = np.asarray(formats.gptq_unpack_weight(jnp.asarray(qweight.view(np.int32)), 3, K))
    np.testing.assert_array_equal(wq2[:, 0], wq[:, 0])


@pytest.mark.parametrize("bits", BITS)
def test_plane_pack_unpack_roundtrip(bits):
    K, N, tile_k = 256, 128, 64
    rng = np.random.default_rng(bits)
    wq = rng.integers(0, 1 << bits, (K, N), dtype=np.uint8)
    planes = formats.pack_planes(jnp.asarray(wq.astype(np.int32)), bits, tile_k)
    assert len(planes) == len(formats.PLANE_DECOMP[bits])
    total_bits = sum(p.size * 32 for p in planes)
    assert total_bits == K * N * bits  # exact storage, no padding overhead
    wq2 = np.asarray(formats.unpack_planes_reference(planes, bits, tile_k, K))
    np.testing.assert_array_equal(wq2, wq)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 8])
def test_dequant_reference_matches_direct(bits):
    K, N, g = 256, 128, 64
    w, wq, scales, zeros = _rand_case(bits=bits, K=K, N=N, group_size=g)
    scales16 = scales.astype(np.float16)
    qweight, _, qzeros = formats.gptq_pack(wq, scales, zeros, bits)
    got = np.asarray(
        formats.dequant_reference(
            jnp.asarray(qweight), jnp.asarray(scales16), jnp.asarray(qzeros),
            g, bits, K, out_dtype=jnp.float32,
        )
    )
    gid = np.arange(K) // g
    expect = (wq.astype(np.float32) - zeros[gid].astype(np.float32)) * scales16[
        gid
    ].astype(np.float32)
    # fp16 scale*zero rounding: tolerance = the reference's own DQ tolerance (1e-3,
    # unpack_weight_2_to_7.cu:570)
    np.testing.assert_allclose(got, expect, atol=1e-3)
    # and dequant must reconstruct the original float weight to quant error
    step = scales[gid]
    np.testing.assert_array_less(np.abs(got - w), step * 0.51 + 1e-3)


@pytest.mark.parametrize("bits", BITS)
def test_qtensor_from_gptq_parity(bits):
    K, N, g = 256, 128, 64
    _, wq, scales, zeros = _rand_case(bits=bits, K=K, N=N, group_size=g)
    scales16 = scales.astype(np.float16)
    qweight, _, qzeros = formats.gptq_pack(wq, scales, zeros, bits)
    qt = formats.from_gptq(
        jnp.asarray(qweight), jnp.asarray(scales16), jnp.asarray(qzeros), bits, g, K
    )
    got = np.asarray(formats.dequant_qtensor_reference(qt, out_dtype=jnp.float32))
    ref = np.asarray(
        formats.dequant_reference(
            jnp.asarray(qweight), jnp.asarray(scales16), jnp.asarray(qzeros),
            g, bits, K, out_dtype=jnp.float32,
        )
    )
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_qtensor_padding():
    # K=200 is not a multiple of any tile: gets padded, logical shape preserved.
    K, N, g, bits = 200, 128, 50, 4
    rng = np.random.default_rng(7)
    w = rng.standard_normal((K, N), dtype=np.float32)
    wq, scales, zeros = formats.quantize(w, bits, g)
    qt = formats.make_qtensor(
        jnp.asarray(wq.astype(np.int32)), jnp.asarray(scales), jnp.asarray(zeros),
        bits, g,  # odd group size: default tile_k falls back to lcm(50, 32) = 800
    )
    assert qt.shape == (K, N)
    assert qt.K % qt.tile_k == 0 and qt.K >= K
    got = np.asarray(formats.dequant_qtensor_reference(qt, out_dtype=jnp.float32))
    assert got.shape == (K, N)
    gid = np.arange(K) // g
    expect = (wq.astype(np.float32) - zeros[gid]) * scales[gid]
    np.testing.assert_allclose(got, expect, atol=1e-5, rtol=1e-5)


def test_act_order_from_gptq():
    # g_idx shuffled: from_gptq sorts rows; dequant restores logical order.
    K, N, g, bits = 128, 128, 32, 4
    rng = np.random.default_rng(3)
    w = rng.standard_normal((K, N), dtype=np.float32)
    perm = rng.permutation(K)
    # simulate act-order: quantize rows in permuted order, g_idx maps row->group
    wq_s, scales, zeros = formats.quantize(w[perm], bits, g)
    g_idx = np.empty(K, np.int32)
    g_idx[perm] = np.arange(K) // g
    wq = np.empty_like(wq_s)
    wq[perm] = wq_s  # store back in logical row order, as GPTQ checkpoints do
    qweight, _, qzeros = formats.gptq_pack(wq, scales, zeros, bits)
    qt = formats.from_gptq(
        jnp.asarray(qweight), jnp.asarray(scales), jnp.asarray(qzeros),
        bits, g, K, g_idx=jnp.asarray(g_idx),
    )
    assert qt.perm is not None
    got = np.asarray(formats.dequant_qtensor_reference(qt, out_dtype=jnp.float32))
    gid = np.arange(K) // g
    expect_sorted = (wq_s.astype(np.float32) - zeros[gid]) * scales[gid]
    expect = np.empty_like(expect_sorted)
    expect[perm] = expect_sorted
    np.testing.assert_allclose(got, expect, atol=1e-5, rtol=1e-5)


def test_bytes_packed():
    qt = formats.make_qtensor(
        jnp.zeros((256, 128), jnp.int32), jnp.ones((4, 128)), jnp.zeros((4, 128), jnp.int32),
        bits=5, group_size=64,
    )
    assert qt.tile_k == 256  # 1-bit plane needs >= 8 word rows per tile
    # planes store exactly bits/weight; scales are tiled (T=1, gt padded to 8,
    # N); f32 source scales store f32 (4 B), fp16 sources store fp16 BITS (2 B)
    assert qt.bytes_packed() == 256 * 128 * 5 // 8 + 2 * 8 * 128 * 4
    qt16 = formats.make_qtensor(
        jnp.zeros((256, 128), jnp.int32), jnp.ones((4, 128), jnp.float16),
        jnp.zeros((4, 128), jnp.int32), bits=5, group_size=64,
    )
    assert qt16.scales.dtype == jnp.int16  # FP16_BITS storage
    assert qt16.bytes_packed() == 256 * 128 * 5 // 8 + 2 * 8 * 128 * 2


def test_min_tile_k_enforced():
    with pytest.raises(ValueError):
        formats.make_qtensor(
            jnp.zeros((256, 128), jnp.int32), jnp.ones((4, 128)),
            jnp.zeros((4, 128), jnp.int32), bits=5, group_size=64, tile_k=64,
        )


@pytest.mark.parametrize("bits", [3, 5, 6, 7])
def test_storage_bits_pow2_padding(bits):
    """Pad-to-pow2 storage: same values/scales in the next power-of-two's
    planes — dequant identical, kernels run the single/fewer-plane fast path.
    ("auto" pads only the widths measured slower than padded storage; an
    explicit int forces padding for the rest.)"""
    import xbitops as xb

    rng = np.random.default_rng(bits)
    w = (rng.standard_normal((256, 128)) * 0.1).astype(np.float32)
    qt_p = xb.quantize_array(jnp.asarray(w), bits, 64, storage_bits="packed")
    auto = xb.quantize_array(jnp.asarray(w), bits, 64, storage_bits="auto")
    if bits in formats.AUTO_PAD_WIDTHS:
        assert auto.bits == formats.POW2_STORAGE[bits] and auto.value_bits == bits
        qt_a = auto
    else:
        assert auto.bits == bits and auto.value_bits is None  # packed is faster
        qt_a = xb.quantize_array(
            jnp.asarray(w), bits, 64, storage_bits=formats.POW2_STORAGE[bits]
        )
        assert qt_a.bits == formats.POW2_STORAGE[bits] and qt_a.value_bits == bits
    assert qt_p.bits == bits and qt_p.value_bits is None
    wp = np.asarray(formats.dequant_qtensor_reference(qt_p, out_dtype=jnp.float32))
    wa = np.asarray(formats.dequant_qtensor_reference(qt_a, out_dtype=jnp.float32))
    np.testing.assert_array_equal(wp, wa)
    a = (rng.standard_normal((4, 256)) * 0.5).astype(np.float32)
    gp = np.asarray(xb.qmatmul(jnp.asarray(a), qt_p, out_dtype=jnp.float32, precise=True))
    ga = np.asarray(xb.qmatmul(jnp.asarray(a), qt_a, out_dtype=jnp.float32, precise=True))
    np.testing.assert_allclose(gp, ga, rtol=1e-5, atol=3e-4)


def test_storage_bits_roundtrip_checkpoint(tmp_path):
    """value_bits survives save_packed/load_packed."""
    import xbitops as xb
    from xbitops.io import load_packed, save_packed

    w = jnp.asarray(np.random.default_rng(0).standard_normal((256, 128)) * 0.1,
                    jnp.float32)
    qt = xb.quantize_array(w, 3, 64, storage_bits="auto")
    save_packed({"w": qt}, str(tmp_path / "ck"))
    back = load_packed(str(tmp_path / "ck"))["w"]
    assert back.bits == 4 and back.value_bits == 3
    np.testing.assert_array_equal(
        np.asarray(formats.dequant_qtensor_reference(qt, out_dtype=jnp.float32)),
        np.asarray(formats.dequant_qtensor_reference(back, out_dtype=jnp.float32)),
    )
