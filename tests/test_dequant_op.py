"""Dequant op tests: the plain jnp dequant vs the C++ fp16 oracle and the jnp
GPTQ oracle, at the reference's tolerance (DQ abs 1e-3,
``unpack_weight_2_to_7.cu:570``)."""

import jax.numpy as jnp
import numpy as np
import pytest

import xbitops as xb
from xbitops import formats
from xbitops.ops.dequant import dequant_qtensor
from xbitops.utils import cpp_oracle

BITS = [1, 2, 3, 4, 5, 6, 7, 8]


def _gptq_case(bits, K=256, N=128, g=64, seed=0):
    rng = np.random.default_rng(seed + bits)
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.05
    wq, scales, zeros = formats.quantize(w, bits, g)
    s16 = scales.astype(np.float16)
    qweight, _, qzeros = formats.gptq_pack(wq, s16, zeros, bits)
    oracle = cpp_oracle.dequant_f16(qweight, s16, qzeros, bits, g, K)
    return (jnp.asarray(qweight), jnp.asarray(s16), jnp.asarray(qzeros), g,
            oracle.astype(np.float32))


@pytest.mark.parametrize("bits", BITS)
def test_kernel_matches_oracle_exact(bits):
    qweight, s16, qzeros, g, oracle = _gptq_case(bits)
    got = np.asarray(
        xb.dequant(qweight, s16, qzeros, g, bits, 256, out_dtype=jnp.float32))
    np.testing.assert_allclose(got, oracle, atol=1e-3, rtol=0)


@pytest.mark.parametrize("out_dtype", [jnp.bfloat16, jnp.float16])
def test_kernel_low_precision_outputs(out_dtype):
    qweight, s16, qzeros, g, oracle = _gptq_case(4)
    got = np.asarray(
        xb.dequant(qweight, s16, qzeros, g, 4, 256, out_dtype=out_dtype)
    ).astype(np.float32)
    # one rounding to the output dtype on top of the fp16 oracle's
    np.testing.assert_allclose(got, oracle, atol=1e-3, rtol=1e-2)


def test_group_larger_than_tile():
    # group_size 256 > tile_k 64: the (1, tn) scale-block path.
    K, N, g, bits = 512, 128, 256, 4
    rng = np.random.default_rng(1)
    w = rng.standard_normal((K, N), dtype=np.float32)
    qt = xb.quantize_array(jnp.asarray(w), bits, g, tile_k=64)
    got = np.asarray(dequant_qtensor(qt, out_dtype=jnp.float32))
    ref = np.asarray(formats.dequant_qtensor_reference(qt, out_dtype=jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bits", [2, 4, 5])
def test_public_dequant_from_gptq(bits):
    # Full drop-in path: GPTQ arrays in, dense weight out, vs the jnp GPTQ oracle.
    K, N, g = 256, 128, 64
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.05
    wq, scales, zeros = formats.quantize(w, bits, g)
    scales16 = scales.astype(np.float16)
    qweight, _, qzeros = formats.gptq_pack(wq, scales, zeros, bits)
    got = np.asarray(
        xb.dequant(
            jnp.asarray(qweight), jnp.asarray(scales16), jnp.asarray(qzeros),
            g, bits, K, out_dtype=jnp.float32,
        )
    )
    ref = np.asarray(
        formats.dequant_reference(
            jnp.asarray(qweight), jnp.asarray(scales16), jnp.asarray(qzeros),
            g, bits, K, out_dtype=jnp.float32,
        )
    )
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_public_dequant_add_zero_bias():
    # add_zero_bias=1: old-GPTQ zero-1 convention (unpack_weight_2_to_7.cu:60).
    K, N, g, bits = 128, 128, 32, 4
    rng = np.random.default_rng(9)
    wq = rng.integers(0, 16, (K, N)).astype(np.uint8)
    zeros = rng.integers(0, 15, (K // g, N)).astype(np.uint8)
    scales = (rng.random((K // g, N), dtype=np.float32) + 0.5).astype(np.float16)
    qweight, _, qzeros = formats.gptq_pack(wq, scales, zeros, bits)
    got = np.asarray(
        xb.dequant(
            jnp.asarray(qweight), jnp.asarray(scales), jnp.asarray(qzeros),
            g, bits, K, add_zero_bias=1, out_dtype=jnp.float32,
        )
    )
    gid = np.arange(K) // g
    sz = (scales * (zeros + 1).astype(np.float16)).astype(np.float16)
    expect = wq.astype(np.float32) * scales[gid].astype(np.float32) - sz[gid].astype(
        np.float32
    )
    np.testing.assert_allclose(got, expect, atol=1e-3, rtol=0)


def test_validation_errors():
    q = jnp.zeros((32, 128), jnp.int32)
    s = jnp.ones((4, 128), jnp.float16)
    z = jnp.zeros((4, 16), jnp.int32)
    with pytest.raises(ValueError):
        xb.dequant(q, s, z, 8, 4, 256)  # group_size < 16
    with pytest.raises(ValueError):
        xb.dequant(q, s, z, 64, 9, 256)  # bits out of range
    with pytest.raises(ValueError):
        xb.dequant(q, s, z, 64, 4, 512)  # qweight rows mismatch
