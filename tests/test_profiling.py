"""Roofline accounting tests."""

import jax
import jax.numpy as jnp

from xbitops.models import llama
from xbitops.utils import synth
import pytest

from xbitops.utils.profiling import (
    decode_roofline, device_peaks, kv_step_bytes, model_weight_bytes,
)

CFG = llama.LlamaConfig.tiny()


def test_weight_bytes_counts_packed_and_dense():
    params = synth.random_llama_params(jax.random.PRNGKey(0), CFG, bits=4, group_size=32)
    wb = model_weight_bytes(params)
    # at least the pure packed planes of every projection, but not the embed
    plane_bytes = 0
    for layer in params["layers"]:
        for key in ("wqkv", "w_gateup", "wo", "w_down"):
            plane_bytes += sum(p.size * 4 for p in layer[key].planes)
    assert wb >= plane_bytes
    embed_bytes = params["embed"].size * params["embed"].dtype.itemsize
    total_naive = sum(
        x.size * x.dtype.itemsize for x in jax.tree.leaves(params)
    )
    assert wb <= total_naive - embed_bytes + 1


def test_roofline_report():
    params = synth.random_llama_params(jax.random.PRNGKey(0), CFG, bits=4, group_size=32)
    r = decode_roofline(params, CFG, batch=2, mean_len=16,
                        device_kind="NVIDIA H100 80GB HBM3", measured_ms=1.0)
    assert r.cache_bytes == kv_step_bytes(CFG, 2, 16)
    assert 0 < r.bound_ms < 1.0
    assert 0 < r.efficiency < 1.0
    assert "roofline" in str(r)


def test_device_peaks_unknown_kind_raises():
    assert device_peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError):
        device_peaks("cpu")
