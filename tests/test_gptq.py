"""GPTQ quantizer tests: degenerates to RTN on uncorrelated inputs, beats RTN
on correlated inputs (the whole point of error compensation), act-order path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import xbitops as xb
from xbitops import formats
from xbitops.ops.gptq import gptq_quantize_array, gptq_quantize_weight, hessian_from_inputs

K, N, BITS, GROUP = 256, 128, 4, 128


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    # correlated calibration inputs: mix of shared factors + noise
    factors = rng.standard_normal((2048, 16)).astype(np.float32)
    mix = rng.standard_normal((16, K)).astype(np.float32)
    x = factors @ mix + 0.3 * rng.standard_normal((2048, K)).astype(np.float32)
    return jnp.asarray(w), jnp.asarray(x)


def _recon_err(x, w, wdq):
    d = np.asarray(x @ (w - wdq), np.float64)
    return float(np.sqrt((d ** 2).mean()))


def test_gptq_identity_hessian_is_rtn(setup):
    """With H = I there is nothing to compensate: GPTQ == plain RTN."""
    w, _ = setup
    H = jnp.eye(K)
    wq, scales, zeros, perm = gptq_quantize_weight(w, H, BITS, GROUP)
    assert perm is None
    wq_rtn, s_rtn, z_rtn = formats.quantize(np.asarray(w), BITS, GROUP)
    np.testing.assert_array_equal(np.asarray(wq), wq_rtn.astype(np.int32))
    np.testing.assert_allclose(np.asarray(scales), s_rtn, rtol=1e-5)


def test_gptq_beats_rtn_on_correlated_inputs(setup):
    w, x = setup
    H = hessian_from_inputs(x)
    qt_gptq = gptq_quantize_array(w, H, BITS, GROUP)
    qt_rtn = xb.quantize_array(w, BITS, GROUP)
    wdq_gptq = np.asarray(formats.dequant_qtensor_reference(qt_gptq, jnp.float32))
    wdq_rtn = np.asarray(formats.dequant_qtensor_reference(qt_rtn, jnp.float32))
    x_np, w_np = np.asarray(x), np.asarray(w)
    e_gptq = _recon_err(x_np, w_np, wdq_gptq)
    e_rtn = _recon_err(x_np, w_np, wdq_rtn)
    # error compensation must reduce activation-space reconstruction error
    assert e_gptq < 0.9 * e_rtn, (e_gptq, e_rtn)


def test_gptq_act_order(setup):
    w, x = setup
    H = hessian_from_inputs(x)
    qt = gptq_quantize_array(w, H, BITS, GROUP, act_order=True)
    assert qt.perm is not None
    wdq = np.asarray(formats.dequant_qtensor_reference(qt, jnp.float32))
    e_ao = _recon_err(np.asarray(x), np.asarray(w), wdq)
    qt_plain = gptq_quantize_array(w, H, BITS, GROUP)
    wdq_p = np.asarray(formats.dequant_qtensor_reference(qt_plain, jnp.float32))
    e_plain = _recon_err(np.asarray(x), np.asarray(w), wdq_p)
    # act-order should help (or at worst be comparable) on correlated data
    assert e_ao < 1.05 * e_plain, (e_ao, e_plain)
    # and the packed tensor matmuls correctly (perm gathers activations)
    a = np.asarray(x[:4])
    got = np.asarray(xb.qmatmul(jnp.asarray(a), qt, out_dtype=jnp.float32, precise=True))
    np.testing.assert_allclose(got, a @ wdq, rtol=1e-4, atol=1e-3)


def test_gptq_model_driver():
    """Layer-by-layer GPTQ of a tiny dense model: runs, decodes finite, and
    perplexity on the calibration stream is no worse than RTN quantization."""
    from xbitops.models import llama
    from xbitops.ops.gptq import quantize_model_gptq
    from xbitops.utils.evaluate import perplexity

    cfg = llama.LlamaConfig.tiny()
    dense = llama.init_params(jax.random.PRNGKey(0), cfg, bits=None)
    calib = jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0, cfg.vocab_size)

    gptq_params = quantize_model_gptq(dense, cfg, calib, bits=4, group_size=32)
    assert isinstance(gptq_params["layers"][0]["wqkv"], formats.QTensor)

    def rtn(params):
        def qz(w):
            return xb.quantize_array(jnp.asarray(w, jnp.float32), 4, 32)
        layers = []
        for layer in params["layers"]:
            nl = dict(layer)
            for key in ("wqkv", "w_gateup", "wo", "w_down"):
                nl[key] = qz(layer[key])
            layers.append(nl)
        return dict(params, layers=layers, lm_head=qz(params["lm_head"]))

    p_dense = perplexity(dense, cfg, calib)
    p_gptq = perplexity(gptq_params, cfg, calib)
    p_rtn = perplexity(rtn(dense), cfg, calib)
    # gptq must not be worse than rtn (small slack for noise), both near dense
    assert np.log(p_gptq) <= np.log(p_rtn) + 0.02, (p_gptq, p_rtn)
    assert abs(np.log(p_gptq) - np.log(p_dense)) < 0.2, (p_gptq, p_dense)
