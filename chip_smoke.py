"""Prove that the 4-bit Llama serving path runs compiled on one GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --chips 4  # four cards: tensor-parallel engine only

Phases (one card), all in this one process:

1. device — JAX's first device is a GPU; the card's name and power limit;
2. kernel parity at real widths — the fused matmul, the dequant op, decode
   and chunked-prefill attention against the plain references;
3. engine at full width — Llama-2-7B, 32 layers, 4-bit g128 copy-model
   weights (``synth.copy_llama_params``: greedy decode follows the token
   cycle 0..7), ``Engine.generate`` with a bf16 cache (S=256) and with the
   int8 cache the automatic choice takes at S=2048; tokens must follow the
   cycle and first-step logits must match the plain reference forward;
4. server — two completions over HTTP from ``ServingEndpoint``;
5. compiled — the decode step's optimized HLO holds each kernel's GPU custom
   call and no interpreter.

``--chips 4``: a tensor-parallel (TP=4) Engine of Llama-3-8B over a
("model",) mesh of four cards against the same model on one card; tokens
must match exactly and logits within a bound.

The last line of standard output is one JSON object naming the device; any
failure exits non-zero before it.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

HI = jax.lax.Precision.HIGHEST
PERIOD = 8  # the copy-model's token cycle

# Tolerances, each with its reason:
# - fused matmul, precise path: f32 operands and IEEE f32 dots; the
#   reference's own f32-accumulation gate (gemv_w4a16_c32.cu:421-422).
TOL_QMM_PRECISE = 3e-4
# - bf16 path, relative to the largest |output|: the reference is computed on
#   the same bf16-rounded activations; the kernel keeps integer weights exact,
#   the plain path (M > KERNEL_MAX_M) rounds each dequantized weight to bf16.
TOL_QMM_BF16_REL = 1e-2
# - dequant vs the fp16 C++ oracle: the reference's DQ gate
#   (unpack_weight_2_to_7.cu:570).
TOL_DEQUANT = 1e-3
# - attention, absolute on outputs of unit-scale values: bf16 probabilities
#   and values in the p.v product (bf16 cache); the int8 cache's reference
#   attends the same dequantized values, so the same bound holds.
TOL_ATT_BF16 = 2e-2
TOL_ATT_INT8 = 2e-2
# - engine first-step logits, relative to the largest |logit|: activations
#   round to bf16 between layers on the kernel path, the reference keeps f32
#   dot operands.
TOL_LOGITS_REL = 3e-2
# - TP=4 vs one card, relative to the largest |logit|: each card's partial
#   sum of a row-parallel layer rounds to bf16 before the all-reduce, and
#   the difference grows through 32 layers of bf16 activations, as the
#   kernel-vs-reference difference does (TOL_LOGITS_REL).
TOL_TP_REL = 3e-2


def log(*a):
    print(*a, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# phase 2: kernel parity
# --------------------------------------------------------------------------


def parity_qmatmul():
    import xbitops as xb
    from xbitops import formats
    from xbitops.utils import synth

    key = jax.random.PRNGKey(0)
    # 4-bit (paired plane) at every shape; the multi-plane widths 3 and 5
    # and the 8-bit plane at the square shape
    cases = [(K, N, 4) for K, N in ((4096, 4096), (4096, 11008), (11008, 4096))]
    cases += [(4096, 4096, bits) for bits in (3, 5, 8)]
    for K, N, bits in cases:
        qt = synth.random_qtensor(jax.random.fold_in(key, 10 * bits + K % 7),
                                  K, N, bits, 128)
        wd = formats.dequant_qtensor_reference(qt, out_dtype=jnp.float32)
        for M in (1, 8, 32, 512):
            a = jax.random.normal(jax.random.fold_in(key, M), (M, K), jnp.float32)
            e_p, e_b = _qmm_errors(xb, a, qt, wd)
            log(f"qmatmul K={K} N={N} bits={bits} M={M}: precise abs "
                f"{e_p:.2e} (<= {TOL_QMM_PRECISE}), bf16 rel {e_b:.2e} "
                f"(<= {TOL_QMM_BF16_REL})")
            check(e_p <= TOL_QMM_PRECISE and e_b <= TOL_QMM_BF16_REL,
                  f"qmatmul parity K={K} N={N} bits={bits} M={M}")
    # act-order: activations gather through a row permutation
    qt = synth.random_qtensor(jax.random.fold_in(key, 1), 4096, 4096, 4, 128)
    qt = dataclasses.replace(qt, perm=jax.random.permutation(key, 4096).astype(jnp.int32))
    wd = formats.dequant_qtensor_reference(qt, out_dtype=jnp.float32)
    a = jax.random.normal(key, (8, 4096), jnp.float32)
    e_p, e_b = _qmm_errors(xb, a, qt, wd)
    log(f"qmatmul act-order 4096x4096 M=8: precise abs {e_p:.2e}, bf16 rel {e_b:.2e}")
    check(e_p <= TOL_QMM_PRECISE and e_b <= TOL_QMM_BF16_REL, "act-order parity")
    # stacked layers: the kernel reads layer `layer` of a [L, ...] stack
    qts = [synth.random_qtensor(jax.random.fold_in(key, 100 + i), 4096, 11008, 4, 128)
           for i in range(3)]
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *qts)
    for li in range(3):
        wd = formats.dequant_qtensor_reference(qts[li], out_dtype=jnp.float32)
        ref = jnp.dot(a, wd, precision=HI)
        got = xb.qmatmul(a, stacked, out_dtype=jnp.float32, precise=True,
                         layer=jnp.int32(li))
        e = float(jnp.abs(got - ref).max())
        log(f"qmatmul stacked layer={li} 4096x11008 M=8: precise abs {e:.2e}")
        check(e <= TOL_QMM_PRECISE, "stacked parity")


def _qmm_errors(xb, a, qt, wd):
    ref = jnp.dot(a, wd, precision=HI)
    got = xb.qmatmul(a, qt, out_dtype=jnp.float32, precise=True)
    e_p = float(jnp.abs(got - ref).max())
    ab = a.astype(jnp.bfloat16)
    refb = jnp.dot(ab.astype(jnp.float32), wd, precision=HI)
    gotb = xb.qmatmul(ab, qt, out_dtype=jnp.float32)
    e_b = float(jnp.abs(gotb - refb).max() / jnp.abs(refb).max())
    return e_p, e_b


def parity_dequant():
    import xbitops as xb
    from xbitops import formats
    from xbitops.utils import cpp_oracle

    K, N, g = 4096, 12288, 128
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    for bits in (2, 4, 8):
        wq, scales, zeros = formats.quantize(w, bits, g)
        s16 = scales.astype(np.float16)
        qweight, _, qzeros = formats.gptq_pack(wq, s16, zeros, bits)
        want = cpp_oracle.dequant_f16(qweight, s16, qzeros, bits, g, K)
        got = xb.dequant(jnp.asarray(qweight), jnp.asarray(s16),
                         jnp.asarray(qzeros), g, bits, K)
        e = float(np.abs(np.asarray(got, np.float32) - want.astype(np.float32)).max())
        log(f"dequant {K}x{N} bits={bits}: abs {e:.2e} (<= {TOL_DEQUANT}) vs C++ fp16 oracle")
        check(e <= TOL_DEQUANT, f"dequant bits={bits}")


def hmT(x):
    """[.., S, Hkv, D] row-major -> head-major [.., Hkv, S, D]."""
    return jnp.swapaxes(x, -3, -2)


def ref_att(q, k, v, lengths, window=None):
    """f32 masked-softmax decode attention over row-major k/v [B, S, Hkv, D]
    (the reference of tests/test_decode_attention.py)."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    kk = jnp.repeat(k, rep, axis=2).astype(jnp.float32)
    vv = jnp.repeat(v, rep, axis=2).astype(jnp.float32)
    logits = jnp.einsum("bhd,bshd->bhs", q.astype(jnp.float32), kk,
                        precision=HI) * (D ** -0.5)
    mask = jnp.arange(S)[None, None, :] < lengths[:, None, None]
    if window is not None:
        lo = jnp.maximum(lengths - window, 0)
        mask &= jnp.arange(S)[None, None, :] >= lo[:, None, None]
    p = jax.nn.softmax(jnp.where(mask, logits, -1e30), axis=-1)
    return jnp.einsum("bhs,bshd->bhd", p, vv, precision=HI)


def parity_attention():
    from xbitops.kernels.attention import decode_attention, prefill_attention
    from xbitops.models import llama

    key = jax.random.PRNGKey(1)
    B, S, H, Hkv, D, live = 8, 2048, 32, 32, 128, 1000
    q = jax.random.normal(key, (B, H, D), jnp.bfloat16)
    kf = jax.random.normal(jax.random.fold_in(key, 1), (B, S, Hkv, D))
    vf = jax.random.normal(jax.random.fold_in(key, 2), (B, S, Hkv, D))
    kb, vb = kf.astype(jnp.bfloat16), vf.astype(jnp.bfloat16)
    lengths = jnp.full((B,), live, jnp.int32).at[0].set(1).at[1].set(S)

    def report(name, got, want, tol):
        e = float(jnp.abs(got.astype(jnp.float32) - want).max())
        log(f"decode attention {name}: abs {e:.2e} (<= {tol})")
        check(e <= tol, f"decode attention {name}")

    report("bf16", decode_attention(q, hmT(kb), hmT(vb), lengths),
           ref_att(q, kb, vb, lengths), TOL_ATT_BF16)
    report("bf16 window=512",
           decode_attention(q, hmT(kb), hmT(vb), lengths, window=512),
           ref_att(q, kb, vb, lengths, window=512), TOL_ATT_BF16)
    L = 2
    kS = jnp.stack([hmT(kb), hmT(vb)])
    vS = jnp.stack([hmT(vb), hmT(kb)])
    report("bf16 stacked layer=1",
           decode_attention(q, kS, vS, lengths, layer_idx=jnp.int32(1)),
           ref_att(q, vb, kb, lengths), TOL_ATT_BF16)
    del kS, vS
    kq, ks = llama._quant_kv(kf)
    vq, vs = llama._quant_kv(vf)
    kw, vw = llama._pack_kv_words(kq), llama._pack_kv_words(vq)
    ksp = llama._pack_kv_scales(ks).astype(jnp.bfloat16)
    vsp = llama._pack_kv_scales(vs).astype(jnp.bfloat16)
    kd = ((kq - 128) * ks[..., None].astype(jnp.bfloat16)).astype(jnp.bfloat16)
    vd = ((vq - 128) * vs[..., None].astype(jnp.bfloat16)).astype(jnp.bfloat16)
    report("int8", decode_attention(q, kw, vw, lengths, k_scale=ksp, v_scale=vsp),
           ref_att(q, kd, vd, lengths), TOL_ATT_INT8)
    report("int8 stacked layer=1 window=512",
           decode_attention(q, jnp.stack([vw, kw]), jnp.stack([kw, vw]), lengths,
                            layer_idx=jnp.int32(1), window=512,
                            k_scale=jnp.stack([vsp, ksp]), v_scale=jnp.stack([ksp, vsp])),
           ref_att(q, kd, vd, lengths, window=512), TOL_ATT_INT8)
    # paged pool: pages of 256 positions shuffled through the pool
    psz = 256
    P = S // psz
    order = jax.random.permutation(key, B * P)
    pool_of = lambda x: x.reshape(B, Hkv, P, psz, D).transpose(0, 2, 1, 3, 4).reshape(
        B * P, Hkv, psz, D)[order]
    table = jnp.argsort(order).reshape(B, P).astype(jnp.int32)
    report("bf16 paged", decode_attention(q, pool_of(hmT(kb)), pool_of(hmT(vb)),
                                          lengths, page_table=table),
           ref_att(q, kb, vb, lengths), TOL_ATT_BF16)

    # chunked prefill: C=512 queries at positions 512..1023 of each slot
    N, C = 4, 512
    qp = jax.random.normal(jax.random.fold_in(key, 3), (N, C, H, D), jnp.bfloat16)
    positions = jnp.broadcast_to(512 + jnp.arange(C)[None], (N, C)).astype(jnp.int32)
    slots = jnp.arange(N, dtype=jnp.int32)
    mask = jnp.arange(S)[None, None, :] <= positions[:, :, None]
    kT, vT = hmT(kb[:N]), hmT(vb[:N])
    for name, got, ctx, tol in (
        ("bf16", prefill_attention(qp, kT, vT, positions, slots), (kT, vT),
         TOL_ATT_BF16),
        ("int8", prefill_attention(qp, kw[:N], vw[:N], positions, slots,
                                   k_scale=ksp[:N], v_scale=vsp[:N]),
         (llama._unpack_kv_words(kw[:N], ksp[:N]),
          llama._unpack_kv_words(vw[:N], vsp[:N])), TOL_ATT_INT8),
    ):
        want = llama._attention(qp.astype(jnp.float32), *ctx, mask, D ** -0.5)
        e = float(jnp.abs(got.astype(jnp.float32) - want).max())
        log(f"prefill attention {name} S={S} C={C}: abs {e:.2e} (<= {tol})")
        check(e <= tol, f"prefill attention {name}")


# --------------------------------------------------------------------------
# phase 3-5: engine, server, compiled HLO
# --------------------------------------------------------------------------


def cycle_prompt(n: int, start: int):
    return [(start + i) % PERIOD for i in range(n)]


def expect_cycle(prompt, n_new):
    return [(prompt[-1] + 1 + i) % PERIOD for i in range(n_new)]


def reference_logits(params, cfg, prompts):
    """First decode-step logits on the kernel path and on the plain reference
    (``use_kernel=False`` f32 matmuls, ``flash_decode=False`` attention)."""
    from xbitops.models import llama
    from xbitops.ops.qmatmul import qmatmul

    B, T = len(prompts), len(prompts[0])
    tokens = jnp.asarray(prompts, jnp.int32)

    def run(cfg_):
        cache = llama.KVCache.init(cfg_, B, quantized=cfg_.max_seq_len >= 1024)
        logits, cache = jax.jit(
            functools.partial(llama.prefill, cfg=cfg_))(params, tokens=tokens,
                                                        cache=cache)
        nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        return jax.jit(llama.decode_step, static_argnums=1)(params, cfg_, nxt, cache)[0]

    got = run(cfg)
    orig = llama.qmatmul
    llama.qmatmul = functools.partial(qmatmul, use_kernel=False)
    try:
        want = run(dataclasses.replace(cfg, flash_decode=False))
    finally:
        llama.qmatmul = orig
    return got.astype(jnp.float32), want.astype(jnp.float32)


def engine_run(params, cfg, label, name_power, long_prompts: int):
    from xbitops.engine.engine import Engine, Request

    eng = Engine(params, cfg, slots=8, decode_burst=8)
    log(f"engine {label}: kv_quant={eng.kv_quant} donate_cache={eng.donate_cache}")
    reqs = []
    for i in range(8):
        n = 1000 if i < long_prompts else 16 + 2 * i
        reqs.append(Request(prompt=cycle_prompt(n, i), max_new_tokens=32, id=i))
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    first = time.perf_counter() - t0
    for r, c in zip(sorted(reqs, key=lambda r: r.id), sorted(outs, key=lambda c: c.id)):
        check(c.tokens == expect_cycle(r.prompt, 32),
              f"engine {label} request {r.id}: tokens leave the cycle: {c.tokens}")
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    dt = time.perf_counter() - t0
    n_tok = sum(len(c.tokens) for c in outs)
    log(f"engine {label}: {len(reqs)} requests ({long_prompts} of 1000 tokens) "
        f"follow the cycle; first generate (compile included) {first:.1f}s; "
        f"again {dt:.2f}s = {n_tok / dt:.1f} tok/s incl. prefill [{name_power}]")
    return eng


def phase_server(eng):
    import urllib.request

    from xbitops.engine.server import ServingEndpoint

    ep = ServingEndpoint(eng, host="127.0.0.1", port=0)
    port = ep.start()
    try:
        for i, prompt in enumerate((cycle_prompt(20, 3), cycle_prompt(24, 6))):
            body = json.dumps(dict(prompt=prompt, max_tokens=12)).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/completions", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as resp:
                out = json.loads(resp.read())
            toks = out["choices"][0]["tokens"]
            check(toks == expect_cycle(prompt, 12), f"server answer {i}: {toks}")
            log(f"server completion {i}: {toks}")
    finally:
        ep.shutdown()


def phase_compiled(params, cfg):
    from xbitops.kernels import common
    from xbitops.models import llama

    check(not common.interpret_default(), "kernels would interpret on this backend")
    cache = llama.KVCache.init(cfg, 8, quantized=True)
    lowered = jax.jit(llama.decode_step, static_argnums=1).lower(
        params, cfg, jnp.zeros((8,), jnp.int32), cache)
    calls = [ln for ln in lowered.as_text().splitlines()
             if "__gpu$xla.gpu.triton" in ln]
    for name in ("qmatmul", "attention"):
        n = sum(f'name = "{name}"' in ln for ln in calls)
        log(f"decode step: {n} Triton kernel call(s) named {name!r}")
        check(n > 0, f"no {name} kernel in the decode step")
    hlo = lowered.compile().as_text()
    n = hlo.count("__gpu$xla.gpu.triton")
    log(f"compiled decode step: {n} Triton custom call(s) in the optimized HLO")
    check(n >= 2, "the kernels did not survive compilation")


def one_card(name_power):
    from xbitops.models import llama
    from xbitops.utils import synth

    t0 = time.perf_counter()
    parity_qmatmul()
    parity_dequant()
    parity_attention()
    log(f"phase 2 (kernel parity) done in {time.perf_counter() - t0:.0f}s")

    t0 = time.perf_counter()
    base = llama.LlamaConfig.llama2_7b()
    params = synth.copy_llama_params(jax.random.PRNGKey(7), base, bits=4, group_size=128)
    params = jax.block_until_ready(llama.stack_layers(params, consume=True))
    log(f"built Llama-2-7B 4-bit copy-model, 32 layers, in {time.perf_counter() - t0:.0f}s")
    for S, long_prompts in ((256, 0), (2048, 4)):
        cfg = dataclasses.replace(base, max_seq_len=S)
        got, want = reference_logits(params, cfg, [cycle_prompt(32, i) for i in range(4)])
        e = float(jnp.abs(got - want).max() / jnp.abs(want).max())
        log(f"first-step logits S={S}: rel {e:.2e} (<= {TOL_LOGITS_REL}) vs plain reference")
        check(e <= TOL_LOGITS_REL, f"logits S={S}")
        check(bool((got.argmax(-1) == want.argmax(-1)).all()), "argmax differs")
        eng = engine_run(params, cfg, f"S={S}", name_power, long_prompts)
    log(f"phase 3 (engine) done in {time.perf_counter() - t0:.0f}s")
    phase_server(eng)
    phase_compiled(params, cfg)


def four_cards(name_power):
    from jax.sharding import Mesh

    from xbitops.engine.engine import Engine, Request
    from xbitops.models import llama
    from xbitops.parallel import model_tp
    from xbitops.utils import synth

    devs = jax.devices()
    check(len(devs) == 4, f"--chips 4 needs 4 devices, found {len(devs)}")
    mesh = Mesh(np.asarray(devs), ("model",))  # all-to-all NVLink: a flat axis
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), max_seq_len=512)
    key = jax.random.PRNGKey(8)
    t0 = time.perf_counter()
    p1 = llama.stack_layers(synth.copy_llama_params(key, cfg, bits=4, group_size=128),
                            consume=True)
    p4 = llama.stack_layers(synth.copy_llama_params(key, cfg, bits=4, group_size=128, tp=4),
                            consume=True)
    jax.block_until_ready((p1, p4))
    log(f"built Llama-3-8B 4-bit copy-model twice (TP=4 and one-card layouts) "
        f"in {time.perf_counter() - t0:.0f}s")

    prompts = [cycle_prompt(32, i) for i in range(4)]
    tokens = jnp.asarray(prompts, jnp.int32)
    c1 = llama.KVCache.init(cfg, 4)
    l1, c1 = jax.jit(functools.partial(llama.prefill, cfg=cfg))(p1, tokens=tokens, cache=c1)
    d1, _ = jax.jit(llama.decode_step, static_argnums=1)(
        p1, cfg, jnp.argmax(l1[:, -1], -1).astype(jnp.int32), c1)
    p4s = model_tp.shard_params(p4, mesh)
    c4 = model_tp.shard_cache(llama.KVCache.init(cfg, 4), mesh)
    l4, c4 = jax.jit(lambda p, t, c: model_tp.tp_prefill(p, cfg, mesh, t, c))(p4s, tokens, c4)
    d4, _ = jax.jit(lambda p, t, c: model_tp.tp_decode_step(p, cfg, mesh, t, c))(
        p4s, jnp.argmax(l4[:, -1], -1).astype(jnp.int32), c4)
    for name, a, b in (("prefill", l4[:, -1], l1[:, -1]), ("decode", d4, d1)):
        a, b = a.astype(jnp.float32), b.astype(jnp.float32)
        e = float(jnp.abs(a - b).max() / jnp.abs(b).max())
        log(f"TP=4 vs one card, {name} logits: rel {e:.2e} (<= {TOL_TP_REL})")
        check(e <= TOL_TP_REL, f"TP logits {name}")

    reqs = [Request(prompt=cycle_prompt(24 + 8 * i, i), max_new_tokens=32, id=i)
            for i in range(4)]
    outs = {}
    for label, eng in (("TP=4", Engine(p4, cfg, slots=4, mesh=mesh, decode_burst=8)),
                       ("one card", Engine(p1, cfg, slots=4, decode_burst=8))):
        t0 = time.perf_counter()
        outs[label] = [c.tokens for c in sorted(eng.generate(reqs), key=lambda c: c.id)]
        log(f"engine {label}: generate (compile included) {time.perf_counter() - t0:.1f}s "
            f"[{name_power}]")
        del eng
    check(outs["TP=4"] == outs["one card"], "TP=4 tokens differ from one card")
    for r, toks in zip(reqs, outs["TP=4"]):
        check(toks == expect_cycle(r.prompt, 32), f"TP request {r.id} leaves the cycle")
    log("TP=4 and one-card tokens are identical and follow the cycle")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's first device is {dev.platform!r})",
              file=sys.stderr)
        return 1
    from xbitops.utils import compile_cache

    compile_cache.enable()
    name_power = card()
    log(f"device: {dev.device_kind} x{len(jax.devices())}")
    log(f"card (nvidia-smi name, power.limit): {name_power}")
    t0 = time.perf_counter()
    if args.chips == 4:
        four_cards(name_power)
    else:
        one_card(name_power)
    log(f"all phases passed in {time.perf_counter() - t0:.0f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
