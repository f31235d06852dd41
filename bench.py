"""Headline benchmark: Llama-2-7B 4-bit decode tokens/s on one GPU vs the
a16w16 bf16 baseline, plus batch-32, long-context int8-KV decode and
long-context serving.

Prints the card's name and power limit, then ONE JSON line:
  {"metric": ..., "value": tokens/s, "unit": "tokens/s", "vs_baseline": ...,
   "device": {"platform": ..., "kind": ..., "count": ...}, ...}

``vs_baseline`` is our 4-bit-vs-dense speedup divided by the reference's own
headline claim ("Roughly 2times faster" than a16w16, reference README.md:19-20)
— i.e. >= 1.0 means we match or beat the reference's speedup on its own metric.

Decode steps run chained inside one jitted ``fori_loop`` (data dependency
through the KV cache and the sampled token); each timed call ends in
``block_until_ready``.  Exits non-zero when JAX finds no GPU, and any phase
that fails stops the run.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
from jax import lax

from xbitops.models import llama
from xbitops.utils import compile_cache, synth
from xbitops.utils.benchlib import time_call

B = 8  # decode batch (slots): step time is weight-bound, so tokens/s ~ B
SEQ = 128  # KV capacity of the short-context cells
STEPS = 64  # decode steps per timed call
REF_HEADLINE_SPEEDUP = 2.0  # reference README.md:19-20


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def make_decode_runner(cfg):
    @jax.jit
    def run(params, tokens, cache, n):
        def body(i, carry):
            toks, cache = carry
            logits, cache = llama.decode_step(params, cfg, toks, cache)
            return jnp.argmax(logits, -1).astype(jnp.int32), cache

        toks, _ = lax.fori_loop(0, n, body, (tokens, cache))
        return toks

    return run


def time_decode_step(params, cfg, label: str, batch: int = B,
                     kv_quant: bool = False, live: int = 0) -> float:
    """Seconds per decode step of ``batch`` slots.  ``live`` pre-sets every
    slot's cache length (long-context decode: attention reads follow it)."""
    cache = llama.KVCache.init(cfg, batch, quantized=kv_quant)
    if live:
        cache = dataclasses.replace(
            cache, lengths=jnp.full((batch,), live, jnp.int32))
    tokens = jnp.zeros((batch,), jnp.int32)
    run = make_decode_runner(cfg)
    first, sec = time_call(run, params, tokens, cache, jnp.int32(STEPS),
                           repeats=3)
    sec /= STEPS
    log(f"[{label}] compile+first {first:.1f}s; {sec * 1e3:.3f} ms/step "
        f"({batch / sec:.1f} tok/s)")
    return sec


def packed_model_bytes(params) -> int:
    """Bytes of quantized + dense weight reads per decode step."""
    total = 0
    for leaf in jax.tree.leaves(params, is_leaf=lambda x: hasattr(x, "bytes_packed")):
        if hasattr(leaf, "bytes_packed"):
            total += leaf.bytes_packed()
        else:
            total += leaf.size * leaf.dtype.itemsize
    return total


def serving_longctx(params) -> float:
    """End-to-end long-context serving: S=2048, 16 slots, 1000-token prompts
    through chunked prefill, 16 requests x 128 new tokens, burst-32 decode."""
    import numpy as np

    from xbitops.engine.engine import Engine, Request

    cfg2 = dataclasses.replace(llama.LlamaConfig.llama2_7b(), max_seq_len=2048)
    eng = Engine(params, cfg2, slots=16, decode_burst=32,
                 prefill_buckets=[16, 32], prefill_chunk=512)
    log(f"[serving] kv_quant={eng.kv_quant} donate={eng.donate_cache}")
    rng = np.random.default_rng(1)

    def reqs(n, new):
        return [
            Request(prompt=rng.integers(0, cfg2.vocab_size, size=1000).tolist(),
                    max_new_tokens=new, id=i)
            for i in range(n)
        ]

    eng.generate(reqs(16, 32))  # warm every program (chunk waves + burst)
    t0 = time.perf_counter()
    outs = eng.generate(reqs(16, 128))
    dt = time.perf_counter() - t0
    n_tok = sum(len(c.tokens) for c in outs)
    log(f"[serving] {n_tok} tok in {dt:.2f}s = {n_tok / dt:.1f} tok/s")
    return n_tok / dt


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"no GPU: JAX's first device is {dev.platform!r}")
        return 1
    compile_cache.enable()
    device = dict(platform=dev.platform, kind=dev.device_kind,
                  count=len(jax.devices()))
    name_power = card()
    print(f"card: {name_power}", flush=True)
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), max_seq_len=SEQ)
    key = jax.random.PRNGKey(0)

    log("building 4-bit 7B model (random packed bits)...")
    qparams = llama.stack_layers(
        synth.random_llama_params(key, cfg, bits=4, group_size=128),
        consume=True,  # peak memory: one model + a layer, not two models
    )
    qparams = jax.block_until_ready(qparams)
    qbytes = packed_model_bytes(qparams)
    log(f"quant model packed bytes: {qbytes / 1e9:.2f} GB")
    q_sec = time_decode_step(qparams, cfg, "4bit")
    peak_sec = time_decode_step(qparams, cfg, "4bit-B32", batch=32)
    # long-context decode: int8 KV at S=2048 with 1000 live positions per
    # slot, B=8 — attention reads follow the live lengths
    cfg_lc = dataclasses.replace(cfg, max_seq_len=2048)
    lc_sec = time_decode_step(qparams, cfg_lc, "4bit-int8kv-S2048",
                              kv_quant=True, live=1000)
    serve_tps = serving_longctx(qparams)
    del qparams

    log("building a16w16 bf16 7B baseline...")
    dparams = llama.stack_layers(
        synth.random_llama_params(key, cfg, bits=None), consume=True)
    d_sec = time_decode_step(jax.block_until_ready(dparams), cfg, "a16w16")
    del dparams

    speedup = d_sec / q_sec
    result = {
        "metric": "llama7b_4bit_decode_tokens_per_s",
        "value": round(B / q_sec, 2),
        "unit": "tokens/s",
        "vs_baseline": round(speedup / REF_HEADLINE_SPEEDUP, 3),
        "speedup_vs_a16w16": round(speedup, 3),
        "a16w16_tokens_per_s": round(B / d_sec, 2),
        "decode_batch": B,
        "weight_gbps": round(qbytes / q_sec / 1e9, 1),
        "peak_tokens_per_s_b32": round(32 / peak_sec, 1),
        "long_ctx_int8_ms_per_step_s2048_live1000": round(lc_sec * 1e3, 3),
        "long_ctx_tokens_per_s": round(B / lc_sec, 1),
        "serving_long_ctx_tokens_per_s": round(serve_tps, 1),
        "card": name_power,
        "device": device,
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
