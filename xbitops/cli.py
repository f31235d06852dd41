"""Command-line interface.

The reference's only executables are compiled benchmark binaries driven by
hard-coded fixture paths (``main.cc:14``); here the framework ships a real CLI:

    python -m xbitops convert  --ckpt <autogptq_dir> --out <packed_dir> [--tp N]
    python -m xbitops generate --ckpt <dir> --prompt "..." [--max-tokens N]
    python -m xbitops bench    [--bits 4] [--batch 4]

``convert`` ingests an AutoGPTQ safetensors checkpoint into the packed
layout once, offline; ``generate`` runs the continuous-batching engine on a
packed (or raw AutoGPTQ) checkpoint; ``bench`` times the fused matmul on a
model's decode shapes (one call per dispatch, so launch overhead counts).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _load_any(path: str, tp: int = 1, max_seq_len=None):
    """Load a packed dir (manifest.json) or an AutoGPTQ dir (config.json)."""
    from xbitops.io import load_autogptq, load_packed
    from xbitops.io.gptq_loader import llama_config_from_hf

    p = Path(path)
    if (p / "manifest.json").exists():
        params = load_packed(str(p), tp=tp)
        cfg = llama_config_from_hf(
            json.loads((p / "config.json").read_text()), max_seq_len
        )
        return params, cfg
    return load_autogptq(str(p), tp=tp, max_seq_len=max_seq_len)


def cmd_convert(args) -> int:
    import shutil

    from xbitops.io import load_autogptq, save_packed

    t0 = time.time()
    params, cfg = load_autogptq(args.ckpt, tp=args.tp, storage_bits=args.storage)
    save_packed(params, args.out, tp=args.tp)
    # carry model config + tokenizer alongside the packed arrays
    src = Path(args.ckpt)
    for name in ("config.json", "quantize_config.json", "tokenizer.json",
                 "tokenizer.model", "tokenizer_config.json"):
        if (src / name).exists():
            shutil.copy(src / name, Path(args.out) / name)
    print(f"packed {cfg.num_layers}-layer model -> {args.out} in {time.time()-t0:.1f}s")
    return 0


def cmd_generate(args) -> int:
    import jax
    from xbitops.engine import Engine, Request
    from xbitops.parallel.mesh import make_mesh

    params, cfg = _load_any(args.ckpt, tp=args.tp, max_seq_len=args.max_seq_len)
    mesh = None
    if args.tp > 1:
        mesh = make_mesh((1, args.tp), ("data", "model"))

    tokenizer = None
    tok_path = Path(args.ckpt)
    if (tok_path / "tokenizer.json").exists() or (tok_path / "tokenizer.model").exists():
        try:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(str(tok_path))
        except Exception as e:  # pragma: no cover
            print(f"(tokenizer unavailable: {e}; using raw token ids)", file=sys.stderr)

    prompts = args.prompt or ["1 2 3 4"]
    reqs = []
    for i, p in enumerate(prompts):
        if tokenizer is not None:
            ids = tokenizer(p)["input_ids"]
            eos = tokenizer.eos_token_id
        else:
            ids = [int(t) for t in p.split()]
            eos = None
        reqs.append(
            Request(prompt=ids, max_new_tokens=args.max_tokens,
                    temperature=args.temperature, eos_id=eos, id=i)
        )

    eng = Engine(params, cfg, slots=args.slots, mesh=mesh, top_k=args.top_k,
                 top_p=args.top_p, seed=args.seed)
    t0 = time.time()
    outs = eng.generate(reqs)
    dt = time.time() - t0
    n_tok = sum(len(c.tokens) for c in outs)
    for c in outs:
        if tokenizer is not None:
            print(f"[{c.id}] {tokenizer.decode(c.tokens)!r} ({c.finish_reason})")
        else:
            print(f"[{c.id}] {c.tokens} ({c.finish_reason})")
    print(f"{n_tok} tokens in {dt:.2f}s ({n_tok/dt:.1f} tok/s incl. compile)",
          file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    from xbitops.engine import Engine
    from xbitops.engine.server import ServingEndpoint

    params, cfg = _load_any(args.ckpt, max_seq_len=args.max_seq_len)
    tokenizer = None
    tok_path = Path(args.ckpt)
    if (tok_path / "tokenizer.json").exists() or (
            tok_path / "tokenizer.model").exists():
        try:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(str(tok_path))
        except Exception as e:  # pragma: no cover
            print(f"(tokenizer unavailable: {e}; token-id prompts only)",
                  file=sys.stderr)
    eng = Engine(params, cfg, slots=args.slots, decode_burst=args.burst)
    ep = ServingEndpoint(eng, host=args.host, port=args.port,
                         tokenizer=tokenizer)
    print(f"serving on http://{args.host}:{ep.port} "
          f"(slots={args.slots}, kv_quant={eng.kv_quant})", file=sys.stderr)
    try:
        ep.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def cmd_quantize(args) -> int:
    import shutil

    import jax

    from xbitops.io import load_autogptq, save_packed
    from xbitops.ops.gptq import quantize_model_gptq

    t0 = time.time()
    # load_autogptq on a dense checkpoint keeps every projection dense
    params, cfg = load_autogptq(args.ckpt, max_seq_len=args.seq_len)
    if args.calib_npy:
        import numpy as np

        calib = jax.numpy.asarray(np.load(args.calib_npy)[:, : args.seq_len])
        print(f"calibrating on {calib.shape[0]}x{calib.shape[1]} tokens "
              f"from {args.calib_npy}", file=sys.stderr)
    else:
        B = max(1, args.calib_tokens // args.seq_len)
        calib = jax.random.randint(
            jax.random.PRNGKey(0), (B, args.seq_len), 0, cfg.vocab_size
        )
        print(f"calibrating on {B}x{args.seq_len} random tokens "
              "(pass real text via --calib-npy for production use)",
              file=sys.stderr)
    qparams = quantize_model_gptq(
        params, cfg, calib, bits=args.bits, group_size=args.group_size,
        act_order=args.act_order, verbose=True,
    )
    save_packed(qparams, args.out)
    src = Path(args.ckpt)
    for name in ("config.json", "tokenizer.json", "tokenizer.model",
                 "tokenizer_config.json"):
        if (src / name).exists():
            shutil.copy(src / name, Path(args.out) / name)
    print(f"gptq {args.bits}-bit packed -> {args.out} in {time.time()-t0:.0f}s")
    return 0


def cmd_bench(args) -> int:
    import jax
    import jax.numpy as jnp

    import xbitops as xb
    from xbitops.models import llama
    from xbitops.utils import synth
    from xbitops.utils.benchlib import time_call

    cfgs = {
        "llama2-7b": llama.LlamaConfig.llama2_7b(),
        "llama2-13b": llama.LlamaConfig.llama2_13b(),
        "llama3-8b": llama.LlamaConfig.llama3_8b(),
        "mistral-7b": llama.LlamaConfig.mistral_7b(),
    }
    cfg = cfgs[args.model]
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    qdim = cfg.num_heads * cfg.head_dim
    kvdim = cfg.num_kv_heads * cfg.head_dim
    shapes = [  # the model's per-layer projections (fused qkv / gate|up)
        (h, qdim + 2 * kvdim), (qdim, h), (h, 2 * ffn), (ffn, h),
    ]
    dev = jax.devices()[0]
    key = jax.random.PRNGKey(0)
    for K, N in shapes:
        qt = synth.random_qtensor(key, K, N, args.bits, args.group_size)
        a = jax.random.normal(key, (args.batch, K), jnp.bfloat16) * 0.2
        fn = jax.jit(lambda a, qt: xb.qmatmul(a, qt))
        _, dt = time_call(fn, a, qt, repeats=20)
        print(json.dumps(dict(
            K=K, N=N, bits=args.bits, us=round(dt * 1e6, 1),
            gbps=round(qt.bytes_packed() / dt / 1e9, 1),
            device=dict(platform=dev.platform, kind=dev.device_kind),
        )))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="xbitops")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert", help="AutoGPTQ checkpoint -> packed layout")
    c.add_argument("--ckpt", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--tp", type=int, default=1)
    c.add_argument("--storage", choices=["auto", "packed"], default="auto",
                   help="plane storage width: 'auto' stores 3/5/6/7-bit values "
                        "in the next single-plane width the fused kernel "
                        "runs (more bytes); 'packed' keeps exact b-bit storage")
    c.set_defaults(fn=cmd_convert)

    g = sub.add_parser("generate", help="run the decode engine")
    g.add_argument("--ckpt", required=True)
    g.add_argument("--prompt", action="append", help="repeatable; token ids if no tokenizer")
    g.add_argument("--max-tokens", type=int, default=64)
    g.add_argument("--max-seq-len", type=int, default=None)
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top-k", type=int, default=0)
    g.add_argument("--top-p", type=float, default=1.0)
    g.add_argument("--slots", type=int, default=4)
    g.add_argument("--tp", type=int, default=1)
    g.add_argument("--seed", type=int, default=0)
    g.set_defaults(fn=cmd_generate)

    b = sub.add_parser("bench", help="op-level fused-kernel bench (model-family shapes)")
    b.add_argument("--model", default="llama2-7b",
                   choices=["llama2-7b", "llama2-13b", "llama3-8b",
                            "mistral-7b"])
    b.add_argument("--bits", type=int, default=4)
    b.add_argument("--group-size", type=int, default=128)
    b.add_argument("--batch", type=int, default=4)
    b.set_defaults(fn=cmd_bench)

    s = sub.add_parser("serve", help="HTTP serving endpoint (/v1/completions)")
    s.add_argument("--ckpt", required=True)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--slots", type=int, default=8)
    s.add_argument("--burst", type=int, default=8)
    s.add_argument("--max-seq-len", type=int, default=None)
    s.set_defaults(fn=cmd_serve)

    q = sub.add_parser("quantize", help="GPTQ-quantize a dense HF Llama checkpoint")
    q.add_argument("--ckpt", required=True, help="dense safetensors dir (HF layout)")
    q.add_argument("--out", required=True)
    q.add_argument("--bits", type=int, default=4)
    q.add_argument("--group-size", type=int, default=128)
    q.add_argument("--act-order", action="store_true")
    q.add_argument("--calib-tokens", type=int, default=2048,
                   help="total calibration tokens (random ids if no dataset)")
    q.add_argument("--calib-npy", default=None,
                   help=".npy of int token ids [rows, seq] to calibrate on")
    q.add_argument("--seq-len", type=int, default=512)
    q.set_defaults(fn=cmd_quantize)

    args = ap.parse_args(argv)
    from xbitops.utils import compile_cache

    compile_cache.enable()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
