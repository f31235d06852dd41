"""Continuous-batching decode engine.

The reference stops at the fused GEMV; serving is left to the caller (SURVEY §1
"what sits above L4").  Here the decode loop is part of the framework:

- a fixed pool of ``slots`` cache slots (static shapes — XLA compiles exactly
  two programs: per-bucket prefill and one decode step);
- ragged admission: each incoming request prefills into a free slot (padded to
  a static bucket length; pad tokens carry position >= S so they neither write
  cache nor advance lengths — see ``models/llama.py``);
- batched decode over all slots with an ``active`` mask; finished slots are
  refilled from the queue without draining the batch (continuous batching);
- per-slot temperature, engine-level top-k/top-p, per-request eos/max-tokens.

Runs single-chip or tensor-parallel over a mesh (same host loop; the jitted
step functions swap for shard_map versions).
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from functools import partial
from typing import Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from xbitops.engine import sampling
from xbitops.models import llama


@dataclasses.dataclass
class Request:
    """One generation request."""

    prompt: Sequence[int]
    max_new_tokens: int = 64
    temperature: float = 0.0
    eos_id: Optional[int] = None
    id: Optional[int] = None


@dataclasses.dataclass
class Completion:
    id: int
    prompt_len: int
    tokens: List[int]  # generated tokens (eos included if hit)
    finish_reason: str  # "eos" | "length" | "capacity"


def _tree_nbytes(t) -> int:
    return sum(
        leaf.size * leaf.dtype.itemsize
        for leaf in jax.tree.leaves(t)
        if hasattr(leaf, "size") and hasattr(leaf, "dtype")
    )


def _device_hbm_limit() -> Optional[float]:
    """Device memory this process may use, from the device's own
    ``memory_stats()``; None when the device reports none (no size is
    assumed)."""
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("bytes_limit") or stats.get("bytes_reservable_limit")


def default_buckets(max_seq_len: int) -> List[int]:
    b, out = 16, []
    while b < max_seq_len:
        out.append(b)
        b *= 2
    out.append(max_seq_len)
    return out


class Engine:
    """Continuous-batching engine over a quantized (or dense) Llama model."""

    def __init__(
        self,
        params,
        cfg: llama.LlamaConfig,
        slots: int = 8,
        mesh=None,
        axis: str = "model",
        prefill_buckets: Optional[Sequence[int]] = None,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        cache_dtype=jnp.bfloat16,
        decode_burst: int = 1,
        prefill_chunk: int = 512,
        kv_quant: Optional[bool] = None,
        spec_tokens: int = 0,
        paged: bool = False,
        pool_pages: Optional[int] = None,
        page_size: int = 256,
        pipeline: int = 0,
        max_restarts: int = 0,
        donate_cache: Optional[bool] = None,
        draft_params=None,
        draft_cfg: Optional[llama.LlamaConfig] = None,
    ):
        """``decode_burst`` chains that many decode steps in one device
        dispatch (a ``lax.scan``): host<->device round-trip latency amortizes
        over the burst, at the cost of admission granularity and of discarding
        any tokens a slot sampled after its stop condition.

        Prompts longer than ``prefill_chunk`` prefill in fixed chunks that
        attend the cache (O(chunk * S) attention memory instead of O(T^2)).
        ``kv_quant`` stores the KV cache as int8, packed (4
        positions per int32 word) with per-(token, head) scales: twice the
        context capacity per byte, near-lossless.  ``None`` (default)
        auto-picks: int8 at long context (max_seq_len >= 1024) or whenever
        two bf16 caches + weights would exceed device memory (forcing
        donation), bf16 otherwise; see ``_auto_kv_quant``.

        ``paged=True`` allocates the KV cache as a shared page POOL of
        ``pool_pages`` pages x ``page_size`` positions with per-slot page
        tables (vLLM-style): memory follows the pool, not
        slots * max_seq_len, so mixed long/short batches fit; slots that
        outrun the free pool pause until pages free up.  The decode
        attention kernel looks pages up itself — no gathers on the hot
        path.

        ``pipeline=N`` (or True = 1) keeps up to N decode bursts IN FLIGHT:
        each new burst dispatches chained off the newest in-flight burst's
        device-resident tokens before older results reach the host, so host
        bookkeeping and dispatch latency overlap device compute
        (continuation tokens never round-trip).  Bookkeeping trails N
        bursts — a finished slot decodes up to N extra (discarded) bursts,
        and admissions see slot state N bursts late — but emitted tokens
        are identical.  It pays only when the hidden host latency outweighs
        the wasted stale bursts, so small bursts gain more than large ones;
        exclusive with ``spec_tokens``.

        ``spec_tokens`` (gamma > 0) enables speculative decoding: each step
        drafts gamma tokens per slot by n-gram lookup in the slot's own
        history and verifies them in ONE forward (decode is weight-bound, so
        the extra tokens ride the same weight stream) — accepted drafts
        multiply tokens/step on repetitive continuations.  Output matches
        plain greedy up to bf16 rounding differences between the T=1 and
        T=gamma+1 compute paths (near-tie argmax flips; bit-identical on
        equal paths).  `spec_stats` reports drafted/accepted so deployments
        can check their workload's acceptance before enabling.
        Greedy-only (all requests must have temperature <= 0); mutually
        exclusive with ``decode_burst > 1``.

        ``draft_params``/``draft_cfg`` switch speculative decoding's draft
        source from n-gram prompt-lookup to a (small, usually quantized)
        DRAFT MODEL: each spec step runs ``spec_tokens`` greedy draft-model
        decode steps in one dispatch (its own KV cache rides along,
        length-synced to the target's before every chain), then the target
        verifies as usual.  The draft model sees every admitted prompt (its
        cache prefills alongside the target's) and must share the target's
        vocabulary and ``max_seq_len``.  Unlike the n-gram draft, a trained
        draft model accepts on NON-repetitive continuations — the standard
        way spec decoding pays off in production.  Requires ``spec_tokens >
        0``, no mesh, non-paged.

        ``max_restarts`` > 0 enables failure recovery: a device error during
        a dispatch (preemption, interconnect fault — surfaced by JAX as
        ``JaxRuntimeError``) rebuilds the KV cache from scratch and REQUEUES
        every in-flight request as prompt + tokens-emitted-so-far, resuming
        where it stopped (weights are host-reloadable params, the cache is
        reconstructable state).  Already-emitted tokens are kept; greedy
        requests resume bit-identically, sampled ones re-draw randomness
        from the resume point."""
        self.cfg = cfg
        self.slots = slots
        self.mesh = mesh
        self.axis = axis
        self.prefill_chunk = min(prefill_chunk, cfg.max_seq_len)
        self.buckets = sorted(
            b for b in (prefill_buckets or default_buckets(cfg.max_seq_len))
            if b <= self.prefill_chunk
        ) or [self.prefill_chunk]
        if kv_quant is None:
            # auto-pick the cache dtype from the measured regimes (see
            # _auto_kv_quant); the caller can force either with True/False
            kv_quant = (
                not paged
                and mesh is None
                and cache_dtype == jnp.bfloat16
                and cfg.max_seq_len % 4 == 0
                and self.prefill_chunk % 4 == 0
                and cfg.flash_decode and cfg.head_dim % 128 == 0
                and self._auto_kv_quant(params, cfg, slots)
            )
        self.kv_quant = bool(kv_quant)
        if kv_quant:
            # packed int8 cache writes whole 4-position words: every prefill
            # shape must be a multiple of 4
            self.buckets = sorted({-(-b // 4) * 4 for b in self.buckets})
            if self.prefill_chunk % 4:
                raise ValueError("kv_quant requires prefill_chunk % 4 == 0")
        self.decode_burst = max(1, decode_burst)
        self.spec_tokens = max(0, spec_tokens)
        self.pipeline = int(pipeline)  # max bursts in flight (0 = sync)
        if self.spec_tokens and self.decode_burst > 1:
            raise ValueError("spec_tokens and decode_burst > 1 are exclusive")
        if self.spec_tokens and self.pipeline:
            raise ValueError("spec_tokens and pipeline are exclusive")
        self.draft_cfg = draft_cfg
        self.draft_params = None
        self._draft_cache = None
        if draft_params is not None:
            if not self.spec_tokens:
                raise ValueError("draft_params requires spec_tokens > 0")
            if draft_cfg is None:
                raise ValueError("draft_params requires draft_cfg")
            if mesh is not None or paged:
                raise ValueError(
                    "draft-model speculation supports mesh=None, paged=False")
            if draft_cfg.vocab_size < cfg.vocab_size:
                raise ValueError("draft model must cover the target vocab")
            if draft_cfg.max_seq_len != cfg.max_seq_len:
                raise ValueError(
                    "draft_cfg.max_seq_len must equal the target's (the "
                    "draft cache mirrors the target's positions)")
            try:
                draft_params = llama.stack_layers(draft_params)
            except (ValueError, TypeError):
                pass
            self.draft_params = draft_params
            self._draft_cache_factory = lambda: llama.KVCache.init(
                draft_cfg, slots)
            self._draft_cache = self._draft_cache_factory()
        self.max_restarts = max(0, max_restarts)
        self.restarts = 0
        self._fault_hook = None  # tests inject dispatch-time device faults
        self._cache_factory = None  # set below once cache config is known
        self._key = jax.random.PRNGKey(seed)
        self._next_id = 0
        self.spec_stats = {
            "drafted": 0, "accepted": 0,
            "draft_source": ("model" if draft_params is not None else "ngram")
            if self.spec_tokens else None,
        }

        # stacked layers: O(1) compile in depth; the fused kernel indexes the
        # stacked planes in place (no per-step copy) and act-order perms stack
        # to [L, K] (the matmul gathers activations through perm[layer]).
        # Falls back to the layer list when layers aren't structurally
        # identical (mixed fusion).
        try:
            params = llama.stack_layers(params)
        except (ValueError, TypeError):
            pass

        self.paged = paged

        def make_cache():
            if paged:
                n_pages = pool_pages or slots * (cfg.max_seq_len // page_size)
                c = llama.KVCache.init_paged(
                    cfg, slots, n_pages, page_size, dtype=cache_dtype,
                    quantized=kv_quant,
                )
                self._free_pages = list(range(n_pages))
                self._slot_pages = [[] for _ in range(slots)]
                self._table = np.full(
                    (slots, cfg.max_seq_len // page_size), -1, np.int32
                )
            else:
                c = llama.KVCache.init(
                    cfg, slots, dtype=cache_dtype, quantized=kv_quant
                )
            if mesh is not None:
                from xbitops.parallel import model_tp

                c = model_tp.shard_cache(c, mesh, axis)
            return c

        if paged:
            if kv_quant and page_size % 4:
                raise ValueError("paged int8 KV needs page_size % 4 == 0")
            if not cfg.flash_decode or cfg.head_dim % 128:
                raise ValueError("paged KV requires the flash decode kernel")
            if cfg.max_seq_len % page_size:
                raise ValueError("max_seq_len must be a multiple of page_size")
            self.page_size = page_size
        if mesh is not None:
            from xbitops.parallel import model_tp

            params = model_tp.shard_params(params, mesh, axis)
        self._cache_factory = make_cache
        self.params = params
        self.cache = make_cache()
        if donate_cache is None:
            # Donating the cache into the step functions updates it in
            # place — mandatory when two cache copies + weights don't fit
            # device memory.  Otherwise each call writes a fresh cache
            # buffer.  The policy donates only when two caches do not fit
            # (ROADMAP S6 measures whether donating always is cheaper).
            donate_cache = not self._two_caches_fit()
        self.donate_cache = bool(donate_cache)
        self._build_step_fns(top_k, top_p)

    def _two_caches_fit(self, headroom: float = 0.82) -> bool:
        """True when weights + TWO cache buffers (the no-donation steady
        state) fit in device memory with headroom for activations."""
        limit = _device_hbm_limit()
        if not limit:
            return False  # unknown budget: keep the safe donating path
        return (
            _tree_nbytes(self.params) + 2 * _tree_nbytes(self.cache)
            <= headroom * limit
        )

    @staticmethod
    def _auto_kv_quant(params, cfg, slots: int, headroom: float = 0.82) -> bool:
        """Pick the KV cache dtype (int8 vs bf16):

        - short context: bf16, whose attention needs no dequantization;
        - long context (max_seq_len >= 1024): attention reads the cache, and
          int8 halves those bytes and doubles capacity;
        - whenever weights + two bf16 caches exceed device memory, bf16
          would force cache donation (or run out): int8 halves it.
        """
        L, Hkv, D, S = (cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                        cfg.max_seq_len)
        elems = 2 * L * slots * Hkv * S * D  # k + v positions × head_dim
        bf16_bytes = 2 * elems
        limit = _device_hbm_limit()
        if limit:
            w = _tree_nbytes(params)
            if w + 2 * bf16_bytes > headroom * limit:
                return True  # bf16 would donate (or OOM); int8 halves it
        return S >= 1024  # long context: read-bound, int8 wins

    # --- jitted step functions ---

    def _build_step_fns(self, top_k: int, top_p: float) -> None:
        cfg, mesh, axis = self.cfg, self.mesh, self.axis

        def make_bases(c):
            if mesh is None:
                def base_prefill(params, cache, tokens, true_lens, slots):
                    return llama.prefill_slots(params, c, tokens, true_lens, slots, cache)

                def base_prefill_chunks(params, cache, tokens, starts, lens, slots, resets):
                    return llama.prefill_slots_chunk(
                        params, c, tokens, starts, lens, slots, cache, resets=resets
                    )

                def base_decode(params, cache, tokens, active):
                    return llama.decode_step(params, c, tokens, cache, active=active)
            else:
                from xbitops.parallel import model_tp

                def base_prefill(params, cache, tokens, true_lens, slots):
                    return model_tp.tp_prefill_slots(
                        params, c, mesh, tokens, true_lens, slots, cache, axis
                    )

                def base_prefill_chunks(params, cache, tokens, starts, lens, slots, resets):
                    return model_tp.tp_prefill_slots_chunk(
                        params, c, mesh, tokens, starts, lens, slots, cache, axis,
                        resets=resets,
                    )

                def base_decode(params, cache, tokens, active):
                    return model_tp.tp_decode_step(
                        params, c, mesh, tokens, cache, axis, active=active
                    )
            return base_prefill, base_prefill_chunks, base_decode

        base_prefill, base_prefill_chunks, _ = make_bases(cfg)
        # () when two cache buffers fit device memory (see __init__); all
        # step fns share the policy so peak memory is uniform
        donate = (1,) if self.donate_cache else ()

        # Admission arguments ride in ONE packed int32 array: one
        # host->device transfer per admission wave instead of five.
        @partial(jax.jit, donate_argnums=donate)
        def prefill_fn(params, cache, packed, key):
            """Batched admission: prefill every row in one forward.  Rows
            with true_len == 0 are padding (their slot index is out of
            range).  ``packed[n, bucket+3]`` = tokens | len | slot | temp
            bits per row."""
            tokens = packed[:, :-3]
            true_lens = packed[:, -3]
            slots = packed[:, -2]
            temps = jax.lax.bitcast_convert_type(packed[:, -1], jnp.float32)
            logits, cache = base_prefill(params, cache, tokens, true_lens, slots)
            toks = sampling.sample_tokens(logits, key, temps, top_k, top_p)
            return toks, cache

        @partial(jax.jit, donate_argnums=donate)
        def prefill_chunks_fn(params, cache, packed, key):
            """Batched long-prompt admission: one chunk for EVERY long
            prompt in one forward (no per-request host dispatches).
            ``packed[n, C+5]`` = tokens | start | len | slot | reset | temp
            bits per row."""
            tokens = packed[:, :-5]
            starts = packed[:, -5]
            lens = packed[:, -4]
            slots = packed[:, -3]
            resets = packed[:, -2].astype(bool)
            temps = jax.lax.bitcast_convert_type(packed[:, -1], jnp.float32)
            logits, cache = base_prefill_chunks(
                params, cache, tokens, starts, lens, slots, resets
            )
            toks = sampling.sample_tokens(logits, key, temps, top_k, top_p)
            return toks, cache

        self._prefill_chunks_fn = prefill_chunks_fn

        burst = self.decode_burst

        def make_decode_fn(c, greedy=False):
            base_decode = make_bases(c)[2]

            @partial(jax.jit, donate_argnums=donate)
            def decode_fn(params, cache, tokens, active, key, temps):
                """Run `burst` chained decode steps; returns (tokens [burst, B],
                next PRNG key, cache).

                Slots that hit a stop condition mid-burst keep decoding garbage
                (the host discards it); out-of-capacity positions self-mask via
                the drop-scatter semantics in models/llama.py.  The key chain
                advances ON DEVICE (the returned key feeds the next burst): on
                a high-latency link every host-issued operation costs a round
                trip, so the steady-state burst is exactly two — the decode
                dispatch and the token readback (active/temps/tokens reuse
                device-resident values unless the host changed them).

                The ``greedy`` variant is a second compiled program for bursts
                where every active slot has temperature <= 0 (the serving
                default): a bare argmax replaces the full sampling machinery
                (categorical draw + top-k/top-p masking over [B, V] logits)
                and consumes no randomness — the key
                chain passes through unchanged, so mixed workloads that
                alternate programs keep their sampled draws distinct.  Token
                streams are bit-identical between the programs for greedy
                rows (sample_tokens' greedy branch is the same argmax).
                """

                if greedy:
                    def body(carry, _):
                        toks, cache = carry
                        logits, cache = base_decode(params, cache, toks, active)
                        nxt = jnp.argmax(
                            logits.astype(jnp.float32), axis=-1
                        ).astype(jnp.int32)
                        nxt = jnp.where(active, nxt, 0)
                        return (nxt, cache), nxt

                    (last, cache), seq = jax.lax.scan(
                        body, (tokens, cache), None, length=burst
                    )
                    return seq, last, key, cache

                keys = jax.random.split(key, burst + 1)

                def body(carry, k):
                    toks, cache = carry
                    logits, cache = base_decode(params, cache, toks, active)
                    nxt = sampling.sample_tokens(logits, k, temps, top_k, top_p)
                    nxt = jnp.where(active, nxt, 0)
                    return (nxt, cache), nxt

                (last, cache), seq = jax.lax.scan(
                    body, (tokens, cache), keys[:burst]
                )
                return seq, last, keys[burst], cache

            return decode_fn

        if self.spec_tokens:
            if mesh is None:
                def base_spec(params, cache, tokens, active):
                    return llama.spec_verify_step(
                        params, cfg, tokens, cache, active=active
                    )
            else:
                from xbitops.parallel import model_tp

                def base_spec(params, cache, tokens, active):
                    return model_tp.tp_spec_verify_step(
                        params, cfg, mesh, tokens, cache, axis, active=active
                    )

            @partial(jax.jit, donate_argnums=donate)
            def spec_fn(params, cache, tokens, active):
                greedy, accepted, cache = base_spec(params, cache, tokens, active)
                return greedy, accepted, cache

            self._spec_fn = spec_fn

            if self.draft_params is not None:
                dcfg = self.draft_cfg
                gamma = self.spec_tokens

                @partial(jax.jit, donate_argnums=donate)
                def draft_prefill_fn(dparams, dcache, packed):
                    """Mirror of prefill_fn on the draft model: same packed
                    admission rows, cache writes only (tokens unused)."""
                    _, dcache = llama.prefill_slots(
                        dparams, dcfg, packed[:, :-3], packed[:, -3],
                        packed[:, -2], dcache,
                    )
                    return dcache

                @partial(jax.jit, donate_argnums=donate)
                def draft_prefill_chunks_fn(dparams, dcache, packed):
                    _, dcache = llama.prefill_slots_chunk(
                        dparams, dcfg, packed[:, :-5], packed[:, -5],
                        packed[:, -4], packed[:, -3], dcache,
                        resets=packed[:, -2].astype(bool),
                    )
                    return dcache

                @partial(jax.jit, donate_argnums=donate)
                def draft_chain_fn(dparams, dcache, tok0, active, sync_lens):
                    """gamma+1 greedy draft-model steps in one dispatch.

                    Lengths first sync to the target's (entries before
                    ``tok0``); the chain then feeds tok0, d1..d_gamma — the
                    last feed's output is discarded but its cache WRITE keeps
                    a fully-accepted chain in sync (the target then holds
                    entries through d_gamma)."""
                    dcache = dataclasses.replace(
                        dcache,
                        lengths=jnp.where(active, sync_lens, dcache.lengths),
                    )

                    def body(carry, _):
                        toks, dc = carry
                        logits, dc = llama.decode_step(
                            dparams, dcfg, toks, dc, active=active)
                        nxt = jnp.argmax(
                            logits.astype(jnp.float32), axis=-1
                        ).astype(jnp.int32)
                        nxt = jnp.where(active, nxt, 0)
                        return (nxt, dc), nxt

                    (_, dcache), seq = jax.lax.scan(
                        body, (tok0, dcache), None, length=gamma + 1)
                    return jnp.swapaxes(seq[:gamma], 0, 1), dcache

                @partial(jax.jit, donate_argnums=donate)
                def spec_model_fn(params, cache, tok0, drafts, active):
                    toks = jnp.concatenate([tok0[:, None], drafts], axis=1)
                    return base_spec(params, cache, toks, active)

                self._draft_prefill_fn = draft_prefill_fn
                self._draft_prefill_chunks_fn = draft_prefill_chunks_fn
                self._draft_chain_fn = draft_chain_fn
                self._spec_model_fn = spec_model_fn

        self._prefill_fn = prefill_fn
        # One decode program: the attention kernel reads only live blocks,
        # never more bytes than the plain full-allocation attention.
        self._decode_fn = make_decode_fn(cfg)  # follows cfg.flash_decode
        # all-greedy bursts (the serving default) skip the sampling machinery
        # entirely; jit is lazy, so a pure-greedy workload never compiles the
        # full program and vice versa
        self._decode_greedy_fn = make_decode_fn(cfg, greedy=True)

    # --- paged-pool allocator (host side) ---

    def _pages_for(self, b: int, upto: int) -> bool:
        """Ensure slot ``b`` owns pages covering positions [0, upto); False if
        the pool can't satisfy it right now (caller defers the slot)."""
        need = -(-upto // self.page_size)
        have = len(self._slot_pages[b])
        if need > self._table.shape[1]:
            need = self._table.shape[1]  # capacity cap handles the rest
        if need - have > len(self._free_pages):
            return False
        for i in range(have, need):
            p = self._free_pages.pop()
            self._table[b, i] = p
            self._slot_pages[b].append(p)
        return True

    def _release_pages(self, b: int) -> None:
        self._free_pages.extend(self._slot_pages[b])
        self._slot_pages[b] = []
        self._table[b, :] = -1

    def _push_table(self) -> None:
        self.cache = dataclasses.replace(
            self.cache, page_table=jnp.asarray(self._table)
        )

    @staticmethod
    def _draft(hist, gamma):
        """n-gram (prompt-lookup) draft: continue from the most recent earlier
        occurrence of the trailing bigram in the slot's own history; pad with
        the last token.  Wrong drafts only cost the already-paid verify slot."""
        out = []
        if len(hist) >= 2:
            a, b = hist[-2], hist[-1]
            for j in range(len(hist) - 3, -1, -1):
                if hist[j] == a and hist[j + 1] == b:
                    out = list(hist[j + 2 : j + 2 + gamma])
                    break
        while len(out) < gamma:
            out.append(hist[-1] if hist else 0)
        return np.asarray(out[:gamma], np.int32)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"prompt length {n} exceeds max bucket {self.buckets[-1]}")

    def _split_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    @staticmethod
    def _admit_slot(b, r, prompt, slot_req, slot_gen, slot_len, temps, active):
        slot_req[b] = r
        slot_gen[b] = []
        slot_len[b] = len(prompt)
        temps[b] = r.temperature
        active[b] = True

    # --- host-side continuous-batching loop ---

    def generate(
        self,
        requests: Sequence[Request],
        on_token: Optional[Callable[[int, int], None]] = None,
    ) -> List[Completion]:
        """Run all requests to completion; slots refill as they free."""
        S = self.cfg.max_seq_len
        pending = deque()
        for r in requests:
            if r.id is None:
                r = dataclasses.replace(r, id=self._next_id)
            self._next_id = max(self._next_id, r.id + 1)
            if len(r.prompt) >= S:
                raise ValueError(f"prompt length {len(r.prompt)} >= max_seq_len {S}")
            if self.spec_tokens and r.temperature > 0:
                raise ValueError(
                    "speculative decoding verifies greedily; temperature > 0 "
                    "requests need spec_tokens=0"
                )
            pending.append(r)

        slot_req: List[Optional[Request]] = [None] * self.slots
        slot_gen: List[List[int]] = [[] for _ in range(self.slots)]
        slot_len = np.zeros(self.slots, np.int64)  # prompt + generated
        cur_tok = np.zeros(self.slots, np.int32)
        temps = np.zeros(self.slots, np.float32)
        active = np.zeros(self.slots, bool)
        # pipelined decode: bursts whose results haven't reached the host
        # yet (oldest first), plus per-slot admission epochs so a recycled
        # slot never swallows its previous occupant's in-flight tokens
        slot_epoch = np.zeros(self.slots, np.int64)
        inflight: deque = deque()
        done: List[Completion] = []
        # wall-time per loop phase, for serving-overhead diagnosis: the sum
        # should be ~the generate() wall time; "readback" includes device
        # compute the dispatch didn't overlap
        lt = self.loop_stats = defaultdict(float)

        def finish(b: int, reason: str):
            r = slot_req[b]
            done.append(Completion(r.id, len(r.prompt), slot_gen[b], reason))
            slot_req[b] = None
            slot_gen[b] = []
            active[b] = False
            if self.paged:
                self._release_pages(b)

        def accept(b: int, tok: int) -> None:
            """Record one generated token for slot b; retire if finished."""
            r = slot_req[b]
            slot_gen[b].append(tok)
            slot_len[b] += 1
            if on_token is not None:
                on_token(r.id, tok)
            if r.eos_id is not None and tok == r.eos_id:
                finish(b, "eos")
            elif len(slot_gen[b]) >= r.max_new_tokens:
                finish(b, "length")
            elif slot_len[b] >= S:
                finish(b, "capacity")
            else:
                cur_tok[b] = tok

        def drain(burst=None):
            """Process a burst's tokens (blocks until it's done on device —
            with pipelining newer bursts are already running by then)."""
            if burst is None:
                if not inflight:
                    return
                burst = inflight.popleft()
            t_mark = time.perf_counter()
            toks = np.asarray(jax.device_get(burst["toks"]))
            lt["readback"] += time.perf_counter() - t_mark
            t_mark = time.perf_counter()
            sa, epochs = burst["step_active"], burst["epochs"]
            for step in range(toks.shape[0]):
                for b in range(self.slots):
                    if sa[b] and active[b] and slot_epoch[b] == epochs[b]:
                        accept(b, int(toks[step, b]))
            lt["host_accept"] += time.perf_counter() - t_mark

        in_admission: List[Request] = []
        resume_prefix: dict = {}  # id -> tokens emitted before a restart
        orig_plen: dict = {}  # id -> original prompt length

        # Device-resident mirrors of the per-burst decode arguments.  On a
        # high-latency link EVERY host-issued operation (device_put, split,
        # index) costs a round trip, so the steady-state burst re-uses the
        # device copies: one decode dispatch + one token readback.  Mirrors
        # invalidate when the host changes the underlying value (admission,
        # paged deferral, restart).
        dev: dict = {"key": None, "last": None}

        def dev_arg(name: str, np_val: np.ndarray):
            cached = dev.get(name + "_np")
            if cached is None or not np.array_equal(cached, np_val):
                dev[name] = jnp.asarray(np_val)
                dev[name + "_np"] = np_val.copy()
            return dev[name]

        def run_loop():
            while pending or active.any() or inflight:
                t_mark = time.perf_counter()
                # admit new requests into free slots.  Short prompts batch into
                # ONE prefill dispatch (padded rows are inert); long prompts
                # batch too — all of them advance one chunk per dispatch, in
                # lockstep, through the same compiled program.
                admit, longs = [], []
                for b in range(self.slots):
                    if not active[b] and pending:
                        # paged: a request admits only if the pool can back its
                        # whole prompt; otherwise it waits for running slots to
                        # finish and free pages
                        if self.paged and not self._pages_for(
                            b, len(pending[0].prompt) + 1
                        ):
                            break
                        r = pending.popleft()
                        # track until _admit_slot records it in slot_req: a
                        # device fault during the prefill dispatch must requeue
                        # these, or their completions are silently dropped
                        in_admission.append(r)
                        prompt = list(r.prompt)
                        if len(prompt) <= self.buckets[-1]:
                            admit.append((b, r, prompt))
                        else:
                            longs.append((b, r, prompt))
                if (
                    self.paged and pending and not (admit or longs)
                    and not active.any()
                ):
                    need = -(-(len(pending[0].prompt) + 1) // self.page_size)
                    raise RuntimeError(
                        f"paged KV pool too small: request needs {need} pages, "
                        f"pool has {len(self._free_pages)} free and nothing "
                        f"running to release more"
                    )
                if self.paged and (admit or longs):
                    self._push_table()

                if longs:
                    C = self.prefill_chunk
                    n = self.slots  # fixed row count: one compiled program
                    n_chunks = -(-max(len(p) for _, _, p in longs) // C)
                    last_tok = {}
                    for ci in range(n_chunks):
                        packed = np.zeros((n, C + 5), np.int32)
                        packed[:, -3] = self.slots  # OOB slot = inert row
                        for i, (b, r, prompt) in enumerate(longs):
                            start = ci * C
                            if start >= len(prompt):
                                continue  # this prompt is done; row stays inert
                            piece = prompt[start : start + C]
                            packed[i, : len(piece)] = piece
                            packed[i, -5] = start
                            packed[i, -4] = len(prompt)
                            packed[i, -3] = b
                            packed[i, -2] = int(ci == 0)
                            packed[i, -1] = np.float32(r.temperature).view(
                                np.int32)
                        packed_dev = jnp.asarray(packed)
                        toks_dev, self.cache = self._prefill_chunks_fn(
                            self.params, self.cache, packed_dev,
                            self._split_key(),
                        )
                        if self.draft_params is not None:
                            self._draft_cache = self._draft_prefill_chunks_fn(
                                self.draft_params, self._draft_cache,
                                packed_dev,
                            )
                        # only chunks FINAL for some prompt carry a token the
                        # host needs; reading back every chunk would insert a
                        # round-trip sync between chunk dispatches (non-final
                        # chunks then pipeline through the link back-to-back)
                        final = [i for i, (_, _, prompt) in enumerate(longs)
                                 if ci == (len(prompt) - 1) // C]
                        if final:
                            toks_np = np.asarray(jax.device_get(toks_dev))
                            for i in final:
                                last_tok[i] = int(toks_np[i])
                    for i, (b, r, prompt) in enumerate(longs):
                        self._admit_slot(b, r, prompt, slot_req, slot_gen,
                                         slot_len, temps, active)
                        slot_epoch[b] += 1
                        accept(b, last_tok[i])
                    dev["last"] = None  # admitted slots start from host tokens

                if admit:
                    n = self.slots  # fixed row count: one compiled program
                    bucket = self._bucket(max(len(p) for _, _, p in admit))
                    packed = np.zeros((n, bucket + 3), np.int32)
                    packed[:, -2] = self.slots  # OOB slot = inert row
                    for i, (b, r, prompt) in enumerate(admit):
                        packed[i, : len(prompt)] = prompt
                        packed[i, -3] = len(prompt)
                        packed[i, -2] = b
                        packed[i, -1] = np.float32(r.temperature).view(np.int32)
                    packed_dev = jnp.asarray(packed)
                    toks_dev, self.cache = self._prefill_fn(
                        self.params, self.cache, packed_dev,
                        self._split_key(),
                    )
                    if self.draft_params is not None:
                        self._draft_cache = self._draft_prefill_fn(
                            self.draft_params, self._draft_cache, packed_dev)
                    toks_np = np.asarray(jax.device_get(toks_dev))
                    for i, (b, r, prompt) in enumerate(admit):
                        self._admit_slot(b, r, prompt, slot_req, slot_gen,
                                         slot_len, temps, active)
                        slot_epoch[b] += 1
                        accept(b, int(toks_np[i]))
                    dev["last"] = None  # admitted slots start from host tokens

                in_admission.clear()
                lt["admit_prefill"] += time.perf_counter() - t_mark

                if not active.any():
                    drain()
                    continue

                if self._fault_hook is not None:
                    self._fault_hook()  # tests inject device faults here
                # paged: slots about to write need their next page(s); slots
                # the pool can't serve this step sit out, resuming when free
                steps = (self.spec_tokens + 1) if self.spec_tokens else self.decode_burst
                if self.pipeline:
                    # slot_len lags the in-flight bursts — cover all of them
                    steps *= self.pipeline + 1
                step_active = active.copy()
                if self.paged:
                    for b in range(self.slots):
                        if active[b] and not self._pages_for(
                            b, min(int(slot_len[b]) + steps, S)
                        ):
                            step_active[b] = False
                    if not step_active.any():
                        raise RuntimeError(
                            "paged KV pool exhausted: every active slot is blocked"
                        )
                    self._push_table()

                if self.spec_tokens:
                    gamma = self.spec_tokens
                    if self.draft_params is not None:
                        # draft-model source: the whole draft chain + verify
                        # runs in two dispatches; drafts never round-trip
                        # before verification (one readback at the end)
                        act_dev = jnp.asarray(step_active)
                        tok0_dev = jnp.asarray(cur_tok)
                        drafts_dev, self._draft_cache = self._draft_chain_fn(
                            self.draft_params, self._draft_cache, tok0_dev,
                            act_dev, self.cache.lengths,
                        )
                        greedy, accepted, self.cache = self._spec_model_fn(
                            self.params, self.cache, tok0_dev, drafts_dev,
                            act_dev,
                        )
                        g, acc, drafts_np = jax.device_get(
                            (greedy, accepted, drafts_dev))
                        g, acc = np.asarray(g), np.asarray(acc)
                        toks = np.concatenate(
                            [np.asarray(cur_tok)[:, None],
                             np.asarray(drafts_np)], axis=1,
                        ).astype(np.int32)
                    else:
                        toks = np.zeros((self.slots, gamma + 1), np.int32)
                        for b in range(self.slots):
                            if step_active[b]:
                                hist = list(slot_req[b].prompt) + slot_gen[b]
                                toks[b, 0] = cur_tok[b]
                                toks[b, 1:] = self._draft(hist, gamma)
                        greedy, accepted, self.cache = self._spec_fn(
                            self.params, self.cache, jnp.asarray(toks),
                            jnp.asarray(step_active)
                        )
                        g = np.asarray(jax.device_get(greedy))
                        acc = np.asarray(jax.device_get(accepted))
                    for b in range(self.slots):
                        if not step_active[b]:
                            continue
                        a = int(acc[b])
                        self.spec_stats["drafted"] += gamma
                        self.spec_stats["accepted"] += a
                        emitted = list(toks[b, 1 : 1 + a]) + [int(g[b, a])]
                        # device capped cache writes at capacity — mirror it
                        emitted = emitted[: max(0, S - int(slot_len[b]))]
                        for tok in emitted:
                            if active[b]:
                                accept(b, int(tok))
                    continue

                decode = (
                    self._decode_greedy_fn
                    if not (temps[step_active] > 0).any()
                    else self._decode_fn
                )
                act_dev = dev_arg("active", step_active)
                temps_dev = dev_arg("temps", temps)
                if dev["key"] is None:
                    dev["key"] = self._split_key()
                t_mark = time.perf_counter()
                if self.pipeline:
                    # dispatch the next burst with device-resident tokens BEFORE
                    # reading in-flight ones: continuing slots chain through the
                    # NEWEST burst's last device token (no host round-trip)
                    if inflight:
                        # chain only slots still owned by the occupant the burst
                        # was dispatched for — a slot recycled meanwhile takes its
                        # fresh prefill token from the host instead
                        newest = inflight[-1]
                        cont = jnp.asarray(
                            newest["step_active"]
                            & (slot_epoch == newest["epochs"])
                        )
                        toks_in = jnp.where(
                            cont, newest["last"], jnp.asarray(cur_tok)
                        )
                    else:
                        toks_in = jnp.asarray(cur_tok)
                    toks_dev, last_dev, dev["key"], self.cache = decode(
                        self.params, self.cache, toks_in, act_dev,
                        dev["key"], temps_dev,
                    )
                    inflight.append(dict(
                        toks=toks_dev, last=last_dev,
                        step_active=step_active.copy(), epochs=slot_epoch.copy(),
                    ))
                    lt["dispatch"] += time.perf_counter() - t_mark
                    # only block on the oldest burst once the pipeline is full
                    while len(inflight) > self.pipeline:
                        drain()
                    continue

                toks_in = (
                    dev["last"] if dev["last"] is not None
                    else jnp.asarray(cur_tok)
                )
                toks_dev, last_dev, dev["key"], self.cache = decode(
                    self.params, self.cache, toks_in, act_dev,
                    dev["key"], temps_dev,
                )
                # `last` only covers slots that ran this burst: a deferred
                # (active but not step_active) slot's row is zeroed — fall
                # back to a host upload next burst in that case
                dev["last"] = (
                    last_dev if bool((step_active == active).all()) else None
                )
                lt["dispatch"] += time.perf_counter() - t_mark
                t_mark = time.perf_counter()
                toks = np.asarray(jax.device_get(toks_dev))  # [burst, B]
                lt["readback"] += time.perf_counter() - t_mark
                t_mark = time.perf_counter()
                for step in range(toks.shape[0]):
                    for b in range(self.slots):
                        if step_active[b] and active[b]:
                            accept(b, int(toks[step, b]))
                    if not active.any():
                        break  # rest of the burst is garbage for every slot
                lt["host_accept"] += time.perf_counter() - t_mark


        while True:
            try:
                run_loop()
                break
            except jax.errors.JaxRuntimeError:
                if self.restarts >= self.max_restarts:
                    raise
                self.restarts += 1
                inflight.clear()
                # requeue in-flight slots (prompt + emitted so far) and
                # any requests caught mid-admission; rebuild device state
                requeued_ids = set()
                for b in range(self.slots):
                    r = slot_req[b]
                    if r is None:
                        continue
                    requeued_ids.add(r.id)
                    orig_plen.setdefault(r.id, len(r.prompt))
                    resume_prefix[r.id] = resume_prefix.get(r.id, []) + slot_gen[b]
                    remaining = r.max_new_tokens - len(slot_gen[b])
                    if remaining <= 0:
                        done.append(Completion(
                            r.id, orig_plen[r.id], [], 'length'))
                    else:
                        pending.appendleft(dataclasses.replace(
                            r, prompt=list(r.prompt) + slot_gen[b],
                            max_new_tokens=remaining))
                    slot_req[b] = None
                    slot_gen[b] = []
                # requests popped off pending but not yet recorded in slot_req
                # (fault during the prefill dispatch itself)
                for r in in_admission:
                    if r.id not in requeued_ids and all(
                        p.id != r.id for p in pending
                    ):
                        pending.appendleft(r)
                in_admission.clear()
                active[:] = False
                slot_len[:] = 0
                cur_tok[:] = 0
                temps[:] = 0
                slot_epoch[:] += 1
                # device mirrors may reference poisoned post-fault buffers
                dev.clear()
                dev.update({"key": None, "last": None})
                self.cache = self._cache_factory()
                if self.draft_params is not None:
                    self._draft_cache = self._draft_cache_factory()

        # merge pre-restart emissions back into resumed completions
        if resume_prefix:
            merged = {}
            for c in done:
                if c.id in merged:
                    prev = merged[c.id]
                    merged[c.id] = Completion(
                        c.id, prev.prompt_len, prev.tokens + c.tokens,
                        c.finish_reason)
                else:
                    pre = resume_prefix.get(c.id, [])
                    merged[c.id] = Completion(
                        c.id, orig_plen.get(c.id, c.prompt_len),
                        pre + c.tokens, c.finish_reason)
            done[:] = merged.values()
        return sorted(done, key=lambda c: c.id)
