"""Serving engine: continuous batching over slots, pluggable decoding
strategies, and the padded path.

The port of ``repro.serving.engine``.  A host-side
FIFO scheduler (``serving/scheduler.py``) admits requests into live batch
slots; each admission prefills the request alone -- at its exact prompt
length, or right-padded to a bucket length with ``prefill_buckets=`` (the
caches and logits are then read at the prompt's own length, ``valid_len``)
-- and scatters the resulting caches into its slot (``serving/cache.py``).
Decode then runs in a loop whose body is the strategy's ``step`` and whose
condition is the all-done predicate: a ``mapreduce`` over the active flags
(kernel K3 on the card).  Slots free as requests hit EOS or
``max_new_tokens``; the scheduler recycles them for waiting arrivals, and
with ``poison_on_evict=True`` a freed slot's caches are overwritten with
NaN first, so a stale read would show.  ``quantize_kv=`` keeps every
attention KV cache as ``KVQuant`` codes and scales (``"int8"``,
``"fp8_e4m3"`` -- alias ``"fp8"`` -- or ``"fp8_e5m2"``), quantized at
write and dequantized at read.

**What the loop body does is the strategy** (``Engine(strategy=...)``,
``serving/strategies/``): greedy / top-k / top-p is the default
(``Vanilla``); speculative decoding, beam search and DFA-constrained
sampling ride the same loop and scheduler.

Where the reference runs the loop as one ``lax.while_loop`` on the device,
the port runs it from Python and reads the predicate back once per
iteration -- one host sync per decode step, or per speculative or beam
round.  Drains read the finished outputs back through the CSR compaction
(kernel K2) and the per-slot scores (K7m).

The padded path (``generate_padded``) is the reference's fixed-batch
host loop: one prefill over the left-padded batch, then one decode step at
one position for the whole batch and one read of its tokens a step.  It
is the vanilla differential oracle of the continuous path (it refuses any
other strategy), and the only path of an encoder-decoder, whose cross
caches are as long as each batch's source (``generate`` routes one there;
``serve`` refuses one, and the engine refuses an encoder-decoder under any
strategy but vanilla).

Decoding is greedy at ``temperature=0`` (the default) and otherwise
samples with the reference's counter-based keys: the ``j``-th token of a
request with seed ``s`` uses ``fold_in(fold_in(PRNGKey(seed), s), j)``, so a
request's stream depends only on its prompt and seed, never on batch
composition (``serving/sampling.py``; the radix top-k and nucleus scan run
kernels K2, K4, K6 and K7s on the card).  Prefill runs behind zero prefix
embeddings where the config takes them (``num_prefix_embeds``), so a
request's positions start after the prefix, and over a zero source
(``src_embeds``) for an encoder-decoder, as the reference engine's
stand-ins for a frontend's output.  The reference's ``mesh`` argument
(sharded prefill and decode) is not in the port.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import operators as alg
from repro_torch.core import primitives as forge
from repro_torch.core.layout import Flat
from repro_torch.devices import resolve_device
from repro_torch.models import lm
from repro_torch.serving import cache as CA
from repro_torch.serving import sampling as SP
from repro_torch.serving import strategies as ST
from repro_torch.serving.scheduler import Scheduler


@dataclasses.dataclass
class Request:
    prompt: list          # token ids
    max_new_tokens: int = 16
    eos_id: int = -1      # -1: never stops early
    # Per-request sampling seed; None = the scheduler assigns the submission
    # index.  The j-th sampled token uses fold_in(fold_in(base, seed), j),
    # so identical (prompt, seed) pairs give identical streams.
    seed: int | None = None


def _has_global_attn(cfg) -> bool:
    kinds = tuple(cfg.prefix) + tuple(cfg.unit) + tuple(cfg.suffix)
    return any(k not in ("attn_local", "rglru", "mlstm", "slstm")
               for k in kinds)


class Engine:
    def __init__(self, cfg, params, *, cache_len: int, batch_size: int,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 top_p_candidates: int = 64, seed: int = 0,
                 max_new_cap: int | None = None, poison_on_evict: bool = False,
                 quantize_kv: str | None = None, strategy=None,
                 prefill_buckets=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cache_len = cache_len
        self.batch_size = batch_size
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.top_p_candidates = top_p_candidates
        self.max_new_cap = max_new_cap or cache_len
        self.poison_on_evict = poison_on_evict
        if quantize_kv == "fp8":              # spelling alias: default format
            quantize_kv = "fp8_e4m3"
        if quantize_kv is not None and quantize_kv not in alg.QUANT_MODES:
            raise ValueError(
                f"quantize_kv={quantize_kv!r} not in {alg.QUANT_MODES}")
        self.quantize_kv = quantize_kv
        self.strategy = ST.resolve_strategy(strategy)
        if cfg.is_encdec and self.strategy.name != "vanilla":
            raise NotImplementedError(
                f"strategy {self.strategy.name!r} requires the continuous "
                "decode loop; enc-dec archs route through the padded "
                "vanilla oracle only")
        self.prefill_buckets = self._resolve_buckets(prefill_buckets)
        self.params = pytree.tree_map(lambda t: t.to(self.device), params)
        self._base_key = SP.PRNGKey(seed, device=self.device)
        self._sample = functools.partial(
            SP.sample_tokens, temperature=temperature, top_k=top_k,
            top_p=top_p, top_p_candidates=top_p_candidates)
        self.strategy.bind(self)
        self._strategy_params = self.strategy.loop_params(self)
        self.last_stats: dict = {}
        self.last_scores = np.zeros((0,), np.float32)

    def _resolve_buckets(self, spec):
        """Normalize ``prefill_buckets`` to a sorted tuple (or None).

        ``"pow2"`` generates powers of two from 8 up to the cache budget
        (the budget itself last); an explicit sequence is validated against
        it.  Prompts longer than the largest bucket prefill at their exact
        length."""
        limit = self.cache_len - self.cfg.num_prefix_embeds
        if spec is None:
            return None
        if spec == "pow2":
            out, b = [], 8
            while b < limit:
                out.append(b)
                b *= 2
            out.append(limit)
            return tuple(out)
        buckets = sorted({int(b) for b in spec})
        if not buckets or buckets[0] < 1 or buckets[-1] > limit:
            raise ValueError(
                f"prefill_buckets={spec!r} must be nonempty ints in "
                f"[1, {limit}] (cache_len minus prefix embeds)")
        return tuple(buckets)

    def _pad_prompt(self, prompt):
        """Right-pad a prompt (pad token 0) to its bucket length.  Returns
        (toks (1, L) int64 on the device, valid_len | None); None =
        exact length (no bucketing, the prompt fills its bucket, or it
        exceeds the largest one)."""
        plen = len(prompt)
        toks, vlen = list(prompt), None
        for b in self.prefill_buckets or ():
            if b >= plen:
                toks += [0] * (b - plen)
                vlen = plen if b > plen else None
                break
        return torch.tensor([toks], dtype=torch.int64,
                            device=self.device), vlen

    def _make_batch(self, toks, valid_len=None) -> dict:
        """Prefill inputs: the tokens (B, S); for an encoder-decoder a zero
        float32 source ``src_embeds`` of (B, S, d_model), and for a config
        with prefix embeddings zero float32 ``vision_embeds`` of (B, P,
        d_model) (the reference engine's stand-ins for a frontend's
        output).  A zero source makes the encoder's output, and so every
        cross attention's, exactly zero: the encoder has no biases.
        ``valid_len`` (an int), where given: the tokens' valid length under
        bucketing."""
        cfg = self.cfg
        batch = {"tokens": toks}
        if valid_len is not None:
            batch["valid_len"] = valid_len
        if cfg.is_encdec:
            batch["src_embeds"] = torch.zeros(
                (*toks.shape, cfg.d_model), dtype=torch.float32,
                device=self.device)
        if cfg.num_prefix_embeds:
            batch["vision_embeds"] = torch.zeros(
                (toks.shape[0], cfg.num_prefix_embeds, cfg.d_model),
                dtype=torch.float32, device=self.device)
        return batch

    def _prefill(self, params, batch):
        return lm.prefill(params, self.cfg, batch["tokens"],
                          cache_len=self.cache_len,
                          src_embeds=batch.get("src_embeds"),
                          vision_embeds=batch.get("vision_embeds"),
                          valid_len=batch.get("valid_len"))

    def _decode(self, params, caches, toks, pos):
        return lm.decode_step(params, self.cfg, caches, toks, pos)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -----------------------------------------------------------------------
    # Continuous-batching path
    # -----------------------------------------------------------------------

    def _cache_zeros(self, batch: int | None = None):
        """Zeroed decode caches for ``batch`` rows (default: every slot), in
        the dtypes prefill produces (attention rings and conv tails in the
        activation dtype, recurrent states in float32).  Under
        ``quantize_kv`` every attention KV leaf is a ``KVQuant`` of zero
        codes and zero scales."""
        caches = lm.init_caches(self.cfg, batch or self.batch_size,
                                self.cache_len, self.cfg.activation_dtype,
                                self.device)
        if self.quantize_kv is not None:
            caches = pytree.tree_map(
                torch.zeros_like,
                CA.quantize_kv_tree(caches, mode=self.quantize_kv))
        return caches

    def _base_state(self) -> dict:
        """The standard device-resident state: caches + per-slot control
        arrays.  Strategies with richer state extend (or replace) it."""
        B, T = self.batch_size, self.max_new_cap

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return {
            "caches": self._cache_zeros(),
            "tok": zeros(B), "pos": zeros(B), "emitted": zeros(B),
            "active": zeros(B, dtype=torch.bool),
            "out": zeros(B, T), "logps": zeros(B, T, dtype=torch.float32),
            "seeds": zeros(B), "max_new": zeros(B),
            "eos": torch.full((B,), -1, dtype=torch.int32,
                              device=self.device),
        }

    def _fresh_state(self) -> dict:
        return self.strategy.init_state(self)

    def _admit_impl(self, state, caches1, logits1, extras, slot, seed,
                    max_new, eos, pos0):
        """Admission, delegated to the strategy; the first token stays on
        the device.  Under ``quantize_kv`` the prefilled caches are
        quantized before the scatter."""
        if self.quantize_kv is not None:
            caches1 = CA.quantize_kv_tree(caches1, mode=self.quantize_kv)
        return self.strategy.admit(
            self, state, caches1, logits1, extras, slot=slot, seed=seed,
            max_new=max_new, eos=eos, pos0=pos0)

    def _loop_impl(self, params, sparams, state, budget, *, stop_on_free):
        """The decode loop: run until every live slot is done (EOS or length
        cap), or ``budget`` steps have run (the scheduler bounds a dispatch
        at the next arrival event), or -- with ``stop_on_free`` (waiters are
        queued) -- as soon as any slot frees.  Returns (state, steps_run).

        The condition is computed on the device and read back once per
        step; that read is the loop's only host sync.
        """
        active0 = state["active"].clone()
        steps = 0
        while steps < budget:
            # All-done predicate as a commutative mapreduce over the active
            # flags -- the loop predicate runs on the primitive layer.
            go = forge.mapreduce(alg.IDENTITY, alg.MAX,
                                 state["active"].to(torch.int32),
                                 layout=Flat()) > 0
            if stop_on_free:
                go = go & torch.all(~active0 | state["active"])
            if not bool(go):
                break
            state = self.strategy.step(self, params, sparams, state)
            steps += 1
        return state, steps

    def _dispatch_loop(self, state, budget, stop_on_free):
        return self._loop_impl(self.params, self._strategy_params, state,
                               budget, stop_on_free=stop_on_free)

    def _validate_request(self, r: Request):
        plen = len(r.prompt) + self.cfg.num_prefix_embeds
        if plen > self.cache_len:
            raise ValueError(
                f"prompt ({plen} tokens incl. prefix) exceeds cache_len="
                f"{self.cache_len}")
        if r.max_new_tokens > self.max_new_cap:
            raise ValueError(
                f"max_new_tokens={r.max_new_tokens} exceeds the engine's "
                f"output buffer cap {self.max_new_cap} (raise max_new_cap)")
        if _has_global_attn(self.cfg) and \
                plen + r.max_new_tokens > self.cache_len:
            raise ValueError(
                f"prompt+max_new ({plen}+{r.max_new_tokens}) exceeds "
                f"cache_len={self.cache_len} for a global-attention arch "
                f"(the KV ring would overwrite live context)")

    def serve(self, arrivals) -> list:
        """Run an open-loop arrival trace to completion.

        ``arrivals``: iterable of ``(arrival_step, Request)`` (or bare
        ``Request``s, all arriving at step 0) on the decode-step clock (one
        step = one loop iteration; a speculative round may emit several
        tokens).
        Returns the scheduler's completed ``RequestState`` records in
        submission order (tokens, seq_logprob, submit/admit/finish steps).
        """
        if self.cfg.is_encdec:
            raise NotImplementedError(
                "continuous batching for enc-dec archs: cross-attention "
                "caches are source-length-shaped, which breaks uniform slot "
                "scatter -- use generate_padded()")
        pending = []
        for a in arrivals:
            step, req = a if isinstance(a, tuple) else (0, a)
            self._validate_request(req)
            pending.append((int(step), req))
        pending.sort(key=lambda a: a[0])
        pending = list(reversed(pending))   # pop() = earliest

        sched = Scheduler(self.batch_size)
        state = self._fresh_state()
        now = 0
        stats = {"loop_dispatches": 0, "decode_steps": 0, "prefill_s": 0.0,
                 "decode_s": 0.0, "admissions": 0}
        t_serve = time.perf_counter()

        def submit_due():
            while pending and pending[-1][0] <= now:
                step, req = pending.pop()
                sched.submit(req, step=max(step, now))

        submit_due()
        while not (sched.all_done and not pending):
            # -- admission: prefill each new request alone, scatter its cache
            for rec in sched.admit(step=now):
                r = rec.request
                if r.max_new_tokens < 1:
                    sched.complete(rec.slot, step=now)
                    continue
                t0 = time.perf_counter()
                toks, vlen = self._pad_prompt(r.prompt)
                logits1, caches1 = self._prefill(
                    self.params, self._make_batch(toks, valid_len=vlen))
                extras = self.strategy.host_prefill(self, toks, vlen)
                pos0 = len(r.prompt) + self.cfg.num_prefix_embeds
                state = self._admit_impl(
                    state, caches1, logits1, extras, rec.slot, rec.seed,
                    r.max_new_tokens, r.eos_id, pos0)
                self._sync()
                stats["prefill_s"] += time.perf_counter() - t0
                stats["admissions"] += 1

            live = sched.live_slots
            if not live:
                if pending:
                    now = max(now, pending[-1][0])
                    submit_due()
                    continue
                break
            # An admitted request may be done already (EOS/cap on its first
            # token); drain before dispatching an empty loop.
            state = self._drain_done(sched, state, now)
            if not sched.live_slots:
                submit_due()
                continue

            # -- one decode-loop dispatch: run until all-done, bounded by the
            # next arrival event; break out early on a freed slot only when
            # someone is waiting for it.
            budget = int((state["max_new"] - state["emitted"]).max()) + 1
            if pending:
                budget = max(1, min(budget, pending[-1][0] - now))
            stop_on_free = sched.has_waiting or bool(pending)
            t0 = time.perf_counter()
            state, steps = self._dispatch_loop(state, budget, stop_on_free)
            stats["decode_s"] += time.perf_counter() - t0
            stats["loop_dispatches"] += 1
            stats["decode_steps"] += steps
            now += steps
            submit_due()
            state = self._drain_done(sched, state, now)

        recs = [sched.records[rid] for rid in sorted(sched.records)]
        stats["serve_s"] = time.perf_counter() - t_serve
        n_tok = sum(len(rec.tokens) for rec in recs)
        stats["decode_tok_per_s"] = n_tok / max(stats["decode_s"], 1e-9)
        stats["seq_logprob"] = [rec.seq_logprob for rec in recs]
        stats["total_tokens"] = n_tok
        stats["final_step"] = now
        stats.update(self.strategy.stats(self, state))
        self.last_stats = stats
        self.last_scores = np.asarray(
            [rec.seq_logprob for rec in recs], np.float32)
        return recs

    def _drain_done(self, sched: Scheduler, state, now):
        """Evict finished slots: pull their ragged outputs (the only token
        read-back, at completion) through the CSR compaction descriptor,
        copy the strategy's per-slot ``meta`` onto each record, and with
        ``poison_on_evict`` poison each freed slot's caches."""
        active = state["active"].cpu()
        done_slots = [s for s in sched.live_slots if not bool(active[s])]
        if not done_slots:
            return state
        outs = self.strategy.outputs(self, state)
        flat, offsets = CA.compact_ragged(outs["out"], outs["emitted"])
        flat, offsets = flat.cpu(), offsets.cpu()
        seq_lp = outs["seq_logprob"].cpu()
        meta = {key: v.cpu() for key, v in outs.get("meta", {}).items()}
        for slot in done_slots:
            rec = sched.complete(slot, step=now)
            rec.tokens = [int(t) for t in flat[offsets[slot]:offsets[slot + 1]]]
            rec.seq_logprob = float(seq_lp[slot])
            for key, per_slot in meta.items():
                rec.meta[key] = per_slot[slot].item()
            if self.poison_on_evict:
                state = dict(state)
                state["caches"] = self.strategy.poison(
                    self, state["caches"], slot)
        return state

    def generate(self, requests: list) -> list:
        """Run requests to completion (continuous batching); token lists in
        input order.  More requests than ``batch_size`` simply queue.  An
        encoder-decoder runs on the padded path, ``batch_size`` requests at
        a time in input order, a request without a seed taking its index
        in ``requests`` as the continuous path's do (the reference's padded
        path takes at most ``batch_size``); ``last_scores`` and
        ``last_stats`` then cover every batch."""
        if not self.cfg.is_encdec:
            recs = self.serve([(0, r) for r in requests])
            return [rec.tokens for rec in recs]
        B = self.batch_size
        outs, stats = [], {"prefill_s": 0.0, "decode_s": 0.0,
                           "seq_logprob": []}
        for first in range(0, len(requests), B):
            batch = [r if r.seed is not None else
                     dataclasses.replace(r, seed=first + i)
                     for i, r in enumerate(requests[first:first + B])]
            outs += self.generate_padded(batch)
            for key in stats:
                stats[key] += self.last_stats[key]
        n_tok = sum(len(o) for o in outs)
        stats["decode_tok_per_s"] = n_tok / max(stats["decode_s"], 1e-9)
        self.last_stats = stats
        self.last_scores = np.asarray(stats["seq_logprob"], np.float32)
        return outs

    # -----------------------------------------------------------------------
    # Padded-batch path (the vanilla parity oracle)
    # -----------------------------------------------------------------------

    def generate_padded(self, requests: list) -> list:
        """Fixed-batch path: pad to ``batch_size``, left-pad the prompts to
        the longest (pad token 0, attended as in the reference), one
        prefill, then one decode step at one position for the whole batch
        and one host read of its tokens a step.  The differential oracle of
        vanilla sampling:
        the same seeds give the continuous path's tokens.  Request ``i``
        without a seed takes seed ``i``.  ``last_scores`` holds each
        request's summed log-probabilities, one batched masked mapreduce
        over (requests, steps) (K7m on the card).  Non-vanilla strategies
        have their own reference decoders (``strategies/ref.py``) and
        refuse this path."""
        if self.strategy.name != "vanilla":
            raise NotImplementedError(
                "generate_padded is the vanilla-sampling parity oracle; "
                f"strategy {self.strategy.name!r} has its own reference "
                "decoder in serving/strategies/ref.py")
        cfg = self.cfg
        B = self.batch_size
        n_req = len(requests)
        if not 1 <= n_req <= B:
            raise ValueError(f"generate_padded takes 1 to batch_size={B} "
                             f"requests, got {n_req}")
        dev = self.device
        seeds = np.arange(B, dtype=np.int32)
        for i, r in enumerate(requests):
            if r.seed is not None:
                seeds[i] = r.seed
        seeds = torch.from_numpy(seeds).to(dev)
        plen = max(len(r.prompt) for r in requests)
        toks = np.zeros((B, plen), np.int64)
        for i, r in enumerate(requests):
            toks[i, plen - len(r.prompt):] = r.prompt       # left-pad
        batch = self._make_batch(torch.from_numpy(toks).to(dev))

        t0 = time.perf_counter()
        logits, caches = self._prefill(self.params, batch)
        self._sync()
        prefill_s = time.perf_counter() - t0

        max_new = max(r.max_new_tokens for r in requests)
        outputs = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        tok = self._sample(self._base_key, logits, seeds,
                           torch.zeros((B,), dtype=torch.int32, device=dev))
        tok_h = tok.cpu().numpy()
        step_logps = [SP.chosen_logprobs(logits, tok)]     # stays on device
        pos0 = plen + cfg.num_prefix_embeds
        t1 = time.perf_counter()
        for i, r in enumerate(requests):
            # The first token: the same cap / EOS bookkeeping as every later
            # one (a 0-budget request emits nothing; EOS first finishes it).
            if r.max_new_tokens >= 1:
                outputs[i].append(int(tok_h[i]))
            if len(outputs[i]) >= r.max_new_tokens or \
                    (outputs[i] and outputs[i][-1] == r.eos_id):
                done[i] = True
        for t in range(1, max_new):
            if done[:n_req].all():
                break
            logits, caches = self._decode(self.params, caches, tok[:, None],
                                          pos0 + t - 1)
            tok = self._sample(self._base_key, logits, seeds,
                               torch.full((B,), t, dtype=torch.int32,
                                          device=dev))
            tok_h = tok.cpu().numpy()
            step_logps.append(SP.chosen_logprobs(logits, tok))
            for i, r in enumerate(requests):
                if not done[i] and len(outputs[i]) < r.max_new_tokens:
                    outputs[i].append(int(tok_h[i]))
                    if outputs[i][-1] == r.eos_id or \
                            len(outputs[i]) >= r.max_new_tokens:
                        done[i] = True
        decode_s = time.perf_counter() - t1
        n_tok = sum(len(o) for o in outputs[:n_req])

        # One masked row a request over (n_req, steps): one launch, the
        # same call for one request or a full batch.
        lengths = torch.tensor([len(o) for o in outputs[:n_req]],
                               dtype=torch.int32, device=dev)
        lp = torch.stack(step_logps, dim=1)[:n_req].float()
        self.last_scores = SP.masked_seq_logprobs(lp, lengths).cpu().numpy()
        self.last_stats = {
            "prefill_s": prefill_s,
            "decode_s": decode_s,
            "decode_tok_per_s": n_tok / max(decode_s, 1e-9),
            "seq_logprob": self.last_scores.tolist(),
        }
        return outputs[:n_req]
