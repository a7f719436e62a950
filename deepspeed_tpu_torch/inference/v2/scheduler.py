"""Continuous-batching scheduler (Dynamic SplitFuse).

Capability match for the scheduling policy the reference ships in
DeepSpeed-MII on top of ``InferenceEngineV2`` (and described in the
DeepSpeed-FastGen paper): every engine step carries a fixed token
budget; running (decode) sequences get one token each first, and the
remaining budget is filled with chunks of pending prompts — long
prompts are SPLIT across steps, decodes are FUSED into prefill steps,
so step latency stays flat and the MXU stays fed.

Port: a copy of ``deepspeed_tpu/inference/v2/scheduler.py``. Greedy and
sampled decoding on the device (``sampling=`` for every request, or a
per-request ``sample``), a host ``sample_fn``, speculative verify bursts
(when the engine's ``spec`` is on) and schema-constrained requests
(``add_request(schema=)``, when the engine's ``structured`` is on; such a
batch takes plain bursts, never a verify) work, and so do pipelined
bursts (when the engine's ``async_burst`` is on): ``_try_async_start``
and ``_continue_pipeline`` dispatch chained bursts and fence one burst
late, EOS found at a fence finishes the request, and ``_drain_pipeline``
rewinds the dispatched tail and flushes when the chain breaks."""

from collections import OrderedDict, deque

import numpy as np

from deepspeed_tpu_torch.inference.sampling import validate_sample_spec


class Request:

    def __init__(self, uid, prompt_tokens, max_new_tokens, priority=0, spec=True,
                 adapter_id=None, sample=None, schema=None):
        self.uid = uid
        self.prompt = list(np.atleast_1d(np.asarray(prompt_tokens)).tolist())
        self.max_new_tokens = max_new_tokens
        self.priority = int(priority)  # larger = scheduled first
        # multi-tenant LoRA: which adapter serves this request (None =
        # base model); bound to a hot slot at admission
        self.adapter_id = adapter_id
        # per-request sampling spec (None = the scheduler-wide default):
        # rides the packed batch as data, so mixed specs share programs
        self.sample = dict(sample) if sample else None
        # per-request decode constraint (a CompiledSchema bound to the
        # engine's StructuredStore at admission); None = unconstrained
        self.schema = schema
        # per-request speculative-decoding opt-out: False rides along in
        # verify bursts without drafts of its own (engine-level spec
        # support still decides whether drafting happens at all)
        self.spec = bool(spec)
        self.prefill_cursor = 0  # prompt tokens already scheduled
        # radix prefix cache: leading prompt tokens whose KV was reused
        # from the cache (prefill skips them — the cursor starts there)
        self.prefix_cached_tokens = 0
        self.prefix_checked = False
        self.generated = []
        self.next_token = None  # decode token awaiting scheduling
        # pipelined (async) bursts: tokens dispatched to the device but
        # not yet fenced/accepted — ``len(generated) + _inflight`` is the
        # request's true generation frontier while bursts are in flight
        self._inflight = 0
        self.done = False
        # paused requests hold scheduler state but take no step work —
        # their KV may be suspended to host (gateway preemption)
        self.paused = False

    @property
    def prefilling(self):
        return self.prefill_cursor < len(self.prompt)


class DynamicSplitFuseScheduler:
    """Drives an :class:`InferenceEngineV2` to completion over a request
    stream. ``sample_fn(logits) -> token`` picks the next token
    (default greedy argmax); generation stops at ``eos_token_id`` or
    ``max_new_tokens``."""

    def __init__(self, engine, token_budget=None, sample_fn=None, eos_token_id=None,
                 max_burst=16, sampling=None, on_token=None):
        self.engine = engine
        self.budget = int(token_budget or engine.max_tokens)
        if self.budget > engine.max_tokens:
            raise ValueError(f"budget {self.budget} > engine max_tokens {engine.max_tokens}")
        # default greedy sampling runs ON DEVICE (engine.put sample="greedy"):
        # one int32 per sequence crosses to the host instead of a vocab-wide
        # logits row. A custom sample_fn needs the logits, so it opts out.
        if sampling is not None and sample_fn is not None:
            raise ValueError("pass either sampling (on-device) or sample_fn (host), not both")
        # sampling: {"temperature": t, "top_k": k, "top_p": p} → stochastic
        # sampling ON DEVICE (put(sample=dict) / sampling bursts); None with
        # no sample_fn → on-device greedy. Both keep vocab-wide logits off
        # the host; a custom sample_fn opts out of both.
        # normalize {} to None: an empty dict would mean greedy on one
        # path and unfiltered T=1.0 sampling on the other
        self._sampling = dict(sampling) if sampling else None
        if self._sampling is not None:
            validate_sample_spec(self._sampling)
        self._device_greedy = sample_fn is None
        # multi-step decode: when every live request is decoding, run up
        # to max_burst steps in one compiled program (on-device sampled
        # tokens feed the next step) — one host sync per burst instead of
        # per token. 1 disables bursting. Only for device-side sampling:
        # a custom sample_fn needs each step's logits on the host.
        self.max_burst = max(1, int(max_burst)) if self._device_greedy else 1
        self.sample_fn = sample_fn or (lambda logits: int(np.argmax(logits)))
        self.eos_token_id = eos_token_id
        # on_token(uid, token, done): called for every accepted token —
        # the serving gateway's streaming hook. None = no streaming.
        self.on_token = on_token
        self.requests = OrderedDict()  # uid -> Request
        # pipelined bursts (DS_ASYNC_BURST): the pump dispatches burst
        # k+1 while burst k executes on device and fences one burst
        # late. Only meaningful for on-device sampling with bursting on;
        # the off state never touches the pipeline — step() runs the
        # exact pre-pipeline loop.
        self.async_burst = bool(getattr(engine, "async_burst", False)) \
            and self._device_greedy and self.max_burst >= 2
        self.async_depth = max(1, int(getattr(engine, "async_burst_depth", 2)))
        self._pipeline = deque()  # (AsyncBurstHandle, [Request]) oldest first

    def add_request(self, uid, prompt_tokens, max_new_tokens=16, priority=0,
                    spec=True, adapter_id=None, sample=None, schema=None):
        if uid in self.requests:
            raise ValueError(f"uid {uid} already queued")
        if sample is not None:
            validate_sample_spec(sample)  # typed, pre-admission
            sample = dict(sample)
            if "seed" not in sample:
                # resolve the seed AT ADMISSION from the engine's
                # deterministic stream: the emitted tokens then depend
                # only on (seed, position), never on how later
                # scheduling interleaves this request with others
                draw = getattr(self.engine, "draw_seed", None)
                if draw is not None:
                    sample["seed"] = draw()
        if schema is not None and sample is None and not self._device_greedy:
            raise ValueError(f"uid {uid}: schema-constrained requests sample "
                             f"on device; host sample_fn cannot enforce the "
                             f"constraint")
        req = Request(uid, prompt_tokens, max_new_tokens, priority=priority,
                      spec=spec, adapter_id=adapter_id, sample=sample,
                      schema=schema)
        if not req.prompt:
            raise ValueError(f"uid {uid}: empty prompt can never be scheduled")
        if schema is not None:
            # bind BEFORE queueing, same discipline as adapters: schema
            # compile/capacity errors surface typed at admission
            bind = getattr(self.engine, "bind_schema", None)
            if bind is None or getattr(self.engine, "structured", None) is None:
                raise ValueError(f"uid {uid}: schema given but constrained "
                                 f"decoding is disabled (config.structured / "
                                 f"DS_CONSTRAINED)")
            bind(uid, schema)
        if adapter_id:
            # bind BEFORE queueing: a cold adapter promotes (or raises
            # typed capacity/unknown errors) here, not mid-step — and the
            # lease guarantees the slot survives until the engine flush
            bind = getattr(self.engine, "bind_adapter", None)
            if bind is None:
                raise ValueError(f"uid {uid}: adapter_id={adapter_id} but the "
                                 f"engine has no adapter support")
            bind(uid, adapter_id)
        self.requests[uid] = req
        # KV-tier prefetch kick: stage any demoted prefix extension for
        # this prompt off-thread NOW, so the host→device copy overlaps
        # the wait until _plan first schedules the request
        prefetch = getattr(self.engine, "prefetch_prefix", None)
        if prefetch is not None:
            prefetch(req.prompt)
        return req

    @property
    def has_work(self):
        return any(not r.done for r in self.requests.values())

    def _live(self):
        """Schedulable requests, highest priority first (stable: equal
        priorities keep arrival order). Paused requests hold their state
        but take no step work."""
        live = [r for r in self.requests.values() if not r.done and not r.paused]
        return sorted(live, key=lambda r: -r.priority)

    def cancel(self, uid):
        """Stop a request now: mark done, release its engine state (live
        KV or suspended host copy). Returns the tokens generated so far."""
        r = self.requests.get(uid)
        if r is None:
            raise KeyError(f"unknown request {uid}")
        self._drain_if_inflight(r)
        if not r.done:
            r.done = True
            r.next_token = None
            try:
                self.engine.flush(uid)
            except KeyError:
                pass  # nothing prefilled yet — no engine state to drop
        return list(r.generated)

    def retire(self, uid):
        """Remove a finished request from the table (long-running serving
        must not grow the request dict without bound)."""
        r = self.requests.get(uid)
        if r is None:
            raise KeyError(f"unknown request {uid}")
        if not r.done:
            raise ValueError(f"request {uid} is still live — cancel() first")
        del self.requests[uid]
        return r

    def pause(self, uid):
        """Preempt a live request: suspend its KV to host memory (freeing
        pool blocks for other sequences) and stop scheduling it until
        :meth:`unpause`. Returns True when KV was actually offloaded
        (False for a request that never reached the engine)."""
        r = self.requests.get(uid)
        if r is None:
            raise KeyError(f"unknown request {uid}")
        if r.done or r.paused:
            raise ValueError(f"request {uid} is not pausable (done={r.done})")
        self._drain_if_inflight(r)
        if r.done:
            raise ValueError(f"request {uid} finished while its pipelined "
                             f"bursts drained — not pausable")
        r.paused = True
        if self.engine.query(uid) is not None:
            self.engine.suspend(uid)
            return True
        return False

    def unpause(self, uid):
        """Resume a paused request; restores suspended KV (needs pool
        room — caller checks ``engine.suspended_blocks(uid)`` first)."""
        r = self.requests.get(uid)
        if r is None:
            raise KeyError(f"unknown request {uid}")
        if not r.paused:
            raise ValueError(f"request {uid} is not paused")
        if self.engine.is_suspended(uid):
            self.engine.resume(uid)
        r.paused = False

    def _plan(self):
        """One step's (uids, token-chunks) within the budget: decodes
        first, then prompt chunks (splitting long prompts)."""
        uids, chunks = [], []
        budget = self.budget
        max_seqs = self.engine.max_seqs
        live = self._live()
        # 1) decodes: one token each
        for r in live:
            if r.next_token is not None and budget > 0 and len(uids) < max_seqs:
                uids.append(r.uid)
                chunks.append([r.next_token])
                r.next_token = None
                budget -= 1
        # 2) prefills: fill the remaining budget with prompt chunks
        for r in live:
            if budget <= 0 or len(uids) >= max_seqs:
                break
            if r.prefilling and r.uid not in uids:
                if not r.prefix_checked:
                    # first time this request is scheduled: ask the engine
                    # for its longest cached prompt prefix — prefill then
                    # starts at the first uncached token (batch positions
                    # follow the descriptor's seen_tokens automatically)
                    r.prefix_checked = True
                    match = getattr(self.engine, "prefix_match", None)
                    if match is not None and r.prefill_cursor == 0:
                        r.prefix_cached_tokens = int(match(r.uid, r.prompt))
                        r.prefill_cursor = r.prefix_cached_tokens
                take = min(budget, len(r.prompt) - r.prefill_cursor)
                chunk = r.prompt[r.prefill_cursor:r.prefill_cursor + take]
                r.prefill_cursor += take
                uids.append(r.uid)
                chunks.append(chunk)
                budget -= take
        return uids, chunks

    def _try_burst(self):
        """All live requests decoding → run a k-step decode burst; None
        when the burst path doesn't apply this round."""
        live = self._live()
        if (self.max_burst < 2 or not live or len(live) > self.engine.max_seqs
                or len(live) > self.budget  # burst must respect the per-step
                # token budget too: one decode token per live request per
                # burst step, same bound _plan enforces
                or any(r.next_token is None for r in live)):
            return None
        k = min(self.max_burst,
                min(r.max_new_tokens - len(r.generated) for r in live),
                min(self.engine.max_ctx_tokens - self.engine.query(r.uid)[0]
                    for r in live))
        if k < 2:
            return None
        k = 1 << (k.bit_length() - 1)  # power-of-two bursts: each distinct
        # k compiles its own scan program, so an arbitrary tail (15, 14,
        # 13...) would compile once per value; rounding down bounds the
        # set to log2(max_burst) programs
        uids = [r.uid for r in live]
        if not self.engine.can_burst(uids, k):
            # KV pool too tight to reserve k tokens per sequence up
            # front. The stepwise path needs at most one block per
            # sequence per step and EOS flushes free blocks between
            # steps, so fall back. (A pre-check, not try/except: a
            # failure inside the compiled burst would land after state
            # mutation + KV donation and is not recoverable.)
            return None
        toks = self.engine.decode_burst(uids, [r.next_token for r in live], k,
                                        sample=self._sample_arg(live))
        for r in live:
            r.next_token = None
        for step_i in range(k):
            for j, r in enumerate(live):
                if r.done:
                    continue  # hit EOS mid-burst; later rows are discarded
                # the burst advanced KV by all k tokens; if generation
                # ends HERE, positions past entry + the first step_i
                # outputs hold post-EOS garbage the rewind reclaims
                self._accept_token(r, int(toks[step_i, j]),
                                   unused_tokens=k - step_i - 1)
        return uids

    def _spec_of(self, r):
        """The sampling spec governing request ``r``: its own, else the
        scheduler-wide default; None = greedy."""
        return r.sample if r.sample is not None else self._sampling

    def _sample_arg(self, live):
        """The engine ``sample=`` argument for a batch over ``live``:
        per-row specs when any row samples (mixed greedy rows stay
        ``None`` — the packed program argmaxes them), else None for the
        plain greedy program."""
        specs = [self._spec_of(r) for r in live]
        return specs if any(s is not None for s in specs) else None

    def _try_spec_burst(self):
        """All live requests decoding on device on an engine with
        speculative decoding armed → draft with the n-gram drafter and
        score entry + drafts in ONE compiled verify forward — greedy
        acceptance under greedy decoding, rejection-sampled acceptance
        under per-sequence sampling (bit-identical to the spec-off
        stream either way); None when the speculative path doesn't
        apply this round (no drafts found, a schema-bound request in
        the batch, budget too tight…) — the plain k-step burst then
        gets its chance."""
        engine = self.engine
        spec = getattr(engine, "spec", None)
        if spec is None or not self._device_greedy:
            return None
        live = self._live()
        if (not live or len(live) > engine.max_seqs
                or any(r.next_token is None for r in live)
                # constrained sequences never verify: their drafts were
                # proposed without the DFA mask
                or any(r.schema is not None for r in live)):
            return None
        n = len(live)
        # each sequence enters the verify batch as a (d+1)-token chunk,
        # so the shared d is bounded by the per-step token budget…
        d_cap = self.budget // n - 1
        # …and by context room for EVERY live sequence: all rows write
        # d+1 KV positions regardless of their own draft count
        for r in live:
            d_cap = min(d_cap, engine.max_ctx_tokens
                        - engine.query(r.uid)[0] - 1)
        if d_cap < 1:
            return None
        max_lens = [min(d_cap, r.max_new_tokens - len(r.generated) - 1)
                    if r.spec else 0 for r in live]
        uids = [r.uid for r in live]
        drafts = engine.propose_drafts(uids, [[r.next_token] for r in live],
                                       max_lens)
        d = max((len(dr) for dr in drafts), default=0)
        if d < 1:
            return None
        # pad the shared draft length up to a power of two (within the
        # caps): dlen masks the padding, so acceptance is unchanged, and
        # the verify-program set stays log2-bounded instead of compiling
        # once per distinct max-draft-length the drafter happens to find
        d = min(1 << (d - 1).bit_length(), d_cap)
        if not engine.can_burst(uids, d + 1):
            return None  # pool too tight: fall back (see _try_burst)
        toks, acc = engine.verify_burst(uids, [[r.next_token] for r in live],
                                        drafts, sample=self._sample_arg(live))
        for r in live:
            r.next_token = None
        for j, r in enumerate(live):
            a = int(acc[j])
            for e in range(a + 1):
                if r.done:
                    break  # EOS among the accepted run; rest discarded
                # the verify advanced KV by a+1; ending at emitted index
                # e leaves a-e post-EOS tokens for the rewind to reclaim
                self._accept_token(r, int(toks[j, e]), unused_tokens=a - e)
        return uids

    def _accept_token(self, r, tok, unused_tokens=0):
        """Record a generated token; finish + flush on EOS/max_new_tokens
        (single copy of the completion semantics for the stepwise, burst
        and speculative paths). ``unused_tokens``: KV positions the
        engine advanced past this token (burst/verify reservations run
        to their planned end); on completion they are rewound first so
        retire frees them — and the prefix cache never content-addresses
        post-EOS garbage."""
        r.generated.append(tok)
        if r.schema is not None:
            # the authoritative host DFA advances ONLY for accepted
            # tokens — burst tails discarded after EOS/max_new never
            # touch it, so the state the next batch packs stays right
            self.engine.advance_schema(r.uid, tok)
        if (self.eos_token_id is not None and tok == self.eos_token_id) \
                or len(r.generated) >= r.max_new_tokens:
            r.done = True
            if unused_tokens:
                self.engine.rewind(r.uid, unused_tokens)
            self.engine.flush(r.uid)
        else:
            r.next_token = tok
        if self.on_token is not None:
            self.on_token(r.uid, tok, r.done)

    # ---------------------------------------------- pipelined (async) bursts
    def _drain_if_inflight(self, r):
        """Settle the whole pipeline when ``r`` has unfenced bursts in
        it (cancel/pause must observe the request's final state)."""
        if r._inflight:
            self._drain_pipeline()

    def _plan_async_k(self, rows):
        """Burst length for the next pipeline link, or None when the
        burst path no longer applies. Mirrors :meth:`_try_burst`'s k
        computation exactly, with ``_inflight`` standing in for the
        not-yet-fenced generated tokens (the engine's ``seen_tokens``
        already advanced at dispatch, so the context-room term needs no
        correction)."""
        if len(rows) > self.budget or len(rows) > self.engine.max_seqs:
            return None
        k = min(self.max_burst,
                min(r.max_new_tokens - len(r.generated) - r._inflight
                    for r in rows),
                min(self.engine.max_ctx_tokens - self.engine.query(r.uid)[0]
                    for r in rows))
        if k < 2:
            return None
        return 1 << (k.bit_length() - 1)  # power-of-two, see _try_burst

    def _accept_async(self, r, tok):
        """Fence-time accept: exactly :meth:`_accept_token` minus the
        completion-side engine work (rewind/flush), which MUST wait for
        the full pipeline drain — younger bursts are still executing
        over this sequence's KV reservation."""
        r._inflight -= 1
        r.generated.append(tok)
        if r.schema is not None:
            self.engine.advance_schema(r.uid, tok)
        if (self.eos_token_id is not None and tok == self.eos_token_id) \
                or len(r.generated) >= r.max_new_tokens:
            r.done = True
            r.next_token = None
        else:
            r.next_token = tok
        if self.on_token is not None:
            self.on_token(r.uid, tok, r.done)

    def _fence_one(self):
        """Fence the OLDEST in-flight burst (the one device→host copy it
        ever pays) and accept its tokens; post-EOS rows skip the tail —
        their ``_inflight`` debt is rewound at drain time."""
        handle, rows = self._pipeline.popleft()
        toks = handle.fetch()
        for step_i in range(handle.k):
            for j, r in enumerate(rows):
                if r.done:
                    continue  # finished mid-pipeline; tail is debt
                self._accept_async(r, int(toks[step_i, j]))
        return [r.uid for r in rows]

    def _drain_pipeline(self):
        """Fence every in-flight burst in dispatch order, then settle
        finished rows: rewind the speculatively-dispatched tail
        (``_inflight`` debt — KV positions past EOS/max_new) and flush,
        matching what the sync paths do per-burst at accept time."""
        uids = []
        settled = []
        while self._pipeline:
            _, rows = self._pipeline[0]
            uids = self._fence_one()
            for r in rows:
                if r not in settled:
                    settled.append(r)
        for r in settled:
            if r.done:
                if r._inflight:
                    self.engine.rewind(r.uid, r._inflight)
                    r._inflight = 0
                self.engine.flush(r.uid)
        return uids

    def _pipeline_rows(self):
        return self._pipeline[-1][1]

    def _continue_pipeline(self):
        """Pipeline non-empty: dispatch the next chained burst (host
        packs while the device runs), then fence one burst late. Any
        condition that breaks the chain — live set changed, tail too
        short, pool too tight, a fenced row finished — drains."""
        rows = self._pipeline_rows()
        live = self._live()
        chainable = live == rows and not any(r.done for r in rows)
        k = self._plan_async_k(rows) if chainable else None
        uids = [r.uid for r in rows]
        if k is None or not self.engine.can_burst(uids, k):
            return self._drain_pipeline()
        handle = self.engine.decode_burst_async(
            uids, None, k, sample=self._sample_arg(rows),
            prev=self._pipeline[-1][0])
        for r in rows:
            r._inflight += k
        self._pipeline.append((handle, rows))
        if len(self._pipeline) > self.async_depth:
            self._fence_one()
            if any(r.done for r in rows):
                self._drain_pipeline()  # EOS discovered one burst late
        return uids

    def _try_async_start(self):
        """Pipeline cold start: same applicability test as
        :meth:`_try_burst`, but the burst is dispatched WITHOUT a fetch
        — the fence lands ``async_depth`` bursts later."""
        live = self._live()
        if (not live or len(live) > self.engine.max_seqs
                or len(live) > self.budget
                or any(r.next_token is None for r in live)):
            return None
        k = self._plan_async_k(live)
        if k is None:
            return None
        uids = [r.uid for r in live]
        if not self.engine.can_burst(uids, k):
            return None  # tight pool: fall back, see _try_burst
        handle = self.engine.decode_burst_async(
            uids, [[r.next_token] for r in live], k,
            sample=self._sample_arg(live))
        for r in live:
            r.next_token = None
            r._inflight += k
        self._pipeline.append((handle, live))
        return uids

    def step(self):
        """Schedule + run one engine step; returns the uids stepped."""
        if self.async_burst and self._pipeline:
            # in-flight bursts continue (or drain) before anything else
            # — spec/stepwise paths need the fenced host state
            return self._continue_pipeline()
        stepped = self._try_spec_burst()
        if stepped is not None:
            return stepped
        if self.async_burst:
            stepped = self._try_async_start()
            if stepped is not None:
                return stepped
        burst = self._try_burst()
        if burst is not None:
            return burst
        uids, chunks = self._plan()
        if not uids:
            return []
        if self._device_greedy:
            rows = [self.requests[u] for u in uids]
            out = self.engine.put(uids, chunks,
                                  sample=self._sample_arg(rows) or "greedy")
        else:
            out = self.engine.put(uids, chunks)
        for uid, row in zip(uids, out):
            r = self.requests[uid]
            if r.prefilling:
                continue  # mid-prompt chunk: its last-token logits are unused
            self._accept_token(r, int(row) if self._device_greedy else self.sample_fn(row))
        return uids

    def run_to_completion(self, max_steps=10000):
        """→ {uid: generated tokens} after all requests finish."""
        steps = 0
        while self.has_work:
            stepped = self.step()
            steps += 1
            if steps > max_steps or (not stepped and self.has_work):
                raise RuntimeError("scheduler stalled")
        return {uid: list(r.generated) for uid, r in self.requests.items()}
