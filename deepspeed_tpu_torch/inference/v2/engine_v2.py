"""InferenceEngineV2: ragged (continuous-batching) serving engine.

Port of ``deepspeed_tpu/inference/v2/engine_v2.py`` for greedy serving
of Llama-family models, dense or MoE (dropless top-k), with bf16 weights
or weight-only quantized ones (``quantization.quantization_mode`` of
``"int8"``, ``"fp8"`` or ``"fp6"``: grouped carriers that the fused
kernels consume in place): ``put`` runs one ragged batch (mixed
prefill chunks and decodes, the Dynamic SplitFuse model) and returns
last-token logits or on-device greedy tokens; ``decode_burst`` runs
``k`` greedy decode steps with the argmax staying on the device and one
device→host copy per burst; ``flush``/``query``/``rewind`` manage
sequence state. The batch metadata crosses host→device as one packed
int32 vector per step (per burst for ``decode_burst``), byte-identical
to the JAX engine's.

Multi-tenant LoRA (``lora.enabled``): an :class:`AdapterStore` holds the
hot adapter slabs on the engine's device; ``register_adapter`` installs
an adapter in the host tier, ``bind_adapter`` (the scheduler calls it at
``add_request(adapter_id=)``) leases its hot slot to a sequence, every
batch re-resolves each sequence's slot into the adapter row of the packed
vector, and ``flush`` drops the lease. Off, nothing changes: the wire
format and the forward are the pre-LoRA ones. The adapter disk tier
(``publish_root``, ``adopt_adapter``) raises.

Features outside this slice raise ``NotImplementedError`` at
construction (:func:`unported_features`), as does a sampled ``sample=``
at call time. The ``DS_*`` environment kill switches are not read."""

import numpy as np
import torch

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.inference.quantization.quantization import (QuantizedWeight,
                                                                     quantize_params_tree,
                                                                     quantized_bytes)
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.model_runner import ragged_forward, rope_tables
from deepspeed_tpu_torch.inference.v2.modules.heuristics import instantiate_attn
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import NULL_BLOCK, BlockedKVCache
from deepspeed_tpu_torch.inference.v2.ragged.ragged_manager import DSStateManager
from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import (RaggedBatchWrapper,
                                                                    unpack_batch)
from deepspeed_tpu_torch.models.llama import (check_servable, init_params,
                                              init_quantized_params, llama_config)
from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import SCHEMES
from deepspeed_tpu_torch.serving.lora import (AdapterStore, lora_hot_set, lora_max_rank,
                                             lora_serving_enabled)
from deepspeed_tpu_torch.utils.logging import logger

_QUEUE4 = "ROADMAP.md, port queue item 4 (serving features on the ragged engine)"
_QUEUE5 = "ROADMAP.md, port queue item 5 (tensor- and expert-parallel serving)"


def unported_features(config):
    """→ [(feature, roadmap item)] the config turns on that the port
    does not serve yet."""
    out = []
    for name in ("prefix_cache", "kv_tier", "spec_decode", "structured", "async_burst"):
        if getattr(config, name).enabled:
            out.append((name, _QUEUE4))
    if config.lora.enabled and config.lora.publish_root:
        out.append(("lora.publish_root (the adapter disk tier)", _QUEUE4))
    for name in ("tensor_parallel_degree", "expert_parallel_degree"):
        if int(getattr(config, name)) > 1:
            out.append((f"{name}={getattr(config, name)}", _QUEUE5))
    return out


def _burst_layout(ms, mb, lora=False):
    """Wire format of the greedy decode-burst metadata vector: field →
    (start, end) offsets into the flat int32 vector (the JAX engine's
    ``_burst_layout`` with sampling and async entry off). ``lora``
    appends the per-sequence adapter-slot row."""
    fields = [("tokens0", ms), ("token_seq", ms), ("pos0", ms), ("tables", (ms + 1) * mb)]
    if lora:
        fields.append(("seq_adapters", ms + 1))
    o, lay = 0, {}
    for name, size in fields:
        lay[name] = (o, o + size)
        o += size
    return lay


class InferenceEngineV2:

    def __init__(self, model_config="debug", config: RaggedInferenceEngineConfig = None,
                 params=None, dtype=torch.bfloat16, device=None, generator=None):
        """``model_config``: a ``LlamaConfig`` or a preset name. ``params``:
        the port's param dict (``models.llama`` layout; ``models.convert``
        maps a JAX tree onto it), moved and cast to ``device``/``dtype``
        here, and quantized leaf by leaf when the config names a
        ``quantization_mode`` (leaves that already are carriers are kept);
        None makes random weights from ``generator`` (seed 0 when None),
        drawn straight into carriers when quantized. ``device=None`` is
        the GPU and raises without one."""
        self._config = config or RaggedInferenceEngineConfig()
        missing = unported_features(self._config)
        if missing:
            raise NotImplementedError(
                "not ported yet: " + "; ".join(f"{f} ({item})" for f, item in missing))
        qmode = self._config.quantization.quantization_mode
        self._qmode = None if qmode in ("none", "", None) else qmode
        if self._qmode is not None and self._qmode not in SCHEMES:
            raise ValueError(f"quantization_mode={qmode!r}: the engine serves 'none' or one of "
                             f"{SCHEMES}")
        sm = self._config.state_manager
        self.device = resolve_device(device)
        self.dtype = dtype
        cfg = llama_config(model_config)
        check_servable(cfg)
        self.model_config = cfg
        if params is None and self._qmode is not None:
            params = init_quantized_params(cfg, self._qmode, self.device, dtype, generator)
        elif params is None:
            params = init_params(cfg, self.device, dtype, generator)
        self.params = self._place_params(params)
        self.quantized_bytes = quantized_bytes(self.params)

        self.max_tokens = int(sm.max_ragged_batch_size)
        self.max_seqs = int(sm.max_ragged_sequence_count)
        self.block_size = int(self._config.kv_block_size)
        self.max_blocks_per_seq = -(-int(sm.max_context) // self.block_size)
        num_blocks = int(self._config.num_kv_blocks) or (
            1 + self.max_seqs * self.max_blocks_per_seq)
        if not int(self._config.num_kv_blocks):
            # Derived sizing (max_seqs x max_context worst case) can dwarf
            # device memory for wide-KV models; cap the DEFAULT at 8 GB with
            # a warning. An explicit num_kv_blocks is honored as given.
            bytes_per_block = (2 * cfg.num_hidden_layers * self.block_size *
                               cfg.num_key_value_heads * cfg.head_dim * dtype.itemsize)
            cap = max(2, int(8e9 // bytes_per_block))
            if num_blocks > cap:
                logger.warning(
                    f"derived KV pool ({num_blocks} blocks, "
                    f"{num_blocks * bytes_per_block / 1e9:.1f} GB) exceeds the 8 GB "
                    f"default budget — capping at {cap} blocks; set "
                    f"num_kv_blocks or a smaller state_manager to silence")
                num_blocks = cap
        self.kv_cache = BlockedKVCache(cfg.num_hidden_layers, num_blocks, self.block_size,
                                       cfg.num_key_value_heads, cfg.head_dim, dtype=dtype,
                                       device=self.device)
        self.state_manager = DSStateManager(self.kv_cache, int(sm.max_tracked_sequences))
        # positions are bounded by BOTH the block table and the RoPE table
        self.max_ctx_tokens = min(self.max_blocks_per_seq * self.block_size,
                                  int(cfg.max_position_embeddings))
        # Multi-tenant LoRA: per-request adapter ids bind to hot slots of
        # the store, whose slabs live on the engine's device in its dtype
        self.lora_store = None
        if lora_serving_enabled(self._config.lora):
            lcfg = self._config.lora
            H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
            dims = {"q_proj": (cfg.hidden_size, H * Dh),
                    "k_proj": (cfg.hidden_size, Hkv * Dh),
                    "v_proj": (cfg.hidden_size, Hkv * Dh),
                    "o_proj": (H * Dh, cfg.hidden_size)}
            self.lora_store = AdapterStore(
                dims, cfg.num_hidden_layers, n_hot=lora_hot_set(lcfg),
                max_rank=lora_max_rank(lcfg), host_bytes=int(lcfg.host_bytes),
                prefetch=bool(lcfg.prefetch), dtype=dtype, device=self.device)
        self._batch = RaggedBatchWrapper(self.max_tokens, self.max_seqs,
                                         self.max_blocks_per_seq,
                                         lora=self.lora_store is not None)
        self._attn_impl = (self._config.implementation_overrides or {}).get("attention")
        # resolve the attention implementation now, so a config no
        # implementation serves fails here and not mid-request
        self.attn_impl_name, _ = instantiate_attn(self.device, cfg.head_dim,
                                                  override=self._attn_impl)
        self._rope = rope_tables(cfg, self.device)
        # host_syncs counts executions of the host-sync sites the JAX engine
        # marks (one per put for the input tokens, one per put or burst for
        # the results, one per burst entry token); tokens_emitted counts
        # tokens handed to callers. forward_steps counts ragged forwards.
        self.host_syncs = 0
        self.tokens_emitted = 0
        self.forward_steps = 0
        logger.info(f"InferenceEngineV2: max_tokens={self.max_tokens} "
                    f"max_seqs={self.max_seqs} kv_blocks={num_blocks} "
                    f"block_size={self.block_size} attention={self.attn_impl_name} "
                    f"quantization={self._qmode or 'none'} "
                    f"lora={'on' if self.lora_store is not None else 'off'} "
                    f"param_bytes={self.quantized_bytes/1e6:.1f}MB "
                    f"kv_bytes={self.kv_cache.bytes()/1e6:.1f}MB")

    # ------------------------------------------------------------------
    def _place_params(self, params):
        """Move the params to the device in the serving dtype; quantize
        them leaf by leaf first when the config asks (the JAX engine's
        ``_place_params``). Carriers are never cast: ``float8_e4m3fn``
        counts as floating point, and the cast would destroy it."""
        if self._qmode is not None:
            return quantize_params_tree(params, self._qmode, dequant_dtype=self.dtype,
                                        device=self.device)

        def place(x):
            if isinstance(x, QuantizedWeight):
                return x.to(self.device)
            x = torch.as_tensor(x)
            dtype = self.dtype if x.is_floating_point() else x.dtype
            return x.to(device=self.device, dtype=dtype)
        return {k: ({n: place(w) for n, w in v.items()} if isinstance(v, dict) else place(v))
                for k, v in params.items()}

    def _forward(self, batch):
        self.forward_steps += 1
        lora = None
        if self.lora_store is not None:
            a, b, scales = self.lora_store.slabs()
            lora = (a, b, scales, batch["seq_adapters"])
        logits, _, _ = ragged_forward(self.params, self.kv_cache.k, self.kv_cache.v, batch,
                                      self.model_config, self.dtype,
                                      attn_impl=self._attn_impl, rope=self._rope, lora=lora)
        return logits

    # ------------------------------------------------------------------
    def put(self, batch_uids, batch_tokens, sample=None):
        """Run one ragged batch: ``batch_tokens[i]`` are the NEW tokens
        (full prompt, a prefill chunk, or one decode token) for
        ``batch_uids[i]``. Returns fp32 logits ``[len(uids), vocab]`` for
        each sequence's last scheduled token — or, with
        ``sample="greedy"``, int32 argmax token ids ``[len(uids)]``
        picked on the device. The batch is always validated first."""
        mode = self._classify_sample(sample, len(batch_uids))
        self.count_host_sync()
        batch_tokens = [np.atleast_1d(np.asarray(t, np.int32)) for t in batch_tokens]
        # Validate the WHOLE batch before touching any sequence state: a
        # mid-loop failure after allocate/advance would leave earlier
        # sequences claiming KV that was never written.
        total = sum(len(t) for t in batch_tokens)
        if total > self.max_tokens:
            raise ValueError(f"batch has {total} tokens > "
                             f"max_ragged_batch_size={self.max_tokens}")
        if len(batch_uids) > self.max_seqs:
            raise ValueError(f"{len(batch_uids)} sequences > "
                             f"max_ragged_sequence_count={self.max_seqs}")
        blocks_needed = 0
        new_seqs = 0
        for uid, tokens in zip(batch_uids, batch_tokens):
            desc = self.state_manager.query(uid)
            seen = desc.seen_tokens if desc is not None else 0
            if desc is None:
                new_seqs += 1
            if seen + len(tokens) > self.max_ctx_tokens:
                raise ValueError(f"sequence {uid}: {seen}+{len(tokens)} tokens exceed "
                                 f"max_context={self.max_ctx_tokens}")
            blocks_needed += (desc.blocks_needed(len(tokens)) if desc is not None
                              else -(-len(tokens) // self.block_size))
        if blocks_needed > self.kv_cache.free_blocks:
            raise RuntimeError(f"KV pool exhausted: need {blocks_needed} blocks, "
                               f"{self.kv_cache.free_blocks} free — flush() sequences first")
        if new_seqs + self.state_manager.n_tracked_sequences > \
                self.state_manager.max_tracked_sequences:
            raise RuntimeError("max_tracked_sequences exceeded for this batch")

        self._batch.clear()
        slots = []
        for i, (uid, tokens) in enumerate(zip(batch_uids, batch_tokens)):
            desc = self.state_manager.get_or_create_sequence(uid)
            desc.slot = i  # slots are per-batch rows in the device tables
            if self.lora_store is not None:
                # re-resolve per batch: an eviction between steps may have
                # moved the adapter to another slot
                desc.adapter_slot = self.lora_store.slot_of(uid)
            self.state_manager.allocate_for(desc, len(tokens))
            self._batch.insert_sequence(desc, tokens)
            desc.advance(len(tokens))
            slots.append(desc.slot)
        # decode bucket: a batch of ≤ max_seqs tokens (pure decode round)
        # runs the small step; prefill chunks run the full-budget one
        bucket = self.max_seqs if total <= self.max_seqs else self.max_tokens
        packed = torch.from_numpy(self._batch.finalize_packed(bucket=bucket)).to(self.device)
        logits = self._forward(unpack_batch(packed, self.max_seqs, self.max_blocks_per_seq,
                                            lora=self.lora_store is not None))
        out = logits.argmax(dim=-1).to(torch.int32) if mode == "greedy" else logits
        self.count_host_sync()
        self.tokens_emitted += len(batch_uids)
        return out.cpu().numpy()[np.asarray(slots, np.int64)]

    @staticmethod
    def _classify_sample(sample, n):
        """``None`` → raw logits, ``"greedy"`` (or an all-None per-uid
        list) → on-device argmax. Sampling specs are not ported yet."""
        if sample is None:
            return "logits"
        if sample == "greedy":
            return "greedy"
        if isinstance(sample, (list, tuple)) and len(sample) == n and \
                all(s is None for s in sample):
            return "greedy"
        raise NotImplementedError(
            f"sample={sample!r}: on-device sampling is not ported yet ({_QUEUE4}); "
            f"use None (logits) or 'greedy'")

    def count_host_sync(self, n=1):
        self.host_syncs += n

    def _validate_burst(self, batch_uids, k):
        """Shared pre-flight for ``can_burst`` and ``decode_burst``: every
        sequence must exist with prefilled context and room for ``k``
        more tokens, and the pool must cover the whole up-front
        reservation. → ``(descs, None)`` or ``(None, exception)``."""
        descs = []
        need = 0
        for uid in batch_uids:
            desc = self.state_manager.query(uid)
            if desc is None or desc.seen_tokens == 0:
                return None, ValueError(
                    f"sequence {uid} has no prefilled context — "
                    f"bursts continue existing sequences only")
            if desc.seen_tokens + k > self.max_ctx_tokens:
                return None, ValueError(
                    f"sequence {uid}: {desc.seen_tokens}+{k} tokens exceed "
                    f"max_context={self.max_ctx_tokens}")
            need += desc.blocks_needed(k)
            descs.append(desc)
        if need > self.kv_cache.free_blocks:
            return None, RuntimeError(
                f"KV pool exhausted: need {need} blocks, "
                f"{self.kv_cache.free_blocks} free — flush() sequences first")
        return descs, None

    def can_burst(self, batch_uids, k):
        """True when a ``decode_burst(uids, ·, k)`` can reserve KV blocks
        for all ``k`` tokens per sequence right now."""
        _, err = self._validate_burst(batch_uids, int(k))
        return err is None

    def decode_burst(self, batch_uids, batch_tokens, k, sample=None):
        """Run ``k`` greedy decode steps for one current token per uid:
        each step's argmax feeds the next on the device, and the host
        copies the tokens once, at the end. Returns int32 tokens
        ``[k, len(uids)]``. KV blocks for all ``k`` tokens are reserved
        up front, so the block tables are fixed across the burst."""
        k = int(k)
        if k < 1:
            raise ValueError("k must be >= 1")
        self._classify_sample(sample, len(batch_uids))  # greedy only
        if len(batch_uids) != len(batch_tokens):
            raise ValueError(f"{len(batch_uids)} uids vs {len(batch_tokens)} tokens")
        if len(batch_uids) > self.max_seqs:
            raise ValueError(f"{len(batch_uids)} sequences > "
                             f"max_ragged_sequence_count={self.max_seqs}")
        ms, mb = self.max_seqs, self.max_blocks_per_seq
        descs, err = self._validate_burst(batch_uids, k)
        if err is not None:
            raise err

        lora_on = self.lora_store is not None
        tokens0 = np.zeros(ms, np.int32)
        token_seq = np.full(ms, ms, np.int32)   # pad rows write the null slot
        pos0 = np.zeros(ms, np.int32)
        tables = np.full((ms + 1, mb), NULL_BLOCK, np.int32)
        adapters = np.zeros(ms + 1, np.int32)   # pad row stays slot 0 = base
        for i, (desc, tok) in enumerate(zip(descs, batch_tokens)):
            desc.slot = i
            if lora_on:
                desc.adapter_slot = self.lora_store.slot_of(desc.uid)
                adapters[i] = desc.adapter_slot
            self.state_manager.allocate_for(desc, k)
            self.count_host_sync()
            tokens0[i] = int(np.asarray(tok).reshape(-1)[-1])
            token_seq[i] = i
            pos0[i] = desc.seen_tokens
            tables[i, :len(desc.blocks)] = desc.blocks
            desc.advance(k)
        parts = [tokens0, token_seq, pos0, tables.ravel()] + ([adapters] if lora_on else [])
        meta = torch.from_numpy(np.concatenate(parts))
        meta = meta.to(self.device)  # the one host→device copy of the burst
        lay = _burst_layout(ms, mb, lora=lora_on)
        toks = meta[slice(*lay["tokens0"])]
        batch = {"token_seq": meta[slice(*lay["token_seq"])],
                 "block_tables": meta[slice(*lay["tables"])].reshape(ms + 1, mb),
                 "last_index": torch.arange(ms, dtype=torch.int32, device=self.device)}
        if lora_on:
            batch["seq_adapters"] = meta[slice(*lay["seq_adapters"])]
        pos0 = meta[slice(*lay["pos0"])]
        out = torch.empty((k, ms), dtype=torch.int32, device=self.device)
        for i in range(k):
            logits = self._forward(dict(batch, token_ids=toks, token_pos=pos0 + i))
            toks = logits.argmax(dim=-1).to(torch.int32)
            out[i] = toks
        self.count_host_sync()
        self.tokens_emitted += k * len(batch_uids)
        return out.cpu().numpy()[:, :len(batch_uids)]  # the one device→host copy

    def rewind(self, uid, n_tokens):
        """Roll ``uid`` back by ``n_tokens`` of KV content; now-unused
        trailing blocks return to the pool. → new seen_tokens."""
        desc = self.state_manager.query(uid)
        if desc is None:
            raise KeyError(f"unknown sequence {uid}")
        self.state_manager.rewind_sequence(desc, int(n_tokens))
        return desc.seen_tokens

    def bind_adapter(self, uid, adapter_id):
        """Pin ``uid``'s tokens to ``adapter_id``'s hot slot for the
        sequence's lifetime (promoting the adapter from the host tier if
        cold — may evict an unleased LRU hot adapter). ``adapter_id``
        falsy → base model, slot 0. The lease holds the slot until
        :meth:`flush`; → the bound slot index."""
        if not adapter_id:
            return 0
        if self.lora_store is None:
            raise RuntimeError("adapter routing requires LoRA serving (config.lora.enabled)")
        slot = self.lora_store.bind(uid, int(adapter_id))
        desc = self.state_manager.query(uid)
        if desc is not None:
            desc.adapter_slot = slot
        return slot

    def has_adapter(self, adapter_id):
        """True when ``adapter_id`` is hot (servable without a promotion)."""
        return self.lora_store is not None and self.lora_store.has_adapter(int(adapter_id))

    def knows_adapter(self, adapter_id):
        """True when any tier can serve ``adapter_id``."""
        return self.lora_store is not None and self.lora_store.known(int(adapter_id))

    def prefetch_adapter(self, adapter_id):
        """Fire-and-forget: stage ``adapter_id``'s padded slab rows on the
        store's prefetch worker so a later bind's host→device copy
        overlaps queueing (no-op without a store). Safe from any thread."""
        if self.lora_store is not None:
            self.lora_store.prefetch(int(adapter_id))

    def register_adapter(self, adapter_id, layers, alpha, version=0):
        """Install adapter weights ``{site: (a [L, in, r], b [L, r, out])}``
        (numpy) into the host tier; the first bind promotes them."""
        if self.lora_store is None:
            raise RuntimeError("LoRA serving is disabled")
        self.lora_store.register(int(adapter_id), layers, alpha, version=version)

    def adopt_adapter(self, adapter_id, version=None):
        """Adopting a published adapter version needs the disk tier, which
        is not ported yet: raises."""
        if self.lora_store is None:
            raise RuntimeError("LoRA serving is disabled")
        return self.lora_store.adopt(int(adapter_id), version=version)

    def query(self, uid):
        """→ (seen_tokens, max_new_before_realloc) parity surface."""
        desc = self.state_manager.query(uid)
        if desc is None:
            return None
        room = desc.cur_allocated_blocks * self.block_size - desc.seen_tokens
        return desc.seen_tokens, room

    def flush(self, uid):
        """Discard everything the engine holds for ``uid``."""
        if self.state_manager.query(uid) is None:
            raise KeyError(f"unknown sequence {uid}")
        self.state_manager.flush_sequence(uid)
        if self.lora_store is not None:
            self.lora_store.release(uid)  # drop the adapter-slot lease

    def destroy(self):
        """Drop the params and the KV pool (back-to-back engine builds)."""
        self.params = None
        self.kv_cache = None
        self.state_manager = None
        self._rope = None
        if self.lora_store is not None:
            self.lora_store.shutdown()  # stop the adapter prefetch worker
        self.lora_store = None

    @property
    def free_blocks(self):
        return self.kv_cache.free_blocks
