"""InferenceEngineV2: ragged (continuous-batching) serving engine.

Port of ``deepspeed_tpu/inference/v2/engine_v2.py`` for serving
Llama-family models, dense or MoE (dropless top-k), with bf16 weights
or weight-only quantized ones (``quantization.quantization_mode`` of
``"int8"``, ``"fp8"`` or ``"fp6"``: grouped carriers that the fused
kernels consume in place): ``put`` runs one ragged batch (mixed
prefill chunks and decodes, the Dynamic SplitFuse model) and returns
last-token logits, or tokens picked on the device: greedy, or sampled
per sequence (``sample=`` a spec dict or a per-uid list of dict/None);
``decode_burst`` runs ``k`` decode steps with each step's token staying
on the device and one device→host copy per burst;
``flush``/``query``/``rewind`` manage sequence state. The batch
metadata crosses host→device as one packed int32 vector per step (per
burst for ``decode_burst``), byte-identical to the JAX engine's; a
sampled batch appends the six sampling-spec rows per sequence.

Sampling keys every token by ``(DS_SEED, request seed, absolute
position)`` through the counter PRNG (``inference.structured.prng``,
bit-exact with JAX's threefry), so a seeded request replays its stream
on any engine, stepwise or in bursts of any length. A spec without a
``seed`` takes one from :meth:`draw_seed`, the engine's own stream.

Multi-tenant LoRA (``lora.enabled``): an :class:`AdapterStore` holds the
hot adapter slabs on the engine's device; ``register_adapter`` installs
an adapter in the host tier, ``bind_adapter`` (the scheduler calls it at
``add_request(adapter_id=)``) leases its hot slot to a sequence, every
batch re-resolves each sequence's slot into the adapter row of the packed
vector, and ``flush`` drops the lease. Off, nothing changes: the wire
format and the forward are the pre-LoRA ones. With ``lora.publish_root``
the store's disk tier serves sha256-validated adapter publications
(``adopt_adapter``, and a lazy adopt when a bind promotes an adapter only
the disk holds).

Live weight refresh: ``swap_params(new_params, version)`` places a new
tree through the constructor's ``_place_params`` (quantizing it on the
device when the config names a mode), so a swapped engine serves what a
cold start on the new tree serves; it bumps :attr:`weight_version`, which
re-keys the prefix trie's root (every cached identity and exported
handoff record is version-tagged), and drops the adapter hot set. It
refuses while any sequence is tracked or suspended.

Radix prefix cache (``prefix_cache.enabled``): retired sequences' full
blocks become content-addressable, and ``prefix_match`` (the scheduler
calls it when it first plans a request) starts a sequence past its
longest cached prompt prefix. Host KV spill tier (``kv_tier.enabled``,
on top of the prefix cache): blocks the cache evicts under pressure are
demoted to host RAM, in the pool dtype or as int8 (``kv_tier.quantize``,
kernel K7 on the device), and promoted back when a prompt's match
continues into them; ``prefetch_prefix`` stages them on a worker,
``export_prefix``/``import_prefix`` carry a cached prefix between
engines as a validated handoff record. ``suspend``/``resume`` swap a live
sequence's KV to host memory and back.

Self-speculative decoding (``spec_decode.enabled``, ``DS_SPEC_DECODE``):
``propose_drafts`` looks the sequence's own token log up for a recurring
suffix n-gram, and ``verify_burst`` scores each sequence's entry token and
its drafts as one (d+1)-token chunk in one ragged forward, accepting the
longest prefix of drafts that equal the model's own choices there (the
argmax, or the counter-keyed draw stepwise decode makes at that
position), so the emitted stream equals the spec-off stream.

Constrained decoding (``structured.enabled``, ``DS_CONSTRAINED``):
``bind_schema`` leases a JSON schema's or regex's token DFA a slot of the
:class:`StructuredStore`'s device slabs; every on-device pick of a bound
sequence masks its logits by its DFA state's allowed tokens (rows 4-5 of
the sampling rows carry the slot and the state), and a burst advances
the state on the device from the picked token.

Pipelined decode bursts (``async_burst.enabled``, ``DS_ASYNC_BURST``):
``decode_burst_async`` dispatches a burst and returns an
:class:`AsyncBurstHandle` without any device→host copy; a chained burst
takes its entry tokens (and, sampled, its DFA states) from the previous
handle's device rows, so the host packs burst k+1 while burst k runs, and
the caller fences one burst late. On one CUDA stream every blocking call
would drain the younger burst too, so the pipeline keeps none in its
steady state: the packed vectors go up from a ring of pinned staging
buffers (:class:`_StagingRing`), and each burst's tokens come down into
pinned memory right behind its last step, behind a CUDA event that
``fetch`` waits on alone. The token log takes the burst's tokens as
pending device segments, fenced by ``flush``, ``suspend``,
``export_prefix``, ``propose_drafts`` and ``rewind``.

``DS_SANITIZE`` (sampled once, at construction): off, the forward is the
plain one, with no wrapper; on, every forward checks its packed batch's
integer inputs against their ranges and its logits for non-finite values
(``utils.sanitize.maybe_checkify``), and the allocator, the prefix cache
and the spill tier audit their invariants after every mutation.

Features outside this slice raise ``NotImplementedError`` at
construction (:func:`unported_features`). The ``DS_*`` environment
variables are read through ``utils/env_registry.py``."""

import numpy as np
import torch

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.inference.sampling import validate_sample_spec
from deepspeed_tpu_torch.inference.quantization.quantization import (QuantizedWeight,
                                                                     quantize_params_tree,
                                                                     quantized_bytes)
from deepspeed_tpu_torch.inference.structured.prng import (base_sampling_key, fold_in,
                                                           fold_in_rows, key_tensor, prng_key,
                                                           randint31, split, token_keys)
from deepspeed_tpu_torch.inference.structured import constrained_enabled
from deepspeed_tpu_torch.inference.structured.grammar import CompiledSchema
from deepspeed_tpu_torch.inference.structured.sampling import (SAMPLE_META_ROWS,
                                                               apply_dfa_mask,
                                                               pack_sample_meta, sample_rows,
                                                               unpack_sample_meta)
from deepspeed_tpu_torch.inference.structured.store import StructuredStore, schema_cache
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.kv_tier import (TierManager, kv_tier_bytes, kv_tier_enabled,
                                                      kv_tier_quantized)
from deepspeed_tpu_torch.inference.v2.model_runner import ragged_forward, rope_tables
from deepspeed_tpu_torch.inference.v2.modules.heuristics import instantiate_attn
from deepspeed_tpu_torch.inference.v2.prefix_cache import (PrefixCacheManager,
                                                           prefix_cache_enabled)
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import NULL_BLOCK, BlockedKVCache
from deepspeed_tpu_torch.inference.v2.ragged.ragged_manager import DSStateManager
from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import (RaggedBatchWrapper,
                                                                    unpack_batch)
from deepspeed_tpu_torch.inference.v2.spec import SpecDecodeState, spec_decode_enabled
from deepspeed_tpu_torch.models.llama import (check_servable, init_params,
                                              init_quantized_params, llama_config)
from deepspeed_tpu_torch.ops.kernels.fused_quant_matmul import SCHEMES
from deepspeed_tpu_torch.serving.lora import (AdapterStore, lora_hot_set, lora_max_rank,
                                             lora_serving_enabled)
from deepspeed_tpu_torch.utils.env_registry import env_int, env_opt_bool
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.sanitize import check_index, maybe_checkify, sanitize_enabled

_QUEUE5 = "ROADMAP.md, port queue item 5 (tensor- and expert-parallel serving)"


def ds_seed():
    """``DS_SEED`` (the base of the sampling counter PRNG and of
    ``draw_seed``'s stream), through the env registry (default 42)."""
    return env_int("DS_SEED")


def async_burst_enabled(config) -> bool:
    """Config gate plus the ``DS_ASYNC_BURST`` kill switch: when the env
    var is set it wins in BOTH directions (``0``/``false``/``off``
    forces the pre-pipeline loop, anything else forces pipelining);
    unset defers to ``config.enabled``. The emitted streams are the same
    either way."""
    forced = env_opt_bool("DS_ASYNC_BURST")
    if forced is not None:
        return forced
    return bool(getattr(config, "enabled", False))


def unported_features(config):
    """→ [(feature, roadmap item)] the config turns on that the port
    does not serve yet."""
    out = []
    for name in ("tensor_parallel_degree", "expert_parallel_degree"):
        if int(getattr(config, name)) > 1:
            out.append((f"{name}={getattr(config, name)}", _QUEUE5))
    return out


def _burst_layout(ms, mb, lora=False, sampled=False, async_entry=False):
    """Wire format of the decode-burst metadata vector: field → (start,
    end) offsets into the flat int32 vector (the JAX engine's
    ``_burst_layout``). ``async_entry`` drops ``tokens0``: a pipelined
    burst's entry tokens come from the previous burst's last output row
    on the device. ``lora`` appends the per-sequence adapter-slot row and
    ``sampled`` the per-sequence sampling-spec rows after it."""
    fields = [("tokens0", ms), ("token_seq", ms), ("pos0", ms), ("tables", (ms + 1) * mb)]
    if async_entry:
        fields = fields[1:]
    if lora:
        fields.append(("seq_adapters", ms + 1))
    if sampled:
        fields.append(("sample_meta", SAMPLE_META_ROWS * ms))
    return _offsets(fields)


def _verify_layout(ms, mb, d, lora=False, sampled=False):
    """Wire format of the verify-burst metadata vector, ``_burst_layout``'s
    twin for the speculative path (the JAX engine's ``_verify_layout``):
    per sequence, the entry token plus ``d`` (padded) draft tokens, the
    real draft count, and the usual slot/position/block-table fields
    (plus the adapter-slot row when LoRA serving is on and the
    sampling-spec rows for the rejection-sampled verify)."""
    fields = [("tokens", ms * (d + 1)), ("dlen", ms), ("token_seq", ms), ("pos0", ms),
              ("tables", (ms + 1) * mb)]
    if lora:
        fields.append(("seq_adapters", ms + 1))
    if sampled:
        fields.append(("sample_meta", SAMPLE_META_ROWS * ms))
    return _offsets(fields)


def _offsets(fields):
    """[(field, size)] → field → (start, end) offsets into one vector."""
    o, lay = 0, {}
    for name, size in fields:
        lay[name] = (o, o + size)
        o += size
    return lay


class _StagingRing:
    """``n`` pinned host buffers for the host→device copies of the packed
    int32 vectors. A copy from pageable memory is one PyTorch completes
    with a stream synchronize, which would drain every burst enqueued
    before it; from pinned memory with ``non_blocking`` it is queued like
    a kernel. A buffer is written again only after the event recorded
    behind its last copy has passed (with ``n`` = depth + 1 that copy
    fed a burst the caller has fenced already, so the wait is free)."""

    def __init__(self, n):
        self._bufs = [None] * n
        self._events = [None] * n
        self._next = 0

    def upload(self, arr, device):
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        event = self._events[i]
        if event is not None and not event.query():
            event.synchronize()
        buf = self._bufs[i]
        if buf is None or buf.numel() < arr.size:
            buf = self._bufs[i] = torch.empty(max(arr.size, 1024), dtype=torch.int32,
                                              pin_memory=True)
        host = buf[:arr.size]
        host.numpy()[:] = arr
        out = host.to(device, non_blocking=True)
        event = self._events[i] = torch.cuda.Event()
        event.record()
        return out


class AsyncBurstHandle:
    """One dispatched but unfenced pipelined decode burst (the JAX
    engine's handle).

    ``out`` is the device ``[k, max_seqs]`` token tensor the burst's
    steps produced; ``out[-1]`` is the next chained burst's entry row and
    ``st`` (sampled bursts only) the chained DFA state row. On the card
    the burst's device→host copy is enqueued into pinned memory right
    behind its last step, with a CUDA event recorded after it, so
    ``fetch()`` waits on this burst alone and never on a younger one
    dispatched since. Until ``fetch`` the host knows nothing of the
    burst's tokens: EOS, the accept loop and the token log all learn them
    one burst late, when the scheduler fences."""

    def __init__(self, engine, uids, descs, k, out, st=None, entry_np=None, prev=None):
        self.uids = list(uids)
        self.k = int(k)
        self.out = out            # device [k, max_seqs] int32
        self.st = st              # device [max_seqs] chained DFA state (sampled)
        self._engine = engine
        self._descs = descs
        self._entry_np = entry_np  # host entry tokens, or None when chained
        self._prev = prev          # previous handle in the device chain
        self._toks = None
        self._host = self._event = None
        if out.is_cuda:
            self._host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self._host.copy_(out, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    @property
    def entry_next(self):
        """Device entry row for the next chained burst (no sync)."""
        return self.out[-1]

    def entry_values(self):
        """Host values of this burst's entry tokens ([n] np.int32). For
        a chained burst this reads the PREVIOUS handle's fetched output:
        in-order fencing makes that a cached re-read, never an early wait
        on a younger burst."""
        if self._entry_np is None:
            self._entry_np = self._prev.fetch()[-1][:len(self.uids)]
        return self._entry_np

    def fetch(self):
        """THE one device→host copy of this burst → np.int32 [k, n].
        Idempotent; counts the engine's per-burst sync site once. After
        it the handle drops its device buffer and its ``_prev`` link
        (resolving the host entry row first), so a long pipeline never
        chains unbounded memory."""
        if self._toks is None:
            self._engine.count_host_sync()
            if self._event is not None:
                self._event.synchronize()  # this burst's copy, not the stream
                host = self._host
            else:
                host = self.out
            self._toks = host.numpy()[:, :len(self.uids)].copy()
            self.out = self._host = self._event = None
            if self._prev is not None:
                if self._entry_np is None:
                    self._entry_np = self._prev.fetch()[-1][:len(self.uids)]
                self._prev = None
        return self._toks

    def fence_logs(self):
        """Materialize the pending token-log segments of every sequence
        this burst touched. A descriptor's log fences in append order
        across bursts, so this fetches any younger in-flight burst over
        the same rows: call it at drain time, never from the steady-state
        fence loop."""
        for desc in self._descs:
            desc.tokens.fence()


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
        # monotone weight-version tag: bumped by swap_params (live weight
        # refresh); stamped into the prefix trie's root key so every
        # cached KV identity — and every exported handoff record — is
        # version-tagged (version 0 == the trie's historical root key)
        self.weight_version = 0

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
        # host_syncs counts executions of the host-sync sites the JAX engine
        # marks (one per put for the input tokens, one per put or burst for
        # the results, one per burst entry token) and the spill tier's
        # device->host copies; tokens_emitted counts tokens handed to
        # callers. forward_steps counts ragged forwards.
        self.host_syncs = 0
        self.tokens_emitted = 0
        self.forward_steps = 0
        # Pipelined decode bursts: schedulers consult these to run the
        # dispatch/fence pump instead of the fetch-every-burst loop.
        self.async_burst = async_burst_enabled(self._config.async_burst)
        self.async_burst_depth = max(1, int(getattr(self._config.async_burst, "depth", 2)))
        self.bursts = {"sync": 0, "async": 0}  # decode bursts dispatched, by path
        self._staging = _StagingRing(self.async_burst_depth + 1)
        # DS_SANITIZE, sampled once: off, the gate hands back the forward
        # itself (no wrapper, no branch a call); on, every forward checks
        # its batch's indices before it runs and its logits after
        self._sanitize = sanitize_enabled()
        self._forward = maybe_checkify(self._forward, check_inputs=self._check_batch,
                                       enabled=self._sanitize)
        # Counter-PRNG root for sampling: every sampled token's key folds
        # (request seed, absolute position) into this DS_SEED-derived
        # base, so a replica replaying a request reproduces it bit for bit
        seed = ds_seed()
        self._base_key = key_tensor(base_sampling_key(seed), self.device)
        # per-request seed fallback stream (draw_seed), on the host
        self._rng = fold_in(prng_key(seed), 7)
        # Radix prefix cache (cross-request KV reuse): retired sequences'
        # full blocks become content-addressable and new prompts start
        # past their longest cached prefix.
        self.prefix_cache = None
        if prefix_cache_enabled(self._config.prefix_cache):
            self.prefix_cache = PrefixCacheManager(
                self.kv_cache,
                max_cached_blocks=int(self._config.prefix_cache.max_cached_blocks))
            self.state_manager.attach_prefix_cache(self.prefix_cache)
        # Host-RAM KV spill tier (tier-2): trie eviction demotes blocks
        # into a byte-budgeted host store instead of dropping them. Layered
        # on the prefix cache (tier-2 keys ARE the trie's chained hashes),
        # so without a prefix cache it cannot exist.
        self.kv_tier = None
        if kv_tier_enabled(self._config.kv_tier):
            if self.prefix_cache is None:
                logger.warning(
                    "kv_tier enabled but the prefix cache is off — the "
                    "spill tier stores evicted TRIE blocks, so it is "
                    "inert without one; skipping")
            else:
                tier_cfg = self._config.kv_tier
                self.kv_tier = TierManager(
                    self.prefix_cache,
                    capacity_bytes=kv_tier_bytes(tier_cfg),
                    quantize=kv_tier_quantized(tier_cfg),
                    quant_group_size=int(tier_cfg.quant_group_size),
                    prefetch=bool(tier_cfg.prefetch),
                    count_sync=self.count_host_sync)
                self.prefix_cache.attach_tier(self.kv_tier)
        # Self-speculative decoding (n-gram drafting + batched verify):
        # config-gated with the DS_SPEC_DECODE env kill switch. When
        # live, schedulers draft via propose_drafts() and score drafts
        # in one forward via verify_burst().
        self.spec = None
        if spec_decode_enabled(self._config.spec_decode):
            self.spec = SpecDecodeState(self._config.spec_decode)
        # Structured (grammar/JSON-schema constrained) decoding:
        # config-gated with the DS_CONSTRAINED env kill switch. When
        # live, bound schemas install token-DFA slabs on the device and
        # every on-device pick gathers a per-sequence logits mask from
        # them; off, no DFA row is packed and no mask applied.
        self.structured = None
        if constrained_enabled(self._config.structured):
            scfg = self._config.structured
            self.structured = StructuredStore(int(cfg.vocab_size),
                                              max_schemas=int(scfg.max_schemas),
                                              max_states=int(scfg.max_states),
                                              device=self.device)
        # the per-sequence KV-content token log feeds BOTH the prefix
        # cache (retire-time content addressing) and the n-gram drafter
        self._log_tokens = self.prefix_cache is not None or self.spec is not None
        self._suspended = {}  # uid -> {"handle": host KV, "seen_tokens", "tokens"}
        # positions are bounded by BOTH the block table and the RoPE table
        self.max_ctx_tokens = min(self.max_blocks_per_seq * self.block_size,
                                  int(cfg.max_position_embeddings))
        # Multi-tenant LoRA: per-request adapter ids bind to hot slots of
        # the store, whose slabs live on the engine's device in its dtype
        self.lora_store = None
        self._burst_lora = None  # the slabs a running burst took for all its steps
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
                publish_root=(lcfg.publish_root or None), prefetch=bool(lcfg.prefetch),
                dtype=dtype, device=self.device)
        self._batch = RaggedBatchWrapper(self.max_tokens, self.max_seqs,
                                         self.max_blocks_per_seq,
                                         lora=self.lora_store is not None)
        self._attn_impl = (self._config.implementation_overrides or {}).get("attention")
        # resolve the attention implementation now, so a config no
        # implementation serves fails here and not mid-request
        self.attn_impl_name, _ = instantiate_attn(self.device, cfg.head_dim,
                                                  override=self._attn_impl)
        self._rope = rope_tables(cfg, self.device)
        tier = "off" if self.kv_tier is None else "int8" if self.kv_tier.quantize else "on"
        logger.info(f"InferenceEngineV2: max_tokens={self.max_tokens} "
                    f"max_seqs={self.max_seqs} kv_blocks={num_blocks} "
                    f"block_size={self.block_size} attention={self.attn_impl_name} "
                    f"quantization={self._qmode or 'none'} "
                    f"lora={'on' if self.lora_store is not None else 'off'} "
                    f"prefix_cache={'on' if self.prefix_cache is not None else 'off'} "
                    f"kv_tier={tier} "
                    f"spec_decode={'on' if self.spec is not None else 'off'} "
                    f"structured={'on' if self.structured is not None else 'off'} "
                    f"async_burst={'on' if self.async_burst else 'off'} "
                    f"sanitize={'on' if self._sanitize else 'off'} "
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

    def swap_params(self, new_params, version):
        """Live weight refresh: adopt ``new_params`` in place, bumping
        :attr:`weight_version` and invalidating every piece of KV derived
        from the old weights (prefix trie, tier-2 store, staged copies)
        and the adapter hot set. The new tree goes through
        :meth:`_place_params`, as at construction (a quantized engine
        quantizes it on the device), so the engine serves what a cold
        start on ``new_params`` serves. The old tree is released once the
        new one is placed: the peak holds both.

        Requires an idle engine (no tracked or suspended sequences, which
        also means no pipelined burst left unfetched): the serving
        gateway quiesces in-flight work before calling this. Returns the
        adopted version."""
        if self.state_manager is None:
            raise RuntimeError("swap_params on a destroyed engine")
        if self.state_manager.n_tracked_sequences:
            raise RuntimeError(
                f"swap_params with {self.state_manager.n_tracked_sequences} "
                f"live sequence(s) — quiesce the engine first")
        if self._suspended:
            raise RuntimeError(
                f"swap_params with {len(self._suspended)} suspended "
                f"sequence(s) — their host KV predates the new weights")
        version = int(version)
        self.params = self._place_params(new_params)
        self.quantized_bytes = quantized_bytes(self.params)
        self.weight_version = version
        if self.prefix_cache is not None:
            self.prefix_cache.invalidate_for_version(version)
        if self.lora_store is not None:
            # hot adapter deltas were tuned against the OLD base weights;
            # drop them so every tenant re-adopts against the new base
            self.lora_store.invalidate()
        return version

    def _check_batch(self, batch):
        """The sanitized forward's index checks (checkify's, raised before
        the gathers): every integer input of the batch within the range
        the forward reads it against."""
        T = batch["token_ids"].shape[0]
        check_index("token_ids", batch["token_ids"], 0, self.model_config.vocab_size)
        check_index("token_seq", batch["token_seq"], 0, self.max_seqs + 1)
        check_index("token_pos", batch["token_pos"], 0, self.max_ctx_tokens)
        check_index("block_tables", batch["block_tables"], 0, self.kv_cache.num_blocks)
        check_index("last_index", batch["last_index"], 0, T)
        if "seq_adapters" in batch:
            check_index("seq_adapters", batch["seq_adapters"], 0, self.lora_store.n_slots)

    def _forward(self, batch):
        """One ragged forward → logits (the instance's ``_forward`` is this
        method through the ``DS_SANITIZE`` gate). The adapter slabs are
        the ones a running burst took for all its steps, else taken now:
        every layer of every step reads one adapter version."""
        self.forward_steps += 1
        lora = None
        if self.lora_store is not None:
            a, b, scales = self._burst_lora or self.lora_store.slabs()
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
        picked on the device. A ``{"temperature", "top_k", "top_p",
        "seed"}`` dict samples every row on the device with its counter
        key; a per-uid list of dict/None mixes sampled and greedy rows in
        one step (the specs ride the packed vector as data). Sequences
        with a bound schema (:meth:`bind_schema`) additionally gather
        their DFA logits mask on the device and MUST use an on-device
        mode (``"greedy"`` or a spec): the raw-logits path cannot enforce
        the constraint. The batch is always validated first."""
        mode, specs = self._classify_sample(sample, len(batch_uids))
        mode, specs = self._constrain_mode(batch_uids, mode, specs)
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
        if blocks_needed > self._reclaimable_blocks():
            raise RuntimeError(f"KV pool exhausted: need {blocks_needed} blocks, "
                               f"{self._reclaimable_blocks()} reclaimable — "
                               f"flush() sequences first")
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
            if self._log_tokens:
                # content log: retire-time insertion into the prefix trie
                desc.tokens.fence()
                desc.tokens.extend(int(t) for t in tokens)
            slots.append(desc.slot)
        # decode bucket: a batch of ≤ max_seqs tokens (pure decode round)
        # runs the small step; prefill chunks run the full-budget one
        bucket = self.max_seqs if total <= self.max_seqs else self.max_tokens
        arrays = self._batch.finalize_packed(bucket=bucket)
        sampled = mode == "packed"
        if sampled:
            # sampling specs ride the same vector: resolve engine-stream
            # seeds for specs submitted without one, then append the six
            # int32 rows per sequence
            self._resolve_seeds(specs)
            arrays = np.concatenate([arrays, pack_sample_meta(specs, self.max_seqs,
                                                              dfa=self._dfa_rows(batch_uids))])
        batch = unpack_batch(self._upload(arrays), self.max_seqs, self.max_blocks_per_seq,
                             lora=self.lora_store is not None, sampled=sampled)
        logits = self._forward(batch)
        if sampled:
            temp, topk, topp, seed, slot, state = unpack_sample_meta(batch["sample_meta"],
                                                                     self.max_seqs)
            if self.structured is not None:
                logits = apply_dfa_mask(logits, self.structured.slabs()[0], slot, state)
            # the token this step emits lands one past the row's last
            # scheduled token: the same absolute position (and so the
            # same counter key) every other path derives for it
            pos_out = batch["token_pos"][batch["last_index"].long()] + 1
            out = sample_rows(logits, token_keys(self._base_key, seed, pos_out), temp, topk,
                              topp)
        else:
            out = logits.argmax(dim=-1).to(torch.int32) if mode == "greedy" else logits
        self.count_host_sync()
        self.tokens_emitted += len(batch_uids)
        return out.cpu().numpy()[np.asarray(slots, np.int64)]

    def _upload(self, arrays):
        """The one host→device copy of a step's or burst's packed int32
        metadata vector: on the card from a pinned staging buffer,
        queued on the stream without a synchronize."""
        if self.device.type == "cpu":
            return torch.from_numpy(arrays)
        return self._staging.upload(arrays, self.device)

    @staticmethod
    def _classify_sample(sample, n):
        """Normalize ``put``/burst ``sample`` arguments → ``(mode,
        specs)``: ``("logits", None)`` for raw logits, ``("greedy",
        None)`` for on-device argmax, or ``("packed", [dict|None] * n)``
        with every dict VALIDATED and copied (seeds resolve later, after
        batch validation — no state mutates for a rejected batch)."""
        if sample is None:
            return "logits", None
        if isinstance(sample, str) and sample == "greedy":
            return "greedy", None
        if isinstance(sample, dict):
            validate_sample_spec(sample)
            return "packed", [dict(sample) for _ in range(n)]
        if isinstance(sample, (list, tuple)):
            if len(sample) != n:
                raise ValueError(f"sample list has {len(sample)} specs for {n} sequences")
            out = []
            for s in sample:
                if s is None:
                    out.append(None)
                    continue
                if not isinstance(s, dict):
                    raise ValueError(f"sample list entries are dict/None, got {s!r}")
                validate_sample_spec(s)
                out.append(dict(s))
            if not any(s is not None for s in out):
                return "greedy", None  # all-greedy list: plain argmax
            return "packed", out
        raise ValueError(f"sample={sample!r}: supported modes are None (logits), "
                         f"'greedy' (on-device argmax), a sampling dict "
                         f"{{'temperature', 'top_k', 'top_p', 'seed'}}, or a "
                         f"per-sequence list of dict/None")

    def _any_bound(self, batch_uids):
        """True when constrained decoding is live and a uid has a schema."""
        return self.structured is not None and any(self.structured.bound(u) for u in batch_uids)

    def _constrain_mode(self, batch_uids, mode, specs):
        """A batch holding a schema-bound sequence runs the packed mode
        (greedy rows still need their DFA meta rows) and refuses the
        raw-logits mode, which cannot enforce the constraint."""
        if not self._any_bound(batch_uids):
            return mode, specs
        if mode == "logits":
            raise RuntimeError("constrained sequences sample on device — call put with "
                               "sample='greedy' or a sampling spec, not the raw-logits path")
        return "packed", specs if specs is not None else [None] * len(batch_uids)

    def _dfa_rows(self, batch_uids):
        """Each row's ``(schema slot, DFA state)`` when constrained decoding
        is live, else None (the DFA rows stay 0)."""
        if self.structured is None:
            return None
        return [(self.structured.slot_of(u), self.structured.state_of(u)) for u in batch_uids]

    def _resolve_seeds(self, specs):
        for s in specs:
            if s is not None and "seed" not in s:
                s["seed"] = self.draw_seed()

    def count_host_sync(self, n=1):
        self.host_syncs += n

    @property
    def syncs_per_generated_token(self):
        """Host-sync site executions per emitted token: the stepwise loop
        pays ~2 a token, a fetched-every-burst loop ~(n+1)/(n*k), and the
        pipelined pump ~1/(n*k)."""
        return round(self.host_syncs / max(self.tokens_emitted, 1), 4)

    def draw_seed(self):
        """One per-request sampling seed from the engine's deterministic
        DS_SEED-rooted stream (``jax.random.split`` then ``randint(0,
        2**31 - 1)``, computed on the host) — for specs submitted
        without an explicit ``seed``. Counts one host sync, as the JAX
        engine's device read does."""
        self._rng, sub = split(self._rng, 2)
        self.count_host_sync()
        return randint31(sub)

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
        if need > self._reclaimable_blocks():
            return None, RuntimeError(
                f"KV pool exhausted: need {need} blocks, "
                f"{self._reclaimable_blocks()} reclaimable — "
                f"flush() sequences first")
        return descs, None

    def can_burst(self, batch_uids, k):
        """True when a ``decode_burst(uids, ·, k)`` can reserve KV blocks
        for all ``k`` tokens per sequence right now."""
        _, err = self._validate_burst(batch_uids, int(k))
        return err is None

    def _burst_setup(self, batch_uids, k, sample, prev=None):
        """Validation and sampling mode shared by ``decode_burst`` and
        ``decode_burst_async`` → ``(k, sampled, specs, descs)``."""
        k = int(k)
        if k < 1:
            raise ValueError("k must be >= 1")
        if prev is not None and list(prev.uids) != list(batch_uids):
            raise ValueError("chained async burst must keep its predecessor's uid order — "
                             "drain the pipeline when the live set changes")
        mode, specs = self._classify_sample(sample, len(batch_uids))
        if mode == "logits":
            mode = "greedy"  # a burst has no raw-logits mode
        mode, specs = self._constrain_mode(batch_uids, mode, specs)
        sampled = mode == "packed"
        if sampled and prev is not None and prev.st is None:
            raise ValueError("sampled async burst chained onto a greedy handle — drain the "
                             "pipeline before changing decode mode")
        if len(batch_uids) > self.max_seqs:
            raise ValueError(f"{len(batch_uids)} sequences > "
                             f"max_ragged_sequence_count={self.max_seqs}")
        descs, err = self._validate_burst(batch_uids, k)
        if err is not None:
            raise err
        return k, sampled, specs, descs

    def _entries(self, batch_tokens):
        """Each sequence's entry token, from the host (one host-sync site
        a sequence, as the JAX engine counts them) → list of ints."""
        entries = []
        for tok in batch_tokens:
            self.count_host_sync()  # the previous step's or burst's host copy
            entries.append(int(np.asarray(tok).reshape(-1)[-1]))
        return entries

    def _pack_rows(self, descs, n_tok, advance=False):
        """The wire rows the bursts and the verify share after their
        tokens: each sequence takes row ``i``, its adapter slot and KV
        blocks for ``n_tok`` more tokens (and advances by ``n_tok`` when
        ``advance``); pad rows write the null slot with the base adapter.
        → [token_seq, pos0, tables, (adapters)] in wire order."""
        ms, mb = self.max_seqs, self.max_blocks_per_seq
        lora_on = self.lora_store is not None
        token_seq = np.full(ms, ms, np.int32)   # pad rows write the null slot
        pos0 = np.zeros(ms, np.int32)
        tables = np.full((ms + 1, mb), NULL_BLOCK, np.int32)
        adapters = np.zeros(ms + 1, np.int32)   # pad row stays slot 0 = base
        for i, desc in enumerate(descs):
            desc.slot = i
            if lora_on:
                desc.adapter_slot = self.lora_store.slot_of(desc.uid)
                adapters[i] = desc.adapter_slot
            self.state_manager.allocate_for(desc, n_tok)
            token_seq[i] = i
            pos0[i] = desc.seen_tokens
            tables[i, :len(desc.blocks)] = desc.blocks
            if advance:
                desc.advance(n_tok)
        return [token_seq, pos0, tables.ravel()] + ([adapters] if lora_on else [])

    def _run_burst(self, meta, lay, k, sampled, toks, st=None):
        """The burst's ``k`` steps on the device: each step's token feeds
        the next, and a constrained row's DFA state advances from its
        pick. ``toks``: the entry row [ms]; ``st``: the chained DFA state
        row, or None for the packed one. → (out [k, ms] int32, final DFA
        state row or None); nothing here reads a device value on the
        host."""
        ms, mb = self.max_seqs, self.max_blocks_per_seq
        batch = {"token_seq": meta[slice(*lay["token_seq"])],
                 "block_tables": meta[slice(*lay["tables"])].reshape(ms + 1, mb),
                 "last_index": torch.arange(ms, dtype=torch.int32, device=self.device)}
        if "seq_adapters" in lay:
            batch["seq_adapters"] = meta[slice(*lay["seq_adapters"])]
        pos0 = meta[slice(*lay["pos0"])]
        slabs = None
        if sampled:
            temp, topk, topp, seed, slot, st_meta = unpack_sample_meta(
                meta[slice(*lay["sample_meta"])], ms)
            st = st_meta if st is None else st
            seed_keys = fold_in_rows(self._base_key, seed)  # the first fold, once a burst
            if self.structured is not None:
                slabs = self.structured.slabs()
                slot = slot.long()
        # one adapter version for the whole burst, as the JAX burst's one
        # dispatch binds its slabs once
        self._burst_lora = self.lora_store.slabs() if self.lora_store is not None else None
        out = torch.empty((k, ms), dtype=torch.int32, device=self.device)
        try:
            for i in range(k):
                logits = self._forward(dict(batch, token_ids=toks, token_pos=pos0 + i))
                if sampled:
                    if slabs is not None:
                        logits = apply_dfa_mask(logits, slabs[0], slot, st)
                    # step i's token lands at absolute position pos0 + i + 1,
                    # so its counter key matches the stepwise path exactly
                    toks = sample_rows(logits, fold_in_rows(seed_keys, pos0 + i + 1), temp,
                                       topk, topp)
                    if slabs is not None:  # the DFA advance, on the device
                        st = slabs[1][slot, st.long(), toks.long()]
                else:
                    toks = logits.argmax(dim=-1).to(torch.int32)
                out[i] = toks
        finally:
            self._burst_lora = None
        return out, (st if sampled else None)

    def decode_burst(self, batch_uids, batch_tokens, k, sample=None):
        """Run ``k`` decode steps for one current token per uid: each
        step's token feeds the next on the device, and the host copies
        the tokens once, at the end. ``sample=None`` decodes greedily; a
        spec dict or a per-uid list of dict/None draws with counter keys
        ``(seed, absolute position)``, so burst length and scheduling
        never change the emitted stream. Returns int32 tokens ``[k,
        len(uids)]``. Sequences with a bound schema mask their logits by
        their DFA state at every step, and the state advances on the
        device from the picked token. KV blocks for all ``k`` tokens are
        reserved up front, so the block tables are fixed across the
        burst."""
        if len(batch_uids) != len(batch_tokens):
            raise ValueError(f"{len(batch_uids)} uids vs {len(batch_tokens)} tokens")
        k, sampled, specs, descs = self._burst_setup(batch_uids, k, sample)
        ms = self.max_seqs
        entries = self._entries(batch_tokens)
        tokens0 = np.zeros(ms, np.int32)
        tokens0[:len(entries)] = entries
        parts = [tokens0] + self._pack_rows(descs, k, advance=True)
        if sampled:
            self._resolve_seeds(specs)
            parts.append(pack_sample_meta(specs, ms, dfa=self._dfa_rows(batch_uids)))
        meta = self._upload(np.concatenate(parts))
        lay = _burst_layout(ms, self.max_blocks_per_seq, lora=self.lora_store is not None,
                            sampled=sampled)
        out, _ = self._run_burst(meta, lay, k, sampled, meta[slice(*lay["tokens0"])])
        self.bursts["sync"] += 1
        self.count_host_sync()
        self.tokens_emitted += k * len(batch_uids)
        toks = out.cpu().numpy()[:, :len(batch_uids)]  # the one device→host copy
        if self._log_tokens:
            # log what the burst WROTE to the KV cache: step i writes its
            # input token's KV, so positions [seen, seen+k) hold the entry
            # token followed by the first k-1 outputs
            for i, desc in enumerate(descs):
                desc.tokens.fence()  # order after drained pipelined segments
                desc.tokens.append(entries[i])
                desc.tokens.extend(int(t) for t in toks[:-1, i])
        return toks

    def decode_burst_async(self, batch_uids, batch_tokens, k, sample=None, prev=None):
        """Pipelined ``decode_burst``: dispatches the k-step burst and
        returns an :class:`AsyncBurstHandle` WITHOUT any device→host
        wait; the caller fences one burst late, so the host packs and
        dispatches burst k+1 while burst k executes.

        ``prev=None`` is the pipeline's cold start: entry tokens come
        from ``batch_tokens`` (host ints, e.g. ``put()``'s last outputs).
        With ``prev``, entry tokens chain ON THE DEVICE from the previous
        handle's last output row (``prev.entry_next``) and
        ``batch_tokens`` is ignored; the uid order must match ``prev``'s
        exactly (the scheduler drains the pipeline whenever the live set
        changes). Sampled chains also carry the DFA state row from
        ``prev.st``, so constrained streams equal the sync path's.
        Token-log segments go in as pending device segments
        (:meth:`TokenLog.append_device`), fenced when something reads
        them."""
        k, sampled, specs, descs = self._burst_setup(batch_uids, k, sample, prev)
        ms = self.max_seqs
        parts = self._pack_rows(descs, k, advance=True)
        if sampled:
            self._resolve_seeds(specs)
            parts.append(pack_sample_meta(specs, ms, dfa=self._dfa_rows(batch_uids)))
        meta = np.concatenate(parts)
        entry_np = None
        if prev is None:
            # cold start: the host entry row rides behind the vector, one copy
            entry_full = np.zeros(ms, np.int32)
            for i, tok in enumerate(batch_tokens):
                entry_full[i] = int(np.asarray(tok).reshape(-1)[-1])
            entry_np = entry_full[:len(batch_uids)].copy()
            wire = self._upload(np.concatenate([meta, entry_full]))
            meta, entry = wire[:meta.size], wire[meta.size:]
        else:
            meta, entry = self._upload(meta), prev.entry_next  # the device row, no sync
        lay = _burst_layout(ms, self.max_blocks_per_seq, lora=self.lora_store is not None,
                            sampled=sampled, async_entry=True)
        # a sampled chain's DFA states carry on the device; the packed
        # state row (the host's, one burst behind) serves the cold start
        out, st = self._run_burst(meta, lay, k, sampled, entry,
                                  st=prev.st if prev is not None else None)
        self.bursts["async"] += 1
        self.tokens_emitted += k * len(batch_uids)
        handle = AsyncBurstHandle(self, batch_uids, descs, k, out, st=st, entry_np=entry_np,
                                  prev=prev)
        if self._log_tokens:
            # KV content over [seen, seen+k) = the entry token plus the
            # first k-1 outputs, as in the sync path, pending on the
            # device until something fences
            for i, desc in enumerate(descs):
                desc.tokens.append_device(
                    lambda i=i, h=handle: [int(h.entry_values()[i])]
                    + [int(t) for t in h.fetch()[:-1, i]])
        return handle

    # -------------------------------------------- speculative decoding
    def propose_drafts(self, batch_uids, batch_tokens, max_lens=None):
        """Host-side n-gram (prompt-lookup) drafting against each
        sequence's KV-content token log plus its pending entry token. →
        one (possibly empty) list of draft ids per uid; empty when spec
        decoding is off, the per-sequence accept EMA disabled drafting
        for that uid, ``max_lens[i]`` caps it to 0, or the log holds no
        recurring suffix n-gram."""
        if self.spec is None:
            return [[] for _ in batch_uids]
        out = []
        for i, (uid, tok) in enumerate(zip(batch_uids, batch_tokens)):
            desc = self.state_manager.query(uid)
            cap = self.spec.draft_len(uid)
            if max_lens is not None:
                cap = min(cap, int(max_lens[i]))
            if desc is None or cap < 1:
                out.append([])
                continue
            self.count_host_sync()  # the entry token, from the previous step's host copy
            entry = int(np.asarray(tok).reshape(-1)[-1])
            desc.tokens.fence()
            out.append(self.spec.drafter.propose(desc.tokens + [entry], cap))
        return out

    def verify_burst(self, batch_uids, batch_tokens, batch_drafts, sample=None):
        """Score each sequence's entry token plus its draft tokens in ONE
        ragged forward — the drafts enter as a (d+1)-token chunk through
        the same paged path a prefill chunk takes — and accept the
        longest draft prefix matching the model's own choices, followed
        by the model's next token at the first mismatch.

        Greedy (``sample=None``): the model's choice is the argmax, so
        the emitted stream equals stepwise greedy decoding. Sampled (a
        spec dict or per-uid list): position ``j``'s choice is drawn from
        the filtered target with the SAME counter key ``(seed, pos0 + j +
        1)`` stepwise decode would use there, and a draft survives iff it
        equals that draw. The n-gram drafter proposes point-mass drafts,
        so accept-iff-equal IS the rejection-sampling correction, and the
        emitted stream equals the spec-off sampled stream per seed.

        → ``(tokens [n, d+1] int32, accepted [n] int64)``: row ``i``
        emits ``tokens[i, :accepted[i] + 1]``. KV blocks are reserved for
        the full ``d+1`` tokens up front, but ``seen_tokens`` and the
        token log advance only by the accepted count; the rejected tail
        is abandoned in place and trailing whole blocks return to the
        pool. The tokens and accept counts leave the device in one
        copy."""
        if self.spec is None:
            raise RuntimeError("speculative decoding is disabled "
                               "(config.spec_decode / DS_SPEC_DECODE)")
        mode, specs = self._classify_sample(sample, len(batch_uids))
        sampled = mode == "packed"
        if self._any_bound(batch_uids):
            raise RuntimeError(
                "constrained sequences cannot enter verify bursts — the "
                "drafter proposed tokens without the DFA mask; schedulers "
                "route schema-bound sequences through plain bursts")
        if not len(batch_uids) == len(batch_tokens) == len(batch_drafts):
            raise ValueError(f"{len(batch_uids)} uids vs {len(batch_tokens)} "
                             f"tokens vs {len(batch_drafts)} drafts")
        if len(batch_uids) > self.max_seqs:
            raise ValueError(f"{len(batch_uids)} sequences > "
                             f"max_ragged_sequence_count={self.max_seqs}")
        d = max((len(dr) for dr in batch_drafts), default=0)
        if d < 1:
            raise ValueError("verify_burst needs at least one draft token; "
                             "use put()/decode_burst for draft-free decoding")
        descs, err = self._validate_burst(batch_uids, d + 1)
        if err is not None:
            raise err
        ms, mb = self.max_seqs, self.max_blocks_per_seq
        lora_on = self.lora_store is not None
        toks = np.zeros((ms, d + 1), np.int32)
        dlen = np.zeros(ms, np.int32)
        entries = self._entries(batch_tokens)
        rows = self._pack_rows(descs, d + 1)
        for i, (entry, drafts) in enumerate(zip(entries, batch_drafts)):
            toks[i] = entry  # inert pad past the drafts: dlen masks acceptance
            toks[i, 1:1 + len(drafts)] = [int(t) for t in drafts]
            dlen[i] = len(drafts)
        parts = [toks.ravel(), dlen] + rows
        if sampled:
            self._resolve_seeds(specs)
            parts.append(pack_sample_meta(specs, ms))
        meta = self._upload(np.concatenate(parts))
        lay = _verify_layout(ms, mb, d, lora=lora_on, sampled=sampled)
        nxt, acc = self._verify(meta, lay, ms, d, sampled)
        # THE one device→host copy of a verify: tokens and accept counts
        # leave together. The JAX engine packs them into one vector only
        # under async_burst and counts its two copies as two sync sites
        # otherwise: the count follows its
        self.count_host_sync(1 if self.async_burst else 2)
        wire = torch.cat([nxt.reshape(-1), acc]).cpu().numpy()
        out = wire[:ms * (d + 1)].reshape(ms, d + 1)
        acc = wire[ms * (d + 1):].astype(np.int64)
        n = len(batch_uids)
        for i, desc in enumerate(descs):
            a = int(acc[i])
            self.tokens_emitted += a + 1
            # KV positions [seen, seen+a] hold the entry token and the a
            # accepted drafts; the bonus token out[i, a] is the NEXT
            # step's entry and was never written (same convention as the
            # plain burst). Advance by accepted only, then return whole
            # unused trailing blocks.
            desc.advance(a + 1)
            if self._log_tokens:
                desc.tokens.fence()
                desc.tokens.append(entries[i])
                desc.tokens.extend(int(t) for t in out[i, :a])
            self.state_manager.release_unused_blocks(desc)
            if int(dlen[i]):
                self.spec.note(desc.uid, accepted=a, drafted=int(dlen[i]))
        return out[:n], acc[:n]

    def _verify(self, meta, lay, ms, d, sampled):
        """The verify's device work: one ragged forward over ``ms * (d +
        1)`` tokens (``last_index = arange(T)`` selects every token's
        logits), each position's pick — the argmax, or the counter-keyed
        draw from its filtered target — and the longest matching draft
        prefix. → (picks int32 [ms, d+1], accepted int32 [ms]), on the
        device; nothing here reads a device value on the host."""
        toks = meta[slice(*lay["tokens"])].reshape(ms, d + 1)
        dlen = meta[slice(*lay["dlen"])]
        token_seq = meta[slice(*lay["token_seq"])]
        pos0 = meta[slice(*lay["pos0"])]
        T = ms * (d + 1)
        steps = torch.arange(d + 1, dtype=torch.int32, device=self.device)
        # each sequence enters as one (d+1)-token chunk at positions
        # pos0..pos0+d, exactly a packed prefill chunk: the layer writes
        # the chunk's KV first and attention masks by position, so
        # within-chunk causality holds as it does for split prefills
        batch = {"token_ids": toks.reshape(-1),
                 "token_seq": token_seq.repeat_interleave(d + 1),
                 "token_pos": (pos0[:, None] + steps[None, :]).reshape(-1),
                 "block_tables": meta[slice(*lay["tables"])].reshape(ms + 1, -1),
                 "last_index": torch.arange(T, dtype=torch.int32, device=self.device)}
        if "seq_adapters" in lay:
            batch["seq_adapters"] = meta[slice(*lay["seq_adapters"])]
        logits = self._forward(batch)
        if not sampled:
            nxt = logits.argmax(dim=-1).to(torch.int32)
        else:
            # position j of row i draws with key (seed[i], pos0[i] + j +
            # 1), the key stepwise decode uses for that position
            temp, topk, topp, seed, _, _ = unpack_sample_meta(meta[slice(*lay["sample_meta"])],
                                                              ms)
            rep = lambda x: x.repeat_interleave(d + 1)  # noqa: E731
            pos = (pos0[:, None] + steps[None, :] + 1).reshape(-1)
            nxt = sample_rows(logits, token_keys(self._base_key, rep(seed), pos), rep(temp),
                              rep(topk), rep(topp))
        nxt = nxt.reshape(ms, d + 1)
        # draft j survives iff every earlier draft did AND it equals the
        # model's own pick there: the sum of the running cumprod counts
        # the matching prefix
        match = (toks[:, 1:] == nxt[:, :-1]) & (steps[None, :d] < dlen[:, None])
        acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
        return nxt, acc

    # ---------------------------------------------- constrained decoding
    def bind_schema(self, uid, schema, token_strings=None, eos_token_id=None):
        """Constrain ``uid``'s generated tokens to ``schema``: a
        :class:`~deepspeed_tpu_torch.inference.structured.grammar.CompiledSchema`,
        or a raw JSON-schema dict / regex string compiled through the
        process-wide schema cache (``token_strings`` — the vocab's
        per-token surface strings — required then). The token-DFA mask
        composes into every later on-device pick of ``uid``. → the
        leased slot."""
        if self.structured is None:
            raise RuntimeError("constrained decoding is disabled "
                               "(config.structured / DS_CONSTRAINED)")
        if not isinstance(schema, CompiledSchema):
            if token_strings is None:
                raise ValueError(
                    "raw schemas need token_strings to compile against — "
                    "pass a CompiledSchema or the vocab surface strings")
            schema = schema_cache().get_or_compile(schema, token_strings,
                                                   eos_token_id=eos_token_id)
        return self.structured.bind(uid, schema)

    def advance_schema(self, uid, token):
        """Advance ``uid``'s authoritative host DFA state through one
        ACCEPTED token (no-op → 0 for unconstrained uids). Schedulers
        call this from their accept loop only, so tokens a burst drew
        past EOS/max_new and then discarded never advance it."""
        if self.structured is None:
            return 0
        return self.structured.advance(uid, int(token))

    def schema_accepting(self, uid):
        """True when ``uid``'s constraint (if any) is at an accepting DFA
        state: the emitted stream so far is schema-complete and EOS is
        currently grammatical."""
        return self.structured is None or self.structured.accepting(uid)

    def rewind(self, uid, n_tokens):
        """Roll ``uid`` back by ``n_tokens`` of KV content; now-unused
        trailing blocks return to the pool. → new seen_tokens."""
        desc = self.state_manager.query(uid)
        if desc is None:
            raise KeyError(f"unknown sequence {uid}")
        self.state_manager.rewind_sequence(desc, int(n_tokens))
        return desc.seen_tokens

    def _reclaimable_blocks(self):
        """Blocks an allocation can actually obtain right now: the free
        list plus unreferenced cached blocks the prefix cache will evict
        under pressure. Every pool-exhaustion check compares against this
        — cached-but-evictable blocks must never cause a spurious reject."""
        free = self.kv_cache.free_blocks
        if self.prefix_cache is not None:
            free += self.prefix_cache.evictable_blocks
        return free

    @property
    def evictable_blocks(self):
        """Unreferenced prefix-cache blocks (0 without a cache)."""
        return self.prefix_cache.evictable_blocks if self.prefix_cache is not None else 0

    def prefix_match(self, uid, prompt_tokens):
        """Start tracking ``uid`` with its longest cached prompt prefix
        pre-populated (no-op returning 0 when the prefix cache is off or
        the sequence already exists). → the number of leading prompt
        tokens whose KV is already in the pool; the caller starts
        prefill at that offset. Always capped one token short of the
        prompt, so the last prompt token is recomputed and first-token
        logits exist."""
        if self.prefix_cache is None:
            return 0
        desc = self.state_manager.query(uid)
        if desc is not None:
            return desc.cached_tokens
        prompt = [int(t) for t in np.atleast_1d(np.asarray(prompt_tokens))]
        desc = self.state_manager.get_or_create_sequence(uid, prompt_tokens=prompt)
        return desc.cached_tokens

    def prefix_match_len(self, prompt_tokens):
        """Read-only twin of :meth:`prefix_match`: → leading tokens of
        ``prompt_tokens`` whose KV is cached (either tier), without
        creating a sequence, taking a lease or touching hit-rate stats."""
        if self.prefix_cache is None:
            return 0
        prompt = [int(t) for t in np.atleast_1d(np.asarray(prompt_tokens))]
        return self.prefix_cache.match_len(prompt)

    def prefetch_prefix(self, prompt_tokens):
        """Fire-and-forget: stage this prompt's tier-2 KV extension on
        the spill tier's prefetch worker so the host→device copy
        overlaps queueing (no-op without a tier). Safe from any thread."""
        if self.kv_tier is not None:
            self.kv_tier.prefetch([int(t) for t in np.atleast_1d(np.asarray(prompt_tokens))])

    def export_prefix(self, prompt_tokens, max_blocks=None):
        """→ a handoff record of this prompt's cached prefix (chained-key
        identities plus host KV, int8 when the tier quantizes), or None
        when no spill tier is attached or nothing is cached."""
        if self.kv_tier is None:
            return None
        prompt = [int(t) for t in np.atleast_1d(np.asarray(prompt_tokens))]
        return self.kv_tier.export_chain(prompt, max_blocks=max_blocks)

    def import_prefix(self, record):
        """Adopt another engine's exported prefix into the local spill
        tier (validated; raises KVTierCorruptionError on a forged/torn
        record). Safe from any thread. → blocks adopted (0 tierless)."""
        if self.kv_tier is None or record is None:
            return 0
        return self.kv_tier.import_chain(record)

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
        """Adopt a published adapter version (sha256-validated commit
        protocol; raises WeightPublicationError with nothing adopted on
        a forged/torn publication). Hot copies hot-swap in place."""
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
        """Discard everything the engine holds for ``uid`` — live KV
        blocks (retired into the prefix cache when it is on) AND any
        suspended host copy."""
        suspended = self._suspended.pop(uid, None) is not None
        desc = self.state_manager.query(uid)
        if desc is not None:
            desc.tokens.fence()
            self.state_manager.flush_sequence(uid)
        elif not suspended:
            raise KeyError(f"unknown sequence {uid}")
        if self.spec is not None:
            self.spec.forget(uid)
        if self.lora_store is not None:
            self.lora_store.release(uid)  # drop the adapter-slot lease
        if self.structured is not None:
            self.structured.release(uid)  # drop the schema lease + DFA state

    def suspend(self, uid):
        """Swap a live sequence's KV blocks to host memory and release
        them for other sequences. The sequence stops being tracked until
        :meth:`resume`."""
        desc = self.state_manager.query(uid)
        if desc is None:
            raise KeyError(f"unknown sequence {uid}")
        if uid in self._suspended:
            raise ValueError(f"sequence {uid} is already suspended")
        # Shared prefix blocks belong to the radix trie and other live
        # sequences may attend over them: copy their KV into the handle
        # but leave the blocks cached (decref only). The resumed sequence
        # gets private copies.
        shared = desc.blocks[:desc.shared_blocks]
        desc.tokens.fence()
        handle = self.kv_cache.offload(desc.blocks, keep=shared)
        self.count_host_sync()
        if self.prefix_cache is not None:
            self.prefix_cache.release_lease(uid)
        self._suspended[uid] = {"handle": handle, "seen_tokens": desc.seen_tokens,
                                "tokens": list(desc.tokens)}
        desc.blocks = []  # freed by offload / kept by the trie; never double-free
        desc.shared_blocks = 0
        self.state_manager.drop_sequence(uid)

    def is_suspended(self, uid):
        """True when ``uid``'s KV lives in a suspended host copy."""
        return uid in self._suspended

    def suspended_blocks(self, uid):
        """Pool blocks a :meth:`resume` of ``uid`` would need."""
        ent = self._suspended.get(uid)
        if ent is None:
            raise KeyError(f"sequence {uid} is not suspended")
        return int(ent["handle"]["k"].shape[1])

    def resume(self, uid):
        """Restore a suspended sequence's KV into freshly reserved blocks
        (ids may differ; the descriptor re-points at them) and resume
        tracking — decode continues exactly where it stopped."""
        ent = self._suspended.get(uid)
        if ent is None:
            raise KeyError(f"sequence {uid} is not suspended")
        # validate everything before restore() writes the pool
        if self.state_manager.query(uid) is not None:
            raise ValueError(f"sequence {uid} was re-registered live while "
                             f"suspended; flush() it before resume()")
        n = ent["handle"]["k"].shape[1]
        if n > self._reclaimable_blocks():
            raise RuntimeError(f"KV pool exhausted: resume needs {n} blocks, "
                               f"{self._reclaimable_blocks()} reclaimable")
        if self.state_manager.n_tracked_sequences >= \
                self.state_manager.max_tracked_sequences:
            raise RuntimeError("max_tracked_sequences exceeded; flush() a live "
                               "sequence before resume()")
        if self.prefix_cache is not None:
            self.prefix_cache.ensure_free(n)
        blocks = self.kv_cache.restore(ent["handle"])
        del self._suspended[uid]
        desc = self.state_manager.get_or_create_sequence(uid)
        desc.extend_blocks(blocks)
        desc.seen_tokens = ent["seen_tokens"]
        # every restored block is private (shared_blocks stays 0); the
        # token log survives suspension so retire can still cache them
        desc.tokens = list(ent.get("tokens", ()))
        return desc.seen_tokens

    def destroy(self):
        """Drop the params and the KV pool (back-to-back engine builds)."""
        self.params = None
        self.kv_cache = None
        self.state_manager = None
        self._rope = None
        self.prefix_cache = None
        if self.kv_tier is not None:
            self.kv_tier.shutdown()  # stop the prefetch worker + drop host KV
        self.kv_tier = None
        self._suspended = {}
        if self.lora_store is not None:
            self.lora_store.shutdown()  # stop the adapter prefetch worker
        self.lora_store = None
        self.spec = None
        self.structured = None

    @property
    def free_blocks(self):
        return self.kv_cache.free_blocks
