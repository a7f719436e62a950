"""Cross-request KV reuse over the blocked KV pool.

``PrefixCacheManager`` layers refcounted, content-addressable block
ownership on top of :class:`BlockedKVCache`/:class:`BlockedAllocator`:

- every physical block is either FREE (allocator free list), PRIVATE
  (owned by exactly one live sequence), or CACHED (owned by the radix
  trie; ``ref`` counts the live sequences currently sharing it);
- only FULL, immutable blocks are ever shared — each sequence's
  trailing partial block stays private, so the hot path needs no
  copy-on-write;
- a new sequence ``acquire()``s its longest cached prefix (capped one
  token short of the prompt so the model always recomputes the last
  prompt token and produces first-token logits) and starts prefill at
  the first uncached token;
- on retire/flush the sequence's completed full blocks are inserted
  into the trie instead of freed (duplicates of already-cached content
  are freed immediately), and its prefix lease is dropped;
- allocation pressure reclaims unreferenced cached blocks in LRU order
  (``reserve``/``ensure_free``), so caching only ever trades IDLE pool
  space for hits — it can never starve live sequences.

Port: a copy of ``deepspeed_tpu/inference/v2/prefix_cache/manager.py``.
``prefix_cache_enabled`` reads the config only (the ``DS_PREFIX_CACHE``
switch waits with the other ``DS_*`` switches), the lock is a plain
``RLock``, and the ``DS_SANITIZE`` audit after every mutation is left to
callers (:func:`deepspeed_tpu_torch.utils.sanitize.check_prefix_index`);
ROADMAP.md, port queue item 4. A promotion restores the claimed chain
through the pool's ``restore`` on the pool's device.
"""

import threading

from deepspeed_tpu_torch.inference.v2.prefix_cache.radix_index import RadixPrefixIndex


def prefix_cache_enabled(config) -> bool:
    """The config gate (``config.enabled``)."""
    return bool(getattr(config, "enabled", False))


class PrefixCacheManager:

    def __init__(self, kv_cache, max_cached_blocks=0):
        self.kv_cache = kv_cache
        self.block_size = int(kv_cache.block_size)
        # 0 = bounded only by pool pressure (LRU eviction on demand)
        self.max_cached_blocks = int(max_cached_blocks)
        self.index = RadixPrefixIndex(self.block_size)
        self._leases = {}  # uid -> matched node path (refs held)
        # request-level + token-level hit accounting
        self.lookups = 0
        self.hits = 0
        self.tokens_saved = 0
        self.insertions = 0
        # host spill tier (kv_tier.TierManager), attached by the engine;
        # None = eviction drops blocks (pre-tier behavior, bit for bit)
        self.tier = None
        self.tier2_hits = 0
        self.tier2_tokens_saved = 0
        # the gateway pump thread and client threads (suspend/flush)
        # both mutate the trie + lease table; RLock because release()
        # re-enters release_lease()
        self._lock = threading.RLock()

    # ------------------------------------------------------------- capacity
    @property
    def evictable_blocks(self):
        """Cached blocks no live sequence references — reclaimable
        capacity the allocator can get back on demand."""
        return self.index.evictable_blocks

    @property
    def cached_blocks(self):
        return self.index.num_nodes

    def attach_tier(self, tier):
        """Plug the host spill tier in (engine construction): trie
        eviction becomes demotion, and acquires extend matches with
        promoted tier-2 chains."""
        with self._lock:
            self.tier = tier

    def _evict_locked(self, n_blocks, protect=frozenset()):
        """Evict up to ``n_blocks`` from the trie, demoting the victims'
        KV to tier-2 first when a tier is attached (the gather reads the
        pool BEFORE the caller frees the ids). → freed block ids."""
        if self.tier is None:
            return self.index.evict(n_blocks, protect)
        victims = self.index.evict_nodes(n_blocks, protect)
        if victims:
            self.tier.demote(victims)
        return [block for _, _, block in victims]

    def ensure_free(self, num_blocks):
        """Evict unreferenced cached blocks (LRU) until the allocator has
        ``num_blocks`` free, or the trie has nothing left to give."""
        with self._lock:
            deficit = num_blocks - self.kv_cache.free_blocks
            if deficit > 0:
                freed = self._evict_locked(deficit)
                if freed:
                    self.kv_cache.free(freed)

    def reserve(self, num_blocks):
        """Drop-in for ``BlockedKVCache.reserve`` that reclaims cached
        blocks under pressure before allocating."""
        self.ensure_free(num_blocks)
        return self.kv_cache.reserve(num_blocks)

    # ------------------------------------------------------------ sequences
    def acquire(self, uid, prompt_tokens):
        """Match ``prompt_tokens``' longest cached block-aligned prefix
        and lease it to ``uid`` (refs held until :meth:`release` /
        :meth:`release_lease`). → ``(block_ids, cached_tokens)``. With a
        spill tier attached, the trie match is first EXTENDED with any
        contiguous tier-2 chain (restored into fresh pool blocks behind
        the prefetch fence), so the lease covers both tiers."""
        if self.tier is not None:
            # fence BEFORE the manager lock: the prefetch worker needs
            # this lock for its trie walk, so fencing under it deadlocks
            self.tier.wait_prefetch(prompt_tokens)
        with self._lock:
            if uid in self._leases:
                raise ValueError(f"sequence {uid} already holds a prefix lease")
            # never match the WHOLE prompt: the last prompt token must be
            # recomputed so its logits exist to sample the first new token
            max_blocks = (len(prompt_tokens) - 1) // self.block_size
            if self.tier is not None:
                self._promote_tier_hits_locked(prompt_tokens, max_blocks)
            path = self.index.match(prompt_tokens, max_blocks)
            self.lookups += 1
            if not path:
                return [], 0
            tier2_blocks = 0
            for node in path:
                self.index.incref(node)
                if node.tier2:
                    # consume the promotion flag at first lease: each
                    # restored block attributes to exactly one request
                    node.tier2 = False
                    tier2_blocks += 1
            self._leases[uid] = path
            cached = len(path) * self.block_size
            self.hits += 1
            self.tokens_saved += cached
            if tier2_blocks:
                self.tier2_hits += 1
                self.tier2_tokens_saved += tier2_blocks * self.block_size
            return [node.block_id for node in path], cached

    def _promote_tier_hits_locked(self, prompt_tokens, max_blocks):
        """Restore the contiguous tier-2 chain extending this prompt's
        trie match into freshly reserved pool blocks and insert them as
        (tier2-flagged) trie nodes — the subsequent ``match`` then
        leases them exactly like tier-1 content. Capacity for the
        restore comes from evicting OTHER ref-0 blocks (the matched
        path is protected: demoting the prefix being extended would be
        self-defeating); when the pool stays short, only the head of
        the chain is promoted and the rest goes back to the store."""
        tier = self.tier
        bs = self.block_size
        path = self.index.match(prompt_tokens, max_blocks)
        parent = path[-1] if path else self.index.root
        start = len(path)
        # claim the chain first (pops store records): eviction below may
        # demote into the store and LRU-drop what a mere peek found
        claimed = []
        parent_key = parent.key
        for i in range(start, max_blocks):
            chunk = tuple(int(t) for t in prompt_tokens[i * bs:(i + 1) * bs])
            item = tier.claim(parent_key, chunk)
            if item is None:
                break
            claimed.append((chunk, item))
            parent_key = item["record"]["key"]
        if not claimed:
            return
        want = len(claimed)
        if self.kv_cache.free_blocks < want:
            freed = self._evict_locked(want - self.kv_cache.free_blocks,
                                       protect=set(path))
            if freed:
                self.kv_cache.free(freed)
        n = min(want, self.kv_cache.free_blocks)
        for _chunk, item in claimed[n:]:
            tier.unclaim(item)  # pool full: tail stays in tier-2
        claimed = claimed[:n]
        if not claimed:
            return
        from deepspeed_tpu_torch.inference.v2.kv_tier.quant import concat_handles
        handle = concat_handles([item["handle"] for _, item in claimed],
                                device=self.kv_cache.device)
        blocks = self.kv_cache.restore(handle)  # one scatter into the pool
        node = parent
        for (chunk, _item), block in zip(claimed, blocks):
            node = self.index.insert_child(node, chunk, block)
            node.tier2 = True
        tier.note_promoted(len(claimed))

    def invalidate_for_version(self, version):
        """Weight-refresh invalidation: drop EVERY cached block (both the
        trie and, via the attached tier, the host store) and re-key the
        trie root with the new weight version. All chained keys derive
        from the root key, so post-refresh cached identities — and the
        ``root_key`` stamped into exported handoff records — are version-
        tagged: a record exported under version N fails the importing
        replica's root-key check under version N+1 (typed reject, nothing
        adopted). Requires an idle cache (no outstanding leases): the
        gateway quiesces in-flight sequences before swapping weights."""
        with self._lock:
            if self._leases:
                raise RuntimeError(
                    f"prefix-cache invalidation with {len(self._leases)} "
                    f"lease(s) outstanding — quiesce in-flight sequences first")
            freed = self.index.clear(new_root_key=int(version))
            if freed:
                self.kv_cache.free(freed)
            if self.tier is not None:
                self.tier.invalidate()

    def match_len(self, prompt_tokens):
        """Read-only probe: how many leading tokens of ``prompt_tokens``
        this cache already holds. Takes no lease, bumps no refcount and
        skews no hit-rate stats — the fleet router calls this on every
        placement decision, and a routing probe must not look like
        traffic. Capped one token short like :meth:`acquire` (the match
        an admitted request would actually get). With a spill tier
        attached the probe counts demoted chain extensions too, so
        fleet routing sees both tiers."""
        with self._lock:
            max_blocks = (len(prompt_tokens) - 1) // self.block_size
            path = self.index.match(prompt_tokens, max_blocks)
            n = len(path)
            if self.tier is not None and n < max_blocks:
                parent_key = path[-1].key if path else self.index.root.key
                n += self.tier.probe_chain(parent_key, prompt_tokens, n,
                                           max_blocks, touch=False)
            return n * self.block_size

    def release_lease(self, uid):
        """Drop ``uid``'s prefix refs without inserting anything (the
        suspend path — its blocks are leaving the pool, not retiring)."""
        with self._lock:
            for node in self._leases.pop(uid, ()):
                self.index.decref(node)

    def release(self, uid, desc):
        """Retire ``desc``: insert its completed full blocks into the
        trie (duplicates freed), free the trailing partial block, drop
        the prefix lease. This REPLACES ``kv_cache.free(desc.blocks)``
        — a shared prefix block is decref'd, never hard-freed."""
        bs = self.block_size
        with self._lock:
            # only blocks whose token content was recorded are insertable
            full = min(desc.seen_tokens, len(desc.tokens)) // bs
            full = min(full, len(desc.blocks))
            freed = []
            node = self.index.root
            chain = set()
            for i in range(full):
                chunk = tuple(int(t) for t in desc.tokens[i * bs:(i + 1) * bs])
                block = int(desc.blocks[i])
                existing = self.index.lookup_child(node, chunk)
                if existing is not None:
                    # content already cached: our copy is redundant unless it
                    # IS the cached block (a leased shared prefix block)
                    if existing.block_id != block:
                        freed.append(block)
                    node = existing
                    self.index.touch(node)
                    chain.add(node)
                    continue
                if self.max_cached_blocks and \
                        self.index.num_nodes >= self.max_cached_blocks:
                    evicted = self._evict_locked(1, protect=chain)
                    if not evicted:
                        # cache full of referenced blocks: stop chaining here
                        # (a gap would orphan deeper chunks) and free the rest
                        freed.extend(int(b) for b in desc.blocks[i:full])
                        break
                    freed.extend(evicted)
                node = self.index.insert_child(node, chunk, block)
                chain.add(node)
                self.insertions += 1
            freed.extend(int(b) for b in desc.blocks[full:])
            self.release_lease(uid)
            if freed:
                self.kv_cache.free(freed)

    # -------------------------------------------------------------- metrics
    def stats(self):
        """Monitor-facing snapshot (``Serve/PrefixCache/*`` tags)."""
        return {
            "hit_rate": round(self.hits / self.lookups, 4) if self.lookups else 0.0,
            "tokens_saved": self.tokens_saved,
            "cached_blocks": self.cached_blocks,
            "evictions": self.index.evictions,
            "evictable_blocks": self.evictable_blocks,
            "lookups": self.lookups,
            "insertions": self.insertions,
            # request/token attribution of the host spill tier (0s when
            # no tier is attached — the schema stays stable for monitors)
            "tier2_hits": self.tier2_hits,
            "tier2_tokens_saved": self.tier2_tokens_saved,
        }
