"""Radix (trie) index over block-aligned token chunks.

The content-addressing layer of the prefix cache (SGLang's
RadixAttention design over vLLM-style paged KV): every node is exactly
one FULL KV block — ``block_size`` token ids plus the physical block id
holding their KV. Nodes are keyed by a hash CHAINED from the root
(``_chunk_key(parent_key, chunk)``), so a block's identity covers its
entire token history, which is exactly the dependency set of its KV
content. Hash collisions are isolated, not trusted: children with the
same chained key live in a bucket list and lookups compare the stored
token chunk exactly.

Refcounting is PATH-based: matching a prefix increments every node
along the path, so ``ref == 0`` on a node implies ``ref == 0`` on its
whole subtree — the count of ref-0 nodes IS the number of reclaimable
blocks, and eviction can always cascade leaf-by-leaf in LRU order
without stranding a referenced descendant.

Pure host-side bookkeeping; the device only ever sees block ids through
the block tables the sequences build.

Port: a copy of ``deepspeed_tpu/inference/v2/prefix_cache/radix_index.py``.
``_chunk_key`` hashes int tuples with Python's ``hash``, which does not
depend on ``PYTHONHASHSEED`` for ints, so the two packages derive equal
chained keys for equal token chunks.
"""


def _chunk_key(parent_key, chunk):
    """Chained hash of one block-aligned chunk. Module-level so tests can
    monkeypatch it (e.g. to a constant) and exercise collision buckets."""
    return hash((parent_key, chunk))


class RadixNode:
    __slots__ = ("key", "tokens", "block_id", "parent", "children", "ref",
                 "last_used", "tier2")

    def __init__(self, key, tokens, block_id, parent):
        self.key = key
        self.tokens = tokens      # tuple of block_size token ids (None at root)
        self.block_id = block_id  # physical KV block (None at root)
        self.parent = parent
        self.children = {}        # chained key -> [RadixNode] (collision bucket)
        self.ref = 0              # live sequences whose matched path crosses here
        self.last_used = 0
        # promoted from the host spill tier and not yet leased: the first
        # acquire that matches through here consumes the flag for
        # tier-2-hit attribution (promotion metrics without double counts)
        self.tier2 = False

    @property
    def is_leaf(self):
        return not self.children

    def __repr__(self):
        return (f"RadixNode(block={self.block_id}, ref={self.ref}, "
                f"children={sum(len(b) for b in self.children.values())})")


class RadixPrefixIndex:
    """The trie plus its eviction/refcount bookkeeping. All mutation goes
    through methods here so the ref-0 accounting can never drift."""

    def __init__(self, block_size):
        self.block_size = int(block_size)
        self.root = RadixNode(key=0, tokens=None, block_id=None, parent=None)
        self._clock = 0          # monotonic LRU clock
        self.num_nodes = 0       # cached blocks currently owned by the trie
        self._ref0 = 0           # nodes with ref == 0 (== reclaimable blocks)
        self.evictions = 0       # blocks evicted over the index's lifetime

    # ------------------------------------------------------------- queries
    @property
    def evictable_blocks(self):
        return self._ref0

    def lookup_child(self, node, chunk):
        """Exact-content child of ``node`` for ``chunk``, or None. Walks
        the collision bucket so equal chained keys with different token
        content stay isolated."""
        for cand in node.children.get(_chunk_key(node.key, chunk), ()):
            if cand.tokens == chunk:
                return cand
        return None

    def match(self, tokens, max_blocks):
        """Longest cached prefix of ``tokens``: the node path (root
        excluded) covering up to ``max_blocks`` full leading chunks."""
        bs = self.block_size
        node, path = self.root, []
        for i in range(max_blocks):
            child = self.lookup_child(node, tuple(tokens[i * bs:(i + 1) * bs]))
            if child is None:
                break
            path.append(child)
            node = child
        return path

    # ----------------------------------------------------------- mutation
    def touch(self, node):
        self._clock += 1
        node.last_used = self._clock

    def incref(self, node):
        if node.ref == 0:
            self._ref0 -= 1
        node.ref += 1
        self.touch(node)

    def decref(self, node):
        assert node.ref > 0, "decref of an unreferenced radix node"
        node.ref -= 1
        if node.ref == 0:
            self._ref0 += 1
        self.touch(node)

    def insert_child(self, node, chunk, block_id):
        """Adopt ``block_id`` as a new cached child of ``node`` holding
        ``chunk``. The caller guarantees no exact-content child exists."""
        key = _chunk_key(node.key, chunk)
        child = RadixNode(key=key, tokens=tuple(chunk), block_id=int(block_id),
                          parent=node)
        node.children.setdefault(key, []).append(child)
        self.num_nodes += 1
        self._ref0 += 1  # new nodes start unreferenced
        self.touch(child)
        return child

    def _unlink(self, node):
        bucket = node.parent.children[node.key]
        bucket.remove(node)
        if not bucket:
            del node.parent.children[node.key]
        node.parent = None
        self.num_nodes -= 1
        self._ref0 -= 1
        self.evictions += 1

    def clear(self, new_root_key=None):
        """Drop EVERY cached node (weight-refresh invalidation: KV built
        under the old weights must never be matched again) and optionally
        re-key the root. The chained keys of all future insertions derive
        from the root key, so re-keying it to the weight version makes
        every cached identity — and every handoff record exported from
        here — version-tagged. Requires an idle trie (no referenced
        nodes); returns the freed physical block ids."""
        blocks = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            for bucket in node.children.values():
                for child in bucket:
                    assert child.ref == 0, \
                        "prefix-cache clear with a live lease outstanding"
                    blocks.append(child.block_id)
                    stack.append(child)
        self.root.children = {}
        self.evictions += self.num_nodes
        self.num_nodes = 0
        self._ref0 = 0
        if new_root_key is not None:
            self.root.key = new_root_key
        return blocks

    def evict(self, n_blocks, protect=frozenset()):
        """Free up to ``n_blocks`` cached blocks: repeatedly drop the
        least-recently-used ref-0 LEAF (cascading — a parent becomes a
        leaf once its last child goes). ``protect`` is a set of nodes
        that must survive (e.g. a chain mid-insertion). Returns the
        freed physical block ids; shorter than ``n_blocks`` when the
        trie runs out of reclaimable leaves."""
        return [b for _, _, b in self.evict_nodes(n_blocks, protect)]

    def evict_nodes(self, n_blocks, protect=frozenset()):
        """:meth:`evict` returning each victim's full content identity:
        ``(parent_key, tokens, block_id)`` tuples, captured BEFORE the
        unlink severs ``parent``. The KV-tier demotion path re-chains a
        spilled block's identity from exactly these fields."""
        victims = []
        while len(victims) < n_blocks:
            victim = None
            stack = [self.root]
            while stack:
                node = stack.pop()
                for bucket in node.children.values():
                    for child in bucket:
                        if child.ref > 0:
                            stack.append(child)  # subtree may hold ref-0 leaves
                        elif child.is_leaf:
                            if child not in protect and (
                                    victim is None
                                    or child.last_used < victim.last_used):
                                victim = child
                        else:
                            stack.append(child)
            if victim is None:
                break
            victims.append((victim.parent.key, victim.tokens, victim.block_id))
            self._unlink(victim)
        return victims
