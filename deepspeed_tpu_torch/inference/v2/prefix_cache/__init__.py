"""Radix prefix cache: cross-request KV reuse for the v2 ragged engine.

Port of ``deepspeed_tpu/inference/v2/prefix_cache``. Block-granular,
refcounted prefix sharing in the style of SGLang's RadixAttention over the
paged pool: completed KV blocks become content-addressable (a trie keyed
by chained hashes of block-aligned token chunks), so a request whose
prompt shares a block-aligned prefix with earlier traffic starts with that
prefix's block table pre-populated and prefills only its unshared suffix.
"""

from deepspeed_tpu_torch.inference.v2.prefix_cache.manager import (PrefixCacheManager,
                                                                   prefix_cache_enabled)
from deepspeed_tpu_torch.inference.v2.prefix_cache.radix_index import (RadixNode,
                                                                       RadixPrefixIndex)

__all__ = ["PrefixCacheManager", "prefix_cache_enabled", "RadixPrefixIndex",
           "RadixNode"]
