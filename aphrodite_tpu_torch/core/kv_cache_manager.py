"""Per-request KV page accounting on top of BlockPool.

Re-design of the reference KVCacheManager
(aphrodite/v1/core/kv_cache_manager.py:16): prefix-hash lookup at admission
(`get_computed_blocks`), incremental `allocate_slots` for every scheduling
step, preempt-by-recompute (no swap). Prefix caching can be turned off
(``enable_caching=False``): then no page is hashed and nothing is hit.
Every page hash of a request with images mixes in their content hash
(``request.mm_hash``; ``kv_cache_manager.py:45, 107, 119`` of the JAX
package), so equal placeholder ids with other images never hit.
"""
from __future__ import annotations

from typing import Optional

from aphrodite_tpu_torch.core.block_pool import (BlockPool, KVCacheBlock,
                                                 hash_block_tokens,
                                                 hash_request_tokens)
from aphrodite_tpu_torch.core.request import Request
from aphrodite_tpu_torch.utils import cdiv


class KVCacheManager:

    def __init__(self, num_blocks: int, block_size: int,
                 enable_caching: bool = True) -> None:
        self.block_size = block_size
        self.enable_caching = enable_caching
        self.pool = BlockPool(num_blocks, enable_caching)
        self.req_to_blocks: dict[str, list[KVCacheBlock]] = {}
        self.req_to_hashes: dict[str, list[int]] = {}

    # --------------------------------------------------------------- admission
    def get_computed_blocks(self, request: Request
                            ) -> tuple[list[KVCacheBlock], int]:
        """Longest cached prefix (in full pages) for a new request."""
        if not self.enable_caching:
            return [], 0
        # Hash over all tokens (not just the prompt) so a preempted request
        # re-admitted after recompute can reuse pages of its own output too.
        hashes = self.req_to_hashes.get(request.request_id)
        if hashes is None:
            hashes = hash_request_tokens(self.block_size,
                                         request.all_token_ids,
                                         extra_key=request.mm_hash)
            self.req_to_hashes[request.request_id] = hashes
        computed: list[KVCacheBlock] = []
        for h in hashes:
            block = self.pool.get_cached_block(h)
            if block is None:
                break
            computed.append(block)
        # Never report the full prompt as cached: at least one token must be
        # scheduled so the model produces the next-token logits.
        if computed and len(computed) * self.block_size >= request.num_tokens:
            computed.pop()
        return computed, len(computed) * self.block_size

    # -------------------------------------------------------------- allocation
    def allocate_slots(
        self,
        request: Request,
        num_new_tokens: int,
        new_computed_blocks: Optional[list[KVCacheBlock]] = None,
        num_lookahead_tokens: int = 0,
    ) -> Optional[list[KVCacheBlock]]:
        """Ensure pages exist for `num_new_tokens` past what's computed.
        Returns newly-allocated pages, or None if the pool can't satisfy it.
        """
        assert num_new_tokens > 0
        new_computed_blocks = new_computed_blocks or []
        req_blocks = self.req_to_blocks.setdefault(request.request_id, [])

        num_computed = (request.num_computed_tokens +
                        len(new_computed_blocks) * self.block_size)
        total_needed = num_computed + num_new_tokens + num_lookahead_tokens
        num_required_blocks = cdiv(total_needed, self.block_size)
        num_new_blocks = (num_required_blocks - len(req_blocks) -
                          len(new_computed_blocks))

        # Free blocks that would be evicted must not count the cache hits we
        # are about to pin.
        num_evictable_hits = sum(1 for b in new_computed_blocks
                                 if b.ref_cnt == 0)
        if num_new_blocks > (self.pool.get_num_free_blocks() -
                             num_evictable_hits):
            return None

        # Pin the prefix-cache hits, then extend with fresh pages.
        if new_computed_blocks:
            self.pool.touch(new_computed_blocks)
            req_blocks.extend(new_computed_blocks)
        new_blocks = (self.pool.get_new_blocks(num_new_blocks)
                      if num_new_blocks > 0 else [])
        req_blocks.extend(new_blocks)

        # Register hashes for pages that will be *full* after this step
        # (speculative lookahead slots are excluded — their contents are not
        # final).
        if self.enable_caching:
            hashes = self.req_to_hashes.get(request.request_id)
            if hashes is None:
                hashes = hash_request_tokens(self.block_size,
                                             request.prompt_token_ids,
                                             extra_key=request.mm_hash)
                self.req_to_hashes[request.request_id] = hashes
            # Extend hash chain over generated tokens.
            all_tokens = request.all_token_ids
            num_full = min(num_computed + num_new_tokens,
                           request.num_tokens) // self.block_size
            parent = hashes[-1] if hashes else None
            while len(hashes) < num_full:
                start = len(hashes) * self.block_size
                parent = hash_block_tokens(
                    parent, tuple(all_tokens[start:start + self.block_size]),
                    extra_key=request.mm_hash)
                hashes.append(parent)
            num_cached = sum(1 for b in req_blocks
                             if b.block_hash is not None)
            self.pool.cache_full_blocks(req_blocks, hashes,
                                        num_cached_blocks=num_cached,
                                        num_full_blocks=num_full)
        return new_blocks

    # -------------------------------------------------------------------- free
    def free(self, request: Request) -> None:
        blocks = self.req_to_blocks.pop(request.request_id, [])
        self.req_to_hashes.pop(request.request_id, None)
        # Tail-first so the longest shared prefix is evicted last.
        self.pool.free_blocks(list(reversed(blocks)))

    def reset_prefix_cache(self) -> bool:
        if not self.enable_caching:
            return True  # nothing is cached
        return self.pool.reset_prefix_cache()

    def get_block_ids(self, request_id: str) -> list[int]:
        return [b.block_id for b in self.req_to_blocks.get(request_id, [])]
