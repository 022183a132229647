"""Physical KV page pool with content-hash prefix caching.

Re-design of the reference's BlockPool + FreeKVCacheBlockQueue
(aphrodite/v1/core/block_pool.py:17, kv_cache_utils.py:159): refcounted pages,
an LRU free list with lazy hash-eviction, and chained content hashes over
page-sized token chunks so identical prefixes share pages.

Page 0 is reserved as the null page (pad rows of block tables point at it and
it is never allocated), which lets the device-side gather stay branch-free.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

# Content hash of a full page: (parent_hash, tokens[, extra]) chained.
BlockHash = int
NULL_BLOCK_ID = 0


def hash_block_tokens(parent_hash: Optional[BlockHash],
                      token_ids: tuple[int, ...],
                      extra_key: Optional[object] = None) -> BlockHash:
    return hash((parent_hash, token_ids, extra_key))


def hash_request_tokens(block_size: int, token_ids: list[int],
                        extra_key: Optional[object] = None
                        ) -> list[BlockHash]:
    """Hashes for every *full* page of the token list."""
    hashes: list[BlockHash] = []
    parent: Optional[BlockHash] = None
    for start in range(0, len(token_ids) - block_size + 1, block_size):
        h = hash_block_tokens(parent,
                              tuple(token_ids[start:start + block_size]),
                              extra_key)
        hashes.append(h)
        parent = h
    return hashes


@dataclass
class KVCacheBlock:
    block_id: int
    ref_cnt: int = 0
    block_hash: Optional[BlockHash] = None
    # Doubly-linked free-list pointers.
    prev_free: Optional["KVCacheBlock"] = field(default=None, repr=False)
    next_free: Optional["KVCacheBlock"] = field(default=None, repr=False)


class FreeBlockQueue:
    """LRU doubly-linked list of free (ref_cnt==0) blocks. Eviction candidates
    pop from the head; freshly freed blocks append to the tail, so cached
    blocks survive as long as possible (reference: kv_cache_utils.py:159)."""

    def __init__(self, blocks: list[KVCacheBlock]) -> None:
        self.num_free = len(blocks)
        self._head: Optional[KVCacheBlock] = blocks[0] if blocks else None
        self._tail: Optional[KVCacheBlock] = blocks[-1] if blocks else None
        for i, b in enumerate(blocks):
            b.prev_free = blocks[i - 1] if i > 0 else None
            b.next_free = blocks[i + 1] if i < len(blocks) - 1 else None

    def popleft(self) -> KVCacheBlock:
        if self._head is None:
            raise ValueError("no free blocks")
        block = self._head
        self.remove(block)
        return block

    def remove(self, block: KVCacheBlock) -> None:
        if block.prev_free is not None:
            block.prev_free.next_free = block.next_free
        else:
            self._head = block.next_free
        if block.next_free is not None:
            block.next_free.prev_free = block.prev_free
        else:
            self._tail = block.prev_free
        block.prev_free = block.next_free = None
        self.num_free -= 1

    def append(self, block: KVCacheBlock) -> None:
        if self._tail is None:
            self._head = self._tail = block
            block.prev_free = block.next_free = None
        else:
            self._tail.next_free = block
            block.prev_free = self._tail
            block.next_free = None
            self._tail = block
        self.num_free += 1


class BlockPool:

    def __init__(self, num_blocks: int, enable_caching: bool = True) -> None:
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (one is the null block)")
        self.num_blocks = num_blocks
        self.enable_caching = enable_caching
        self.blocks = [KVCacheBlock(i) for i in range(num_blocks)]
        # Block 0 is the permanently-pinned null block.
        self.null_block = self.blocks[NULL_BLOCK_ID]
        self.null_block.ref_cnt = 1
        self.free_queue = FreeBlockQueue(self.blocks[1:])
        # hash -> block (one representative per content hash).
        self.cached_hash_to_block: dict[BlockHash, KVCacheBlock] = {}

    # ------------------------------------------------------------------ alloc
    def get_num_free_blocks(self) -> int:
        return self.free_queue.num_free

    def get_new_blocks(self, num: int) -> list[KVCacheBlock]:
        if num > self.get_num_free_blocks():
            raise ValueError("out of free KV pages")
        out = []
        for _ in range(num):
            block = self.free_queue.popleft()
            self._maybe_evict_hash(block)
            block.ref_cnt = 1
            out.append(block)
        return out

    def _maybe_evict_hash(self, block: KVCacheBlock) -> None:
        h = block.block_hash
        if h is not None:
            cached = self.cached_hash_to_block.get(h)
            if cached is block:
                del self.cached_hash_to_block[h]
            block.block_hash = None

    # ---------------------------------------------------------------- caching
    def get_cached_block(self, block_hash: BlockHash
                         ) -> Optional[KVCacheBlock]:
        return self.cached_hash_to_block.get(block_hash)

    def touch(self, blocks: list[KVCacheBlock]) -> None:
        """Take a reference on cache-hit blocks (removing them from the free
        list if they were evictable)."""
        for b in blocks:
            if b.ref_cnt == 0:
                self.free_queue.remove(b)
            b.ref_cnt += 1

    def cache_full_blocks(self, blocks: list[KVCacheBlock],
                          block_hashes: list[BlockHash],
                          num_cached_blocks: int,
                          num_full_blocks: int) -> None:
        """Register content hashes for newly-filled full pages."""
        if not self.enable_caching:
            return
        for i in range(num_cached_blocks, num_full_blocks):
            block = blocks[i]
            h = block_hashes[i]
            block.block_hash = h
            self.cached_hash_to_block.setdefault(h, block)

    def reset_prefix_cache(self) -> bool:
        """Drop every cached content hash, so no later prompt hits a page
        cached before. Only when no request holds a page (else False)."""
        if self.free_queue.num_free != self.num_blocks - 1:
            return False
        self.cached_hash_to_block.clear()
        for b in self.blocks:
            b.block_hash = None
        return True

    # ------------------------------------------------------------------- free
    def free_blocks(self, ordered_blocks: list[KVCacheBlock]) -> None:
        """Release references; fully-freed blocks go to the LRU tail in the
        given order (callers pass tail-first so the longest prefix is evicted
        last)."""
        for b in ordered_blocks:
            if b is self.null_block:
                continue
            b.ref_cnt -= 1
            if b.ref_cnt == 0:
                self.free_queue.append(b)
