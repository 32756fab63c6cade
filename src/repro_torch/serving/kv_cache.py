"""Block-pooled paged KV cache: fixed-stride blocks + free-list allocator.

A port of the JAX package's ``serving/kv_cache.py``.  The host logic —
the refcounted :class:`BlockAllocator`, the content-addressed
:class:`PrefixCache` with leaf-first LRU eviction, block tables, prefix
matching, copy-on-write, ``fork`` and the swap tier's bookkeeping — is the
same code, so both packages make the same allocation decisions for the
same calls.  What differs is the device side of :class:`PagedKVCache`:
the pool is a ``{"k", "v"}`` dict of torch tensors ``[L, N, Hkv, bs, hd]``
that the engine injects, updated in place, and the swap gather/scatter
are torch index copies.

K/V live in one pool of fixed-size blocks, and every request owns an
ordered *block table*: the token at logical position p of request r
lives at block ``table[r][p // block_size]``, slot ``p % block_size``.
Block 0 is the *null block*: padding entries point at it, masked rows
write their garbage there, and it is never handed to a request.  A
block's stride is forced to a 64-byte multiple (:func:`aligned_block_size`).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

_ALIGN = 64  # bytes; Bebop-page-style block alignment


def _itemsize(dtype) -> int:
    """Bytes per element of a dtype given by name ("bfloat16", ...) or
    as a torch dtype (numpy has no bfloat16 without JAX's ml_dtypes)."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return getattr(torch, str(dtype)).itemsize


class CacheOOM(RuntimeError):
    """The block pool cannot satisfy an allocation right now."""


def aligned_block_size(block_size: int, head_dim: int, dtype) -> int:
    """Round ``block_size`` up until a block row is 64B-aligned.

    One block holds ``block_size * head_dim`` elements per KV head; the
    block stride in bytes must be a multiple of 64 so fixed-stride
    addressing always lands on an aligned boundary (the same rule
    core/device.py applies to page columns).
    """
    itemsize = _itemsize(dtype)
    bs = max(int(block_size), 1)
    while (bs * head_dim * itemsize) % _ALIGN:
        bs += 1
    return bs


class BlockAllocator:
    """Refcounted free-list allocator over ``num_blocks`` fixed-size blocks.

    Block 0 is reserved (the null block) and never allocated.  Blocks are
    handed out LIFO so recently-freed (likely still-resident) blocks are
    reused first.

    Invariants (the JAX package's property tests enforce them on its
    copy; ``tests/test_torch_kv_cache.py`` holds this copy to that one):

    * **No double assignment.**  ``alloc`` never hands out a block that
      still has references; hitting one raises ``AssertionError`` (a
      corrupt free list), restoring the free list first so even the
      failure path conserves capacity.
    * **Exact lifetime.**  A block returns to the free list exactly when
      its refcount reaches 0 — never earlier (a shared block must survive
      its first owner), never later (capacity conservation:
      ``num_free + live blocks == capacity`` at all times).
    * **All-or-nothing alloc.**  ``alloc(n)`` either records all ``n``
      blocks under the owner or raises :class:`CacheOOM` with no side
      effects.
    * **Wholesale release.**  ``free(owner)`` drops *every* reference the
      owner holds — the property the shedding and swap-out paths rely on
      (a retired or paged-out request must never leak pool capacity).
    """

    def __init__(self, num_blocks: int, *, reserved: int = 1):
        if num_blocks <= reserved:
            raise ValueError(f"need > {reserved} blocks, got {num_blocks}")
        self.num_blocks = num_blocks
        self.reserved = reserved
        self._free: List[int] = list(range(num_blocks - 1, reserved - 1, -1))
        self._refs: Dict[int, int] = {}
        self._owned: Dict[Hashable, List[int]] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def capacity(self) -> int:
        return self.num_blocks - self.reserved

    def blocks_of(self, owner: Hashable) -> List[int]:
        return list(self._owned.get(owner, ()))

    def refcount(self, block: int) -> int:
        """Outstanding references to ``block`` (0 = free)."""
        return self._refs.get(block, 0)

    def is_free(self, block: int) -> bool:
        return block in self._free

    def alloc(self, n: int, owner: Hashable) -> List[int]:
        """Take ``n`` fresh blocks (refcount 1) for ``owner``; all-or-nothing."""
        if n < 0:
            raise ValueError(f"negative block count {n}")
        if n > len(self._free):
            raise CacheOOM(
                f"{n} blocks requested, {len(self._free)} free "
                f"(capacity {self.capacity})")
        out = [self._free.pop() for _ in range(n)]
        bad = next((b for b in out if self._refs.get(b, 0)), None)
        if bad is not None:  # the invariant; corrupt free list if hit
            # all-or-nothing holds even on the invariant path: restore the
            # popped blocks (original order) before raising, so detecting
            # a corrupt free list doesn't ALSO leak pool capacity or leave
            # partially-recorded ownership behind
            self._free.extend(reversed(out))
            raise AssertionError(
                f"block {bad} double-assigned "
                f"({self._refs[bad]} refs outstanding -> {owner!r})")
        for b in out:
            self._refs[b] = 1
        self._owned.setdefault(owner, []).extend(out)
        return out

    def share(self, block: int, owner: Hashable) -> None:
        """Take one additional reference to a live block for ``owner``."""
        if self._refs.get(block, 0) <= 0:
            raise ValueError(f"block {block} is not allocated; cannot share")
        self._refs[block] += 1
        self._owned.setdefault(owner, []).append(block)

    def drop(self, owner: Hashable, block: int) -> bool:
        """Release ONE reference of ``owner`` on ``block``.

        Returns True when that was the last reference (the block is back
        on the free list).  The copy-on-write and LRU-eviction paths
        release single blocks; requests release wholesale via free().
        """
        blocks = self._owned.get(owner)
        if blocks is None or block not in blocks:
            raise ValueError(f"{owner!r} holds no reference to block {block}")
        blocks.remove(block)
        if not blocks:
            del self._owned[owner]
        return self._unref(block)

    def _unref(self, block: int) -> bool:
        left = self._refs[block] - 1
        if left:
            self._refs[block] = left
            return False
        del self._refs[block]  # refcount 0 <=> on the free list
        self._free.append(block)
        return True

    def free(self, owner: Hashable) -> int:
        """Drop EVERY reference held by ``owner`` (finish OR shed path).

        Only blocks whose refcount hits 0 return to the free list; blocks
        still shared with other requests (or pinned by the prefix cache)
        stay resident.  Returns the number of references released.
        """
        blocks = self._owned.pop(owner, [])
        for b in reversed(blocks):   # LIFO reuse: most recently used first
            self._unref(b)
        return len(blocks)


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static geometry of a paged pool (derived, never recomputed per call)."""

    num_layers: int
    num_blocks: int
    num_kv_heads: int
    block_size: int
    head_dim: int
    dtype: str
    blocks_per_seq: int   # block-table width M (= ceil(cache_len / bs))

    @property
    def block_bytes(self) -> int:
        """Fixed per-layer block stride in bytes (the Bebop-page analogue)."""
        return (self.num_kv_heads * self.block_size * self.head_dim
                * _itemsize(self.dtype))

    @property
    def tokens(self) -> int:
        return self.blocks_per_seq * self.block_size


def block_keys(tokens, block_size: int) -> List[bytes]:
    """Content-hash chain over the FULL blocks of a token row.

    ``key_i = H(key_{i-1} || tokens_of_block_i)``: a block's key commits
    to the entire prefix ending at its last token, so equal keys <=>
    equal (position, content) prefixes and matching is one flat dict
    probe per block.  Fixed-size blocks are what keep this branchless:
    the hash is a hash of whole blocks, never a variable-length boundary
    scan.  Only full blocks get keys — the partial tail is never shared.
    """
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
    keys: List[bytes] = []
    parent = b""
    for i in range(len(toks) // block_size):
        parent = hashlib.blake2b(
            parent + toks[i * block_size:(i + 1) * block_size].tobytes(),
            digest_size=16).digest()
        keys.append(parent)
    return keys


class PrefixCache:
    """Content-addressed index of full KV blocks + LRU retention.

    Maps chain keys (:func:`block_keys`) to resident physical blocks.
    The cache holds one reference of its own on every indexed block, so
    a finished request's prefix blocks stay out of the free list
    (refcount 1, "cached but unreferenced") until evicted — a hot system
    prompt survives between requests.  Eviction drops the
    least-recently-used indexed block whose only reference is the
    cache's; blocks pinned by live requests are skipped.

    Invariants (enforced on the JAX copy by its property tests):

    * **Index implies resident.**  Every indexed block carries the
      cache's own reference, so ``lookup`` can only ever return blocks
      whose content is live in the pool.  This is also why swapped-out
      state can never satisfy a match: swap-out frees (or de-references)
      the victim's blocks, and a block leaves the index *before* it can
      be freed — there is no window where a key maps to absent content.
    * **First writer wins.**  ``register`` never remaps a key or
      re-indexes a block; an identical prompt that raced ahead keeps the
      index stable and the loser keeps its private copy.
    * **Leaf-first eviction.**  Only blocks with no indexed child are
      evicted, so a retained chain is always matchable from its head —
      eviction never strands reachable descendants.
    * **Pinned blocks survive.**  A block referenced by any live request
      (refcount > 1) is never evicted.
    """

    _OWNER = "<prefix-lru>"

    def __init__(self, allocator: BlockAllocator, *, max_blocks: int = 0):
        self.allocator = allocator
        self.max_blocks = max(0, int(max_blocks))  # 0 = pool-bounded
        self._index: Dict[bytes, int] = {}
        self._key_of: Dict[int, bytes] = {}
        self._parent: Dict[bytes, bytes] = {}      # chain linkage
        self._children: Dict[bytes, int] = {}      # indexed children per key
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self.hits = 0        # blocks handed out via acquire()
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._index)

    @property
    def reclaimable(self) -> int:
        """Indexed blocks no live request references (evictable now)."""
        return sum(1 for b in self._lru if self.allocator.refcount(b) == 1)

    def lookup(self, keys: Sequence[bytes]) -> List[int]:
        """Longest indexed prefix of ``keys`` -> physical block ids."""
        out: List[int] = []
        for k in keys:
            b = self._index.get(k)
            if b is None:
                break
            out.append(b)
        return out

    def acquire(self, blocks: Sequence[int], owner: Hashable) -> None:
        """Reference matched blocks for ``owner`` and refresh recency."""
        for b in blocks:
            self.allocator.share(b, owner)
            self._lru.move_to_end(b)
        self.hits += len(blocks)

    def register(self, key: bytes, block: int,
                 parent: Optional[bytes] = None) -> bool:
        """Index a fully-written block under its chain key.

        First writer wins: if the key is already mapped (an identical
        prompt raced ahead) or the block is already indexed, nothing
        changes and the caller keeps its private copy.  ``parent`` is
        the chain key of the preceding block (None at the chain head);
        the linkage makes eviction leaf-first.
        """
        if key in self._index or block in self._key_of:
            return False
        self._index[key] = block
        self._key_of[block] = key
        if parent is not None:
            self._parent[key] = parent
            self._children[parent] = self._children.get(parent, 0) + 1
        self.allocator.share(block, self._OWNER)
        self._lru[block] = None
        self._lru.move_to_end(block)
        self.trim()
        return True

    def trim(self) -> int:
        """Enforce ``max_blocks``: evict unpinned entries over the cap.
        Called on register AND on request release — a block pinned by
        its writer at registration time only becomes evictable once
        that request drops its reference."""
        if not self.max_blocks or len(self._lru) <= self.max_blocks:
            return 0
        return self.evict(len(self._lru) - self.max_blocks)

    def evict(self, n: int) -> int:
        """Drop up to ``n`` unpinned blocks, LRU-ordered LEAF-first.

        Only blocks with no indexed child are candidates: lookup() walks
        chains from the head, so evicting a chain-head block would leave
        every retained descendant permanently unmatchable dead weight.
        Leaf-first eviction trims chains from the tail and keeps the
        matchable prefix resident.  Returns the number freed.
        """
        done = 0
        progress = True
        while done < n and progress:   # evicting a leaf may expose its
            progress = False           # parent as the next candidate
            for b in list(self._lru):
                if done >= n:
                    break
                if self.allocator.refcount(b) != 1:
                    continue  # pinned by a live request; not evictable
                key = self._key_of[b]
                if self._children.get(key, 0):
                    continue  # interior chain block; evict its tail first
                del self._index[key]
                del self._key_of[b]
                del self._lru[b]
                self._children.pop(key, None)
                parent = self._parent.pop(key, None)
                if parent is not None:
                    left = self._children[parent] - 1
                    if left:
                        self._children[parent] = left
                    else:
                        del self._children[parent]
                self.allocator.drop(self._OWNER, b)
                done += 1
                progress = True
        self.evictions += done
        return done


@dataclasses.dataclass
class _SwappedSeq:
    """Host-side image of one owner's paged KV state while preempted.

    ``host_k``/``host_v`` are ``[L, n, Hkv, bs, hd]`` CPU tensors — the
    owner's ``n`` blocks gathered in table order (pinned when the pool is
    on a CUDA device, so the copies are bulk DMA).
    """

    blocks: int
    host_k: torch.Tensor
    host_v: torch.Tensor


class PagedKVCache:
    """Device-resident block pool + per-request block tables.

    ``pool`` is a ``{"k", "v"}`` dict of ``[L, N, Hkv, bs, hd]`` tensors
    that the engine builds with the model and assigns before first use;
    steps and swaps update it in place.  This class owns the bookkeeping:
    which physical blocks back which request, and the padded ``[M]`` int32
    table rows the kernels consume.

    Swap-tier invariants: ``swap_in(swap_out(owner))`` restores the
    owner's blocks bit-identically (into freshly allocated blocks — ids
    may change, content may not); swap-out drops only the owner's own
    references; a swapped owner holds zero device blocks, and
    :meth:`release` on a swapped owner discards its host image too.
    """

    def __init__(self, *, num_layers: int, num_kv_heads: int, head_dim: int,
                 cache_len: int, block_size: int = 16, num_blocks: int = 0,
                 max_concurrent: int = 8, dtype: str = "float32",
                 prefix_cache: bool = True, prefix_lru_blocks: int = 0):
        bs = aligned_block_size(block_size, head_dim, dtype)
        m = -(-cache_len // bs)
        if num_blocks <= 0:
            num_blocks = max_concurrent * m + 1  # +1 for the null block
        self.layout = PagedLayout(num_layers, num_blocks, num_kv_heads, bs,
                                  head_dim, dtype, m)
        self.allocator = BlockAllocator(num_blocks)
        self.prefix: Optional[PrefixCache] = \
            PrefixCache(self.allocator, max_blocks=prefix_lru_blocks) \
            if prefix_cache else None
        self._tables: Dict[Hashable, List[int]] = {}
        self._keys: Dict[Hashable, List[bytes]] = {}       # per-owner chain
        self._registered: Dict[Hashable, int] = {}         # blocks indexed
        self._swapped: Dict[Hashable, _SwappedSeq] = {}    # host images
        #: {"k", "v"} device pools, assigned by the owner (the engine's
        #: model decides the pool's dtype and device)
        self.pool: Optional[Dict[str, torch.Tensor]] = None
        assert self.layout.block_bytes % _ALIGN == 0

    @property
    def block_size(self) -> int:
        return self.layout.block_size

    @property
    def blocks_per_seq(self) -> int:
        return self.layout.blocks_per_seq

    @property
    def num_free_blocks(self) -> int:
        return self.allocator.num_free

    @property
    def reclaimable(self) -> int:
        """Cached-but-unreferenced blocks an allocation could evict."""
        return self.prefix.reclaimable if self.prefix is not None else 0

    def blocks_needed(self, num_tokens: int) -> int:
        """Blocks covering ``num_tokens`` logical positions; raises
        :class:`ValueError` when the request can never fit one table row
        (never truncate: later tokens would alias early blocks)."""
        n = -(-num_tokens // self.block_size)
        if n > self.blocks_per_seq:
            raise ValueError(
                f"{num_tokens} tokens need {n} blocks; a table row holds "
                f"{self.blocks_per_seq} (cache_len {self.layout.tokens})")
        return n

    def _reserve(self, n: int, owner: Hashable) -> List[int]:
        """alloc() with LRU pressure-relief: evict cached-but-unreferenced
        prefix blocks when the free list is short; a shortfall eviction
        can't cover is refused up front (flushing the warm cache for an
        allocation that raises anyway buys nothing)."""
        short = n - self.allocator.num_free
        if short > 0 and self.prefix is not None:
            if short > self.prefix.reclaimable:
                raise CacheOOM(
                    f"{n} blocks requested, {self.allocator.num_free} free "
                    f"+ {self.prefix.reclaimable} evictable "
                    f"(capacity {self.allocator.capacity})")
            self.prefix.evict(short)
        return self.allocator.alloc(n, owner)

    def allocate(self, owner: Hashable, num_tokens: int) -> np.ndarray:
        """Reserve blocks covering ``num_tokens`` positions; returns the
        padded ``[M]`` int32 table row.  All-or-nothing."""
        if owner in self._tables:
            raise ValueError(f"owner {owner!r} already holds blocks")
        blocks = self._reserve(self.blocks_needed(num_tokens), owner)
        self._tables[owner] = blocks
        return self.table_row(owner)

    # -- prefix caching ------------------------------------------------------
    def allocate_prefix(self, owner: Hashable, num_tokens: int, tokens, *,
                        limit: Optional[int] = None,
                        keys: Optional[List[bytes]] = None
                        ) -> Tuple[np.ndarray, int, int]:
        """:meth:`allocate`, but leading table entries may be SHARED.

        Matched full blocks are referenced in place and private blocks
        are allocated only for the remainder.  Returns ``(table_row,
        matched_tokens, shared_blocks)``; ``matched_tokens`` is clamped to
        ``len(tokens) - 1`` so one prompt token always remains to produce
        the first logits.  ``limit`` caps the matched blocks, ``keys``
        passes a precomputed :func:`block_keys` chain.  All-or-nothing.
        """
        if owner in self._tables:
            raise ValueError(f"owner {owner!r} already holds blocks")
        total = self.blocks_needed(num_tokens)
        shared: List[int] = []
        if self.prefix is None:
            keys = []
        else:
            if keys is None:
                keys = block_keys(tokens, self.block_size)
            shared = self.prefix.lookup(keys)
            if limit is not None:
                shared = shared[:limit]
            # take the references BEFORE any eviction below can run, so a
            # private-block shortfall never reclaims our own match
            self.prefix.acquire(shared, owner)
        try:
            private = self._reserve(total - len(shared), owner)
        except CacheOOM:
            for b in reversed(shared):
                self.allocator.drop(owner, b)
            raise
        self._tables[owner] = shared + private
        self._keys[owner] = keys
        self._registered[owner] = len(shared)  # matched keys already indexed
        t = int(np.asarray(tokens).reshape(-1).shape[0])
        matched = min(len(shared) * self.block_size, max(t - 1, 0))
        return self.table_row(owner), matched, len(shared)

    def register_progress(self, owner: Hashable, tokens, written: int) -> int:
        """Index ``owner``'s full prompt blocks once their content is
        resident (``written`` = prompt tokens written so far)."""
        if self.prefix is None or owner not in self._tables:
            return 0
        keys = self._keys.get(owner, ())
        done = self._registered.get(owner, 0)
        upto = min(written // self.block_size, len(keys))
        blocks = self._tables[owner]
        new = 0
        for i in range(done, upto):
            new += bool(self.prefix.register(
                keys[i], blocks[i], keys[i - 1] if i else None))
        if upto > done:
            self._registered[owner] = upto
        return new

    def fork(self, src: Hashable, dst: Hashable, *,
             shared_tokens: int) -> np.ndarray:
        """Clone ``src``'s table for ``dst``, SHARING the blocks covering
        the first ``shared_tokens`` positions and allocating private
        blocks for the rest of the row.  All-or-nothing."""
        if dst in self._tables:
            raise ValueError(f"owner {dst!r} already holds blocks")
        blocks = self._tables[src]
        n_shared = min(-(-max(shared_tokens, 0) // self.block_size),
                       len(blocks))
        for b in blocks[:n_shared]:
            self.allocator.share(b, dst)
        try:
            private = self._reserve(len(blocks) - n_shared, dst)
        except CacheOOM:
            for b in reversed(blocks[:n_shared]):
                self.allocator.drop(dst, b)
            raise
        self._tables[dst] = blocks[:n_shared] + private
        self._keys[dst] = list(self._keys.get(src, []))
        self._registered[dst] = min(self._registered.get(src, 0), n_shared)
        return self.table_row(dst)

    def ensure_private(self, owner: Hashable, idx: int
                       ) -> Optional[Tuple[int, int]]:
        """Copy-on-write hook: if ``owner``'s table entry ``idx`` is
        shared, swap in a fresh private block and return ``(old, new)``
        so the engine can copy the pool contents before writing."""
        blocks = self._tables[owner]
        old = blocks[idx]
        if self.allocator.refcount(old) <= 1:
            return None
        new = self._reserve(1, owner)[0]
        self.allocator.drop(owner, old)
        blocks[idx] = new
        return old, new

    def ensure_private_range(self, owner: Hashable, start_token: int,
                             num_tokens: int) -> List[Tuple[int, int, int]]:
        """Copy-on-write every SHARED block the write range
        ``[start_token, start_token + num_tokens)`` touches; returns
        ``[(table_idx, old_block, new_block), ...]``."""
        if num_tokens <= 0:
            return []
        bs = self.block_size
        lo, hi = start_token // bs, (start_token + num_tokens - 1) // bs
        out: List[Tuple[int, int, int]] = []
        for idx in range(lo, hi + 1):
            pair = self.ensure_private(owner, idx)
            if pair is not None:
                out.append((idx, pair[0], pair[1]))
        return out

    def copy_block(self, src: int, dst: int) -> None:
        """Duplicate pool block ``src`` into ``dst`` in every layer (the
        copy half of copy-on-write), in place."""
        for a in self.pool.values():
            a[:, dst] = a[:, src]

    # -- swap tier -----------------------------------------------------------
    def is_swapped(self, owner: Hashable) -> bool:
        return owner in self._swapped

    def swapped_blocks(self, owner: Hashable) -> int:
        """Blocks the host image of ``owner`` holds (0 = not swapped)."""
        sw = self._swapped.get(owner)
        return sw.blocks if sw is not None else 0

    def _to_host(self, a: torch.Tensor) -> torch.Tensor:
        if not a.is_cuda:
            return a.clone()
        host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
        host.copy_(a)
        return host

    def swap_out(self, owner: Hashable) -> int:
        """Page ``owner``'s KV blocks out to a host image; returns #blocks.

        One gather along the pool's block axis copies the owner's blocks
        (table order) to host, then every device reference the owner
        holds is dropped: exclusively-owned blocks return to the free
        list, shared ones lose one reference and stay resident.  The
        owner's chain keys are kept but its registration watermark is
        reset (restored blocks are fresh private copies)."""
        blocks = self._tables.get(owner)
        if blocks is None:
            raise ValueError(f"owner {owner!r} holds no blocks to swap")
        if owner in self._swapped:
            raise ValueError(f"owner {owner!r} is already swapped out")
        n = len(blocks)
        ids = torch.as_tensor(blocks, dtype=torch.long,
                              device=self.pool["k"].device)
        self._swapped[owner] = _SwappedSeq(
            n, self._to_host(self.pool["k"][:, ids]),
            self._to_host(self.pool["v"][:, ids]))
        del self._tables[owner]
        if owner in self._registered:
            self._registered[owner] = 0
        self.allocator.free(owner)
        if self.prefix is not None:
            self.prefix.trim()
        return n

    def swap_in(self, owner: Hashable) -> np.ndarray:
        """Restore a swapped owner into freshly allocated blocks (evicting
        idle prefix blocks under pressure; :class:`CacheOOM` with no state
        change if even that cannot cover).  Returns the new table row."""
        sw = self._swapped.get(owner)
        if sw is None:
            raise ValueError(f"owner {owner!r} is not swapped out")
        blocks = self._reserve(sw.blocks, owner)
        self._tables[owner] = blocks
        dev = self.pool["k"].device
        ids = torch.as_tensor(blocks, dtype=torch.long, device=dev)
        self.pool["k"][:, ids] = sw.host_k.to(dev, non_blocking=True)
        self.pool["v"][:, ids] = sw.host_v.to(dev, non_blocking=True)
        del self._swapped[owner]
        return self.table_row(owner)

    def table_row(self, owner: Hashable) -> np.ndarray:
        row = np.zeros(self.blocks_per_seq, np.int32)
        blocks = self._tables[owner]
        row[:len(blocks)] = blocks
        return row

    def release(self, owner: Hashable) -> int:
        """Drop every reference of ``owner`` (finish OR shed path); a
        swapped-out owner's host image is discarded too."""
        self._tables.pop(owner, None)
        self._keys.pop(owner, None)
        self._registered.pop(owner, None)
        self._swapped.pop(owner, None)
        n = self.allocator.free(owner)
        if self.prefix is not None:
            self.prefix.trim()   # cap now that this owner's pins are gone
        return n
