"""Paged KV cache: fixed-size block pools, block tables, prefix cache.

A copy of ``singa_tpu/serve/kv_pool.py`` (host-side numpy bookkeeping,
framework-free), kept here so the port imports nothing of the JAX
package. The device pools it describes live in the port's engine as
torch tensors.

A dense serving cache reserves ``slots * max_len`` K/V positions per
layer no matter how long each stream actually is; at thousands of
concurrent streams that reservation — not compute — caps concurrency.
Here device memory holds ONE pool of fixed-size blocks per layer,
shaped ``(n_blocks, heads, block_len, head_dim)``, and each sequence
owns an ordered list of block ids (its block table). Admission
allocates exactly the blocks a request's ``prompt + budget`` needs;
retirement returns them; a stream's cache view is a gather of its
table. Blocks are uniform, so the allocator is a free list with zero
external fragmentation — "fragmentation" can only mean internal slack
inside a sequence's last block, bounded by ``block_len - 1`` positions.

Block id 0 is reserved as the TRASH block: it is never allocated, table
rows are initialized to it, and fixed-shape prefill chunks route their
padding-position writes at it. Gathers may therefore read it freely —
``models.transformer.cache_attend`` masks every cache entry beyond a
query's position to -1e30 before the softmax, so trash contents never
move an output bit (the parity tests pin this).

The speculative verify tick (serve/engine.py ``Engine._verify``)
extends the same contract to MULTI-POSITION writes: a slot's chunk of
k+1 candidate positions maps through its table to (block, offset)
pairs exactly as single-token decode does, and the post-acceptance
scatter routes every REJECTED position's write to the trash block —
the KV rewind. Rejected positions' pool bytes are therefore never
touched, which is what makes "un-advance the cache" an exact no-op
rather than a restore.

PREFIX CACHING turns the allocator into a content-addressed,
refcounted block cache (``serving { prefix_cache { enabled } }``).
Every block carries a refcount. A FULL block — all ``block_len``
positions prefill-written from prompt tokens — is hashed by
``(hash-of-prefix-so-far, block token ids)``, so a block's identity
includes its ENTIRE left context and (via the chain length) its
absolute positions: two requests sharing a system prompt map to the
same digests block for block. At admission the scheduler matches the
incoming prompt's longest cached block-prefix and points the new
sequence's table at the SHARED blocks (refcount bumped); prefill drops
to the uncached tail. Sharing is sound because a fully-prompt-covered
block is immutable — decode and verify only ever write at positions
``>= prompt_len``, which live in later, privately-owned blocks — and
because prefill chunking is bitwise split-invariant (PR 9's pinned
property), a warm sequence's pool bytes are bit-for-bit what its own
cold prefill would have written. The one place a sequence must write
into a shared block — re-deriving the last-token logits when the hit
covers the WHOLE prompt — is COPY-ON-WRITE: the engine copies the
block to a fresh one and repoints only its own table, so sharing stays
invisible to the fixed-shape decode/prefill/verify programs (they
just read through block tables; admit/retire/COW never recompiles).

Retirement decrements refcounts. A refcount-0 block that is REGISTERED
in the prefix index moves to an LRU list instead of the free list —
reclaimed lazily, oldest first, only when an allocation would
otherwise raise PoolExhausted — so backpressure semantics are
unchanged while a warm pool keeps serving hits across request
lifetimes (multi-turn traffic hits its own history).

The allocator is host-side bookkeeping (admission-path work, like the
reference Server's per-param shard map, src/server/server.cc); the
pools themselves live in the engine's donated device state.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib

import numpy as np


class PoolExhausted(Exception):
    """No free (or LRU-reclaimable) blocks for an allocation — the
    scheduler's admission backpressure signal (queued requests wait
    for a retirement)."""


@dataclasses.dataclass(frozen=True)
class KVPool:
    """Static geometry of the paged cache (the device arrays themselves
    ride the engine's state pytree)."""

    n_blocks: int          # total blocks INCLUDING the reserved trash block
    block_len: int         # positions per block
    max_blocks_per_seq: int  # table width = ceil(max_len / block_len)

    @property
    def cache_len(self) -> int:
        """Gathered per-sequence cache length (= padded max_len)."""
        return self.max_blocks_per_seq * self.block_len

    @classmethod
    def for_model(cls, max_len: int, block_len: int, n_blocks: int = 0,
                  slots: int = 1) -> "KVPool":
        """Geometry for a model with ``max_len`` positions. ``n_blocks``
        0 sizes the pool so every slot can hold a full-length sequence
        (+ the trash block) — the dense-equivalent upper bound; smaller
        explicit pools oversubscribe and rely on backpressure."""
        if block_len < 1:
            raise ValueError(f"kv_block_len must be >= 1, got {block_len}")
        if max_len % block_len:
            raise ValueError(
                f"kv_block_len {block_len} must divide max_len {max_len} "
                "(keeps the gathered cache length equal to the dense "
                "cache, so paged == dense stays bitwise)"
            )
        per_seq = max_len // block_len
        if not n_blocks:
            n_blocks = slots * per_seq + 1
        if n_blocks < per_seq + 1:
            raise ValueError(
                f"kv_blocks {n_blocks} cannot hold even one full "
                f"sequence ({per_seq} blocks) plus the trash block"
            )
        return cls(n_blocks, block_len, per_seq)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks a sequence of ``n_tokens`` total positions needs."""
        return -(-max(1, n_tokens) // self.block_len)

    def block_offset(self, position: int) -> tuple[int, int]:
        """Absolute sequence position -> (table row, in-block offset) —
        the host-side mirror of the device-side index math every write
        path (decode, prefill, the speculative verify's multi-position
        scatter) runs; tests pin the two against each other."""
        return position // self.block_len, position % self.block_len


class PrefixCache:
    """Content-addressed index over FULL, prompt-prefilled blocks.

    A block's identity is the chained digest
    ``d_i = H(d_{i-1}, tokens[i*BL : (i+1)*BL])`` (``d_{-1}`` empty):
    the hash covers the block's own token ids AND, through the chain,
    every token to its left — so two blocks are interchangeable iff
    their whole left context matches, which (with prefill's bitwise
    split-invariance) makes their pool bytes interchangeable too. Only
    blocks every position of which was prefill-written from PROMPT
    tokens are registered in the FULL-block index by default:
    decode/verify-written entries ride different compiled shapes (the
    PR 9 cross-shape caveat), so caching them trades the
    bitwise-identical-to-cold guarantee for a token-level one — the
    engine only does so behind ``prefix_cache { decode_blocks }``. The
    index maps digest -> block id; membership is what the allocator's
    release path consults to route a refcount-0 block to the LRU list
    instead of the free list.

    PARTIAL TAILS (``tail_stride`` > 0): a prompt's LAST, partial block
    additionally registers sub-block digests at every ``tail_stride``
    tokens — ``t_j = H_tail(parent_full_digest, tokens[h*BL : h*BL +
    j*S])`` with a domain-separated hash, mapping to ``(block,
    tokens_covered)``. A later prompt whose shared prefix ends
    mid-block matches the DEEPEST registered tail and COW-extends it
    (the engine copies the tail block to a private fresh block and
    prefills only past the covered tokens). Soundness: the covered
    positions were prompt-prefill-written under the identical left
    context, so — by prefill's bitwise split-invariance — the copied
    bytes are bit-for-bit what the new sequence's own cold prefill
    would have written; bytes BEYOND the covered tokens in the copy are
    either re-prefilled by the new sequence or causally masked, so they
    never move an output bit. The stride must divide ``block_len``
    (netlint SRV001 mirrors this check statically)."""

    def __init__(self, block_len: int, tail_stride: int = 0):
        if tail_stride < 0 or (tail_stride and block_len % tail_stride):
            raise ValueError(
                f"prefix_cache.tail_stride {tail_stride} must divide "
                f"kv_block_len {block_len} (sub-block digests index "
                "whole stride multiples)"
            )
        self.block_len = block_len
        self.tail_stride = tail_stride
        #: bumped on every index mutation (register/forget) — cheap
        #: change detection for consumers that derive state from the
        #: index (the fleet host's published digest feedback)
        self.version = 0
        self._by_digest: dict[bytes, int] = {}
        self._digest_of: dict[int, bytes] = {}
        #: digest -> parent digest (None for a chain head) and the
        #: reverse — the chain linkage eviction needs: a child is only
        #: MATCHABLE through its parent's digest, so dropping a parent
        #: must cascade or descendants sit indexed-but-unreachable
        self._parent: dict[bytes, bytes | None] = {}
        self._children: dict[bytes, set[bytes]] = {}
        #: partial-tail index: tail digest -> (block, tokens covered);
        #: one block registers a tail at EVERY stride multiple its
        #: prompt coverage reaches, so the deepest match wins
        self._tail_block: dict[bytes, tuple[int, int]] = {}
        self._tails_of: dict[int, set[bytes]] = {}
        #: tail digests are only matchable under their parent FULL
        #: digest's chain (parent b"" = chain head), so evicting the
        #: parent must cascade them out exactly like full children
        self._tail_parent: dict[bytes, bytes] = {}
        self._tail_children: dict[bytes, set[bytes]] = {}

    def __len__(self) -> int:
        return len(self._by_digest)

    @staticmethod
    def _digest(prev: bytes, token_bytes: bytes) -> bytes:
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(token_bytes)
        return h.digest()

    @staticmethod
    def _tail_digest(parent: bytes, token_bytes: bytes) -> bytes:
        # blake2b personalization domain-separates sub-block tail
        # digests from the full-block chain, so a tail can never
        # collide into (or be matched as) a full block
        h = hashlib.blake2b(parent, digest_size=16, person=b"tail")
        h.update(token_bytes)
        return h.digest()

    def chain(self, tokens) -> list[bytes]:
        """Digests of every FULL block of ``tokens``, left to right.
        One vectorized int32 serialization for the whole prompt — this
        runs on the admission path for every request."""
        buf = np.ascontiguousarray(tokens, dtype="<i4").tobytes()
        out, prev, width = [], b"", 4 * self.block_len
        for i in range(len(tokens) // self.block_len):
            prev = self._digest(prev, buf[i * width:(i + 1) * width])
            out.append(prev)
        return out

    def match_chain(self, chain: list[bytes]) -> list[int]:
        """Block ids of the longest cached prefix of a digest chain (a
        missing link stops the walk — a block is only reusable under
        the exact left context it was written in)."""
        out: list[int] = []
        for d in chain:
            b = self._by_digest.get(d)
            if b is None:
                break
            out.append(b)
        return out

    def match(self, tokens) -> list[int]:
        """Block ids of the longest cached block-prefix of ``tokens``
        (full blocks only)."""
        return self.match_chain(self.chain(tokens))

    def has(self, digest: bytes) -> bool:
        return digest in self._by_digest

    def digests(self, limit: int | None = None) -> list[bytes]:
        """Up to ``limit`` indexed digests (insertion order — chain
        parents precede children, so a truncated list still matches
        prefixes). The fleet router's prefix-affinity feedback
        publishes these (serve/fleet/router.py)."""
        out = list(self._by_digest)
        return out if limit is None else out[:limit]

    def is_cached(self, block: int) -> bool:
        return block in self._digest_of or block in self._tails_of

    def match_tail(self, tokens, matched_blocks: int,
                   chain: list[bytes]) -> tuple[int, int]:
        """Deepest registered partial-tail extension of an
        ``matched_blocks``-deep full-block match of ``tokens`` ->
        ``(block, tokens_covered)``, or ``(0, 0)`` (block 0 is the
        reserved trash block, never a tail). Probes every stride
        multiple the prompt still covers past the matched blocks."""
        if not self.tail_stride or not self._tail_block:
            return 0, 0
        h, bl = matched_blocks, self.block_len
        rem = min(len(tokens) - h * bl, bl)
        if rem < self.tail_stride:
            return 0, 0
        parent = chain[h - 1] if h else b""
        buf = np.ascontiguousarray(tokens, dtype="<i4").tobytes()
        base = 4 * h * bl
        best = (0, 0)
        for j in range(self.tail_stride, min(rem, bl - 1) + 1,
                       self.tail_stride):
            entry = self._tail_block.get(
                self._tail_digest(parent, buf[base:base + 4 * j])
            )
            if entry is not None:
                best = entry
        return best

    def register_tail(self, tokens, block: int) -> int:
        """Index ``block`` — the prompt's LAST, partial block — under
        sub-block digests at every stride multiple its prompt coverage
        reaches (``tokens`` = the WHOLE prompt; the tail starts at the
        last full-block boundary). First writer wins per depth. -> how
        many depths were newly registered."""
        if not self.tail_stride:
            return 0
        bl = self.block_len
        nb = len(tokens) // bl
        rem = len(tokens) - nb * bl
        if rem < self.tail_stride:
            return 0
        parent = self.chain(tokens)[nb - 1] if nb else b""
        buf = np.ascontiguousarray(tokens, dtype="<i4").tobytes()
        base = 4 * nb * bl
        new = 0
        for j in range(self.tail_stride, rem + 1, self.tail_stride):
            d = self._tail_digest(parent, buf[base:base + 4 * j])
            if d in self._tail_block:
                continue
            self._tail_block[d] = (block, j)
            self._tails_of.setdefault(block, set()).add(d)
            self._tail_parent[d] = parent
            self._tail_children.setdefault(parent, set()).add(d)
            new += 1
        if new:
            self.version += 1
        return new

    def _drop_tail(self, d: bytes) -> int:
        """Remove one tail entry -> its block id."""
        block, _ = self._tail_block.pop(d)
        parent = self._tail_parent.pop(d)
        kids = self._tail_children.get(parent)
        if kids is not None:
            kids.discard(d)
            if not kids:
                del self._tail_children[parent]
        tails = self._tails_of.get(block)
        if tails is not None:
            tails.discard(d)
            if not tails:
                del self._tails_of[block]
        return block

    def clear(self) -> int:
        """Drop EVERY index entry, full-block and partial-tail alike ->
        how many full-block entries were dropped. Cached KV bytes are a
        function of the weights that wrote them, so a weight hot-swap
        (serve/rollout.py) must invalidate the whole index: a block
        prefilled under the old version matching a new-version admission
        would poison the pool."""
        n = len(self._by_digest)
        if n or self._tail_block:
            self.version += 1
        self._by_digest.clear()
        self._digest_of.clear()
        self._parent.clear()
        self._children.clear()
        self._tail_block.clear()
        self._tails_of.clear()
        self._tail_parent.clear()
        self._tail_children.clear()
        return n

    def register(self, digest: bytes, block: int,
                 parent: bytes | None = None) -> bool:
        """Bind ``digest`` -> ``block`` (``parent`` = the previous
        block's digest in the chain, None for a head). First writer
        wins: a digest already present (two identical prompts prefilled
        concurrently) keeps the existing block and the newcomer stays
        private."""
        if digest in self._by_digest or block in self._digest_of:
            return False
        self.version += 1
        self._by_digest[digest] = block
        self._digest_of[block] = digest
        self._parent[digest] = parent
        if parent is not None:
            self._children.setdefault(parent, set()).add(digest)
        return True

    def forget(self, block: int) -> list[int]:
        """Drop a block's index entry AND its descendant subtree — a
        descendant's digest is only reachable through this block's, so
        leaving it indexed would strand it unmatchable forever while
        still counting as cached. -> every block whose entry was
        removed (the allocator returns the LRU-parked ones to the free
        list); empty for an unregistered block. Partial-tail entries
        cascade with it: tails OF this block (and of any removed
        descendant), and tails PARENTED on any removed digest — a tail
        is only matchable through its parent's chain position."""
        d = self._digest_of.get(block)
        had_tails = block in self._tails_of
        if d is None and not had_tails:
            return []
        self.version += 1
        if had_tails:
            for td in list(self._tails_of[block]):
                self._drop_tail(td)
        if d is None:
            return [block]
        removed: list[int] = []
        tail_orphans: set[int] = set()
        stack = [d]
        while stack:
            dig = stack.pop()
            b = self._by_digest.pop(dig, None)
            if b is None:
                continue
            del self._digest_of[b]
            removed.append(b)
            for td in list(self._tails_of.get(b, ())):
                self._drop_tail(td)
            for td in list(self._tail_children.get(dig, ())):
                tail_orphans.add(self._drop_tail(td))
            parent = self._parent.pop(dig, None)
            if parent is not None and parent in self._children:
                self._children[parent].discard(dig)
                if not self._children[parent]:
                    del self._children[parent]
            stack.extend(self._children.pop(dig, ()))
        for b in tail_orphans:
            if b != block and not self.is_cached(b) and b not in removed:
                removed.append(b)
        return removed


class BlockAllocator:
    """Refcounted free-list allocator over a pool's block ids (block 0
    reserved). With ``prefix_cache`` on it doubles as the block cache's
    lifetime manager: ``retain`` bumps shared blocks at a prefix hit
    (reviving LRU blocks), ``release`` decrements at retirement and
    parks refcount-0 REGISTERED blocks on the LRU list, and ``alloc``
    reclaims from the LRU only when the free list alone cannot satisfy
    it (lazy eviction — a warm pool keeps serving hits). ``free`` is
    the strict exclusive-owner API: it refuses already-free AND shared
    blocks loudly, all-or-nothing, so a double release can never
    corrupt the free list (the latent pre-refcount hazard)."""

    def __init__(self, pool: KVPool, *, prefix_cache: bool = False,
                 lru: bool = True, tail_stride: int = 0):
        self.pool = pool
        self._free = list(range(pool.n_blocks - 1, 0, -1))  # pop() -> 1,2,..
        self._ref: dict[int, int] = {}
        #: refcount-0 registered blocks, oldest-released first
        self._lru: collections.OrderedDict[int, None] = (
            collections.OrderedDict()
        )
        self.cache: PrefixCache | None = (
            PrefixCache(pool.block_len, tail_stride) if prefix_cache
            else None
        )
        self.lru_enabled = lru
        #: optional lifecycle sink: callable(kind, **payload) — the
        #: scheduler points this at its recorder event path so
        #: lru_evict / lru_reclaim ride the flight recorder
        self.on_event = None
        #: high-water mark of blocks in use (serve_bench's occupancy row)
        self.peak_used = 0
        self.lru_evictions = 0
        self.lru_reclaims = 0

    def _event(self, kind: str, **payload) -> None:
        if self.on_event is not None:
            self.on_event(kind, **payload)

    @property
    def free_blocks(self) -> int:
        """Allocatable blocks: truly free + lazily-reclaimable LRU."""
        return len(self._free) + len(self._lru)

    @property
    def used_blocks(self) -> int:
        """Blocks referenced by at least one live sequence."""
        return len(self._ref)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks held warm on the LRU list."""
        return len(self._lru)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def reset_stats(self) -> None:
        self.lru_evictions = 0
        self.lru_reclaims = 0

    def can_alloc(self, n: int) -> bool:
        return n <= self.free_blocks

    def purge_cache(self) -> int:
        """Invalidate the whole prefix cache: drop every index entry and
        return every LRU-parked refcount-0 block to the free list -> how
        many full-block index entries were dropped. The weight-rollout
        flip (serve/rollout.py) calls this at the tick boundary: cached
        K/V bytes were written under the OLD weights, so under the new
        version every warm block is garbage. Blocks still referenced by
        live sequences merely lose their index entries — their in-flight
        owners keep decoding over them, and release() returns them to
        the free list (no longer cached) at retirement."""
        if self.cache is None:
            return 0
        dropped = self.cache.clear()
        while self._lru:
            block, _ = self._lru.popitem(last=False)
            self._free.append(block)
        return dropped

    def headroom_excluding(self, blocks: list[int]) -> int:
        """Allocatable count once ``blocks`` are retained: their LRU
        entries stop being reclaimable. Lets admission decide
        hit-plus-tail feasibility BEFORE touching any state, so
        backpressure retries are true no-ops (no phantom reclaim
        events, no LRU reordering)."""
        return self.free_blocks - sum(1 for b in blocks if b in self._lru)

    def alloc(self, n: int) -> list[int]:
        """-> ``n`` fresh (refcount-1, unshared) block ids; raises
        PoolExhausted leaving free list, LRU, and index untouched (the
        all-or-nothing contract admission needs). Reclaims LRU blocks
        lazily — oldest first, index entry dropped — only when the
        free list alone cannot cover ``n``."""
        if n > self.free_blocks:
            raise PoolExhausted(
                f"need {n} blocks, {len(self._free)} free + "
                f"{len(self._lru)} cached ({len(self._ref)} in use of "
                f"{self.pool.n_blocks - 1})"
            )
        while len(self._free) < n:
            block, _ = self._lru.popitem(last=False)
            self._free.append(block)
            self.lru_evictions += 1
            self._event("lru_evict", block=block)
            if self.cache is not None:
                # dropping a chain block orphans its descendants (they
                # are only matchable through it): their index entries
                # cascade out with it, and any parked on the LRU become
                # plain free blocks instead of dead warm weight
                for orphan in self.cache.forget(block):
                    if orphan != block and orphan in self._lru:
                        del self._lru[orphan]
                        self._free.append(orphan)
                        self.lru_evictions += 1
                        self._event("lru_evict", block=orphan)
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        self.peak_used = max(self.peak_used, len(self._ref))
        return out

    def retain(self, blocks: list[int]) -> int:
        """Bump each block's refcount (a prefix hit sharing them with a
        new sequence). Refcount-0 blocks are revived OFF the LRU list
        (-> the ``lru_reclaim`` lifecycle event). -> how many were
        revived."""
        revived = 0
        for b in blocks:
            if b in self._ref:
                self._ref[b] += 1
            elif b in self._lru:
                del self._lru[b]
                self._ref[b] = 1
                revived += 1
            else:
                raise ValueError(
                    f"retain of block {b} neither live nor cached"
                )
        if revived:
            self.lru_reclaims += revived
            self._event("lru_reclaim", blocks=revived)
        self.peak_used = max(self.peak_used, len(self._ref))
        return revived

    def release(self, blocks: list[int]) -> None:
        """Drop one reference per block (retirement/drain). A block
        reaching refcount 0 parks on the LRU list if it is registered
        in the prefix index (and LRU is on), else returns to the free
        list. A sequence's blocks park TAIL-first (deepest chain block
        oldest), so eviction pressure shaves chains from the tail and
        preserves the shorter — more widely shared — prefixes.
        Releasing an already-free block raises — refcounts make the
        double-release hazard checkable."""
        for b in reversed(list(blocks)):
            rc = self._ref.get(b)
            if rc is None:
                raise ValueError(
                    f"release of block {b} not handed out by this "
                    "allocator (double release?)"
                )
            if rc > 1:
                self._ref[b] = rc - 1
                continue
            del self._ref[b]
            if (
                self.cache is not None
                and self.cache.is_cached(b)
                and self.lru_enabled
            ):
                self._lru[b] = None
            else:
                if self.cache is not None:
                    for orphan in self.cache.forget(b):
                        if orphan != b and orphan in self._lru:
                            del self._lru[orphan]
                            self._free.append(orphan)
                self._free.append(b)

    def free(self, blocks: list[int]) -> None:
        """Strict EXCLUSIVE free: every block must be live with
        refcount exactly 1. Raises loudly — checking ALL blocks before
        mutating anything — on an already-free block (double free), a
        duplicate within ``blocks`` (double free in one call: the old
        free list took it twice and handed it to two owners), or a
        SHARED block (refcount > 1: returning it would corrupt another
        sequence's cache mid-read). Shared lifetimes go through
        ``release``."""
        seen: set[int] = set()
        for b in blocks:
            rc = self._ref.get(b)
            if rc is None or b in seen:
                raise ValueError(
                    f"free of block {b} not handed out by this allocator "
                    "(double free?)"
                )
            if rc > 1:
                raise ValueError(
                    f"free of SHARED block {b} (refcount {rc}): freeing "
                    "would corrupt the other owners' cache; use release()"
                )
            seen.add(b)
        self.release(blocks)
