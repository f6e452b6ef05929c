"""Prefix trie over the paged KV pool: map hot prompt prefixes, don't
recompute them.

Real serving traffic is dominated by shared prefixes — system prompts,
few-shot templates, multi-turn history (the vLLM/PagedAttention
automatic-prefix-caching insight, Kwon et al. 2023).  The block-granular
pool is exactly the right substrate: a prompt's KV lives in whole
physical blocks, so a *trie keyed by per-block token content* can hand a
new request the physical blocks an earlier identical prefix already
filled.  Admission then *maps* those blocks into the new slot's block
table (one refcount increment per block — ``BlockAllocator.share``) and
prefill starts at the first unmatched token: prefill cost for a hot
prefix drops to ~zero, and pool capacity effectively grows by the share
rate (N requests over one system prompt hold ONE copy of its blocks).

Structure: each trie node owns one physical block and is keyed by the
**hash chain** ``(parent node, tokens in this block)`` — children are a
dict keyed by the block's exact token tuple, so a chain of full-block
matches is a plain dict walk and two different prefixes can never
collide (tuples compare by content; no lossy hashing).

Three rules keep the trie honest:

* **Full blocks only.**  A node's KV is immutable history — only blocks
  completely filled by their writer are inserted, so a mapped block is
  never written again by anyone... except through copy-on-write:
  :meth:`match` may also lend the *leading j tokens* of a cached block
  (a partial token-level match).  The borrower must COW that block
  before its first write into it (``scheduler._resolve_cow``) — the
  cached original is never mutated.
* **The trie holds a reference** on every cached block
  (``allocator.share`` at insert).  Retiring requests therefore do NOT
  return cached blocks to the free list; the pool trades free blocks
  for reuse potential.
* **Eviction only at ref == 0 holders-wise**: under pool pressure
  :meth:`evict` releases least-recently-used *leaf* nodes whose block
  the trie alone still holds (refcount 1).  A block actively mapped
  into a live slot (refcount > 1) is never evicted from under it, and
  inner nodes outlive their children so every cached chain stays
  reachable from the root.

Multi-tenant quotas: every node remembers the tenant that
first cached it (``owner``), and :attr:`quotas` caps how many trie
blocks each named tenant may pin.  The cap is enforced *at insert
time*: a tenant at its quota recycles its OWN least-recently-used
eligible leaf to make room, and stops inserting when it has none —
one tenant's churn can displace only its own cached prefixes, never
another tenant's trie nodes.  Pool-pressure :meth:`evict` stays
tenant-blind (capacity pressure is everyone's problem; isolation is
about who a CACHE WRITER may displace).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("tokens", "block", "parent", "children", "stamp",
                 "owner")

    def __init__(self, tokens: Tuple[int, ...], block: int,
                 parent: Optional["_Node"],
                 owner: Optional[str] = None):
        self.tokens = tokens
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.stamp = 0
        #: tenant that FIRST cached this block (quota accounting);
        #: None = unattributed (quota-exempt).
        self.owner = owner


class PrefixCache:
    """Trie of cached full blocks over one :class:`BlockAllocator`.

    The cache participates in the allocator's refcounting: every node
    holds one reference on its block (taken at :meth:`insert`, dropped
    at eviction/:meth:`clear`), so cached KV survives its writer and is
    reclaimed exactly when the last user lets go.
    """

    def __init__(self, block_len: int, allocator):
        if block_len < 1:
            raise ValueError(f"block_len must be >= 1, got {block_len}")
        self.block_len = block_len
        self.allocator = allocator
        self._root_children: Dict[Tuple[int, ...], _Node] = {}
        self._clock = 0
        #: per-tenant trie block caps — the policy plane
        #: shares its live quota view here by reference; tenants not
        #: listed are uncapped.
        self.quotas: Dict[str, int] = {}
        #: live owned-node counts behind the quota check.
        self._owner_count: Dict[str, int] = {}
        # Incremental node count: the scheduler reads it per admission /
        # retirement (the ``serve.prefix.cached_blocks`` gauge), so it
        # must not be a trie walk.
        self._count = 0

    def __len__(self) -> int:
        return self._count

    @property
    def cached_blocks(self) -> int:
        return self._count

    # ------------------------------------------------------------ match
    def match(self, tokens: Sequence[int], limit: Optional[int] = None
              ) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``.

        Walks full-block chain matches, then tries one *partial* match:
        a child block whose leading ``j`` tokens (``0 < j < block_len``)
        continue the prompt — the borrower COWs that block before
        writing into it.  ``limit`` caps the matched length (admission
        passes ``len(prompt) - 1`` so the final prefill chunk always has
        at least one real token to sample the first output from).

        Returns ``(blocks, matched)``: the physical blocks backing the
        first ``matched`` tokens (``len(blocks) ==
        ceil(matched / block_len)``; the last is the partial one iff
        ``matched % block_len != 0``).  References are NOT taken — the
        caller shares what it decides to keep.
        """
        BL = self.block_len
        cap = len(tokens) if limit is None else min(limit, len(tokens))
        blocks: List[int] = []
        matched = 0
        self._clock += 1
        children = self._root_children
        while matched + BL <= cap:
            key = tuple(tokens[matched:matched + BL])
            node = children.get(key)
            if node is None:
                break
            node.stamp = self._clock
            blocks.append(node.block)
            matched += BL
            children = node.children
        # Partial tail: the longest leading run of any child's tokens.
        best_j, best_node = 0, None
        remaining = cap - matched
        if remaining > 0:
            for key, node in children.items():
                j = 0
                m = min(remaining, BL - 1)  # a full match was handled above
                while j < m and key[j] == tokens[matched + j]:
                    j += 1
                if j > best_j:
                    best_j, best_node = j, node
        if best_node is not None:
            best_node.stamp = self._clock
            blocks.append(best_node.block)
            matched += best_j
        return blocks, matched

    # ----------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], blocks: Sequence[int],
               owner: Optional[str] = None) -> int:
        """Register the FULL blocks backing ``tokens`` (``blocks[i]``
        holds ``tokens[i*BL:(i+1)*BL]``; a trailing partial block must
        not be passed).  Already-cached chains dedupe in place — the
        existing node's block wins (and keeps its original owner) and
        the duplicate is left to its current holders.  Takes one
        allocator reference per NEW node.  Returns the number of nodes
        added.

        ``owner`` attributes each NEW node to a tenant for quota
        accounting: a tenant at its :attr:`quotas` cap recycles its OWN
        least-recently-used eligible leaf per new node, and the insert
        stops early when it has none to recycle — never touching
        another tenant's nodes."""
        BL = self.block_len
        if len(blocks) * BL > len(tokens):
            raise ValueError(
                f"insert: {len(blocks)} blocks need {len(blocks) * BL} "
                f"tokens, got {len(tokens)} — only FULL blocks are "
                "cacheable"
            )
        self._clock += 1
        quota = self.quotas.get(owner) if owner is not None else None
        added = 0
        children = self._root_children
        parent: Optional[_Node] = None
        for i, b in enumerate(blocks):
            key = tuple(tokens[i * BL:(i + 1) * BL])
            node = children.get(key)
            if node is None:
                if quota is not None and \
                        self._owner_count.get(owner, 0) >= quota:
                    # Over quota: make room from this owner's OWN
                    # cached leaves, or stop inserting.  (A node just
                    # added this call is never a victim — its block is
                    # still slot-held, refcount > 1.)
                    if not self._evict_owner(owner):
                        break
                self.allocator.share([b])
                node = _Node(key, b, parent, owner=owner)
                children[key] = node
                self._count += 1
                added += 1
                if owner is not None:
                    self._owner_count[owner] = (
                        self._owner_count.get(owner, 0) + 1
                    )
            node.stamp = self._clock
            parent = node
            children = node.children
        return added

    # ---------------------------------------------------------- evict
    def evict(self, n_blocks: int) -> int:
        """Release up to ``n_blocks`` least-recently-used LEAF nodes
        whose block only the trie still holds (allocator refcount 1 —
        blocks mapped into live slots are untouchable).  Dropping the
        trie's reference reclaims the block to the free list.  Returns
        the number of blocks actually released.

        One DFS collects EVERY currently-eligible leaf (released oldest
        stamp first); the scan repeats only when releasing a whole wave
        exposed new leaves (their parents) and more blocks are still
        needed — O(trie) per wave, not per block."""
        released = 0
        while released < n_blocks:
            eligible: List[_Node] = []
            stack = list(self._root_children.values())
            while stack:
                node = stack.pop()
                if node.children:
                    stack.extend(node.children.values())
                elif self.allocator.refcount(node.block) == 1:
                    eligible.append(node)
            if not eligible:
                break
            eligible.sort(key=lambda n: n.stamp)
            for victim in eligible[: n_blocks - released]:
                self._detach(victim)
                self.allocator.free([victim.block])
                released += 1
        return released

    def _evict_owner(self, owner: str) -> bool:
        """Release ``owner``'s least-recently-used LEAF node whose
        block only the trie holds (refcount 1) — the quota-recycle
        move.  Returns whether a block was released."""
        victim: Optional[_Node] = None
        stack = list(self._root_children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif node.owner == owner and \
                    self.allocator.refcount(node.block) == 1 and \
                    (victim is None or node.stamp < victim.stamp):
                victim = node
        if victim is None:
            return False
        self._detach(victim)
        self.allocator.free([victim.block])
        return True

    def _detach(self, node: _Node) -> None:
        siblings = (
            node.parent.children if node.parent is not None
            else self._root_children
        )
        del siblings[node.tokens]
        self._count -= 1
        if node.owner is not None:
            self._owner_count[node.owner] -= 1

    def clear(self) -> int:
        """Drop every cached reference (gc/retire pass): the allocator
        returns to whatever the live slots alone hold.  Returns the
        number of blocks released."""
        released = 0
        stack = list(self._root_children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self.allocator.free([node.block])
            released += 1
        self._root_children = {}
        self._count = 0
        self._owner_count = {}
        return released
