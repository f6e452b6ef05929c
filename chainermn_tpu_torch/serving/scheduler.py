"""Iteration-level scheduler: admission, interleaved prefill, eviction.

Continuous batching (Yu et al. 2022, *Orca*): scheduling decisions happen
every *iteration* (one engine decode step), not once per batch.  A request
joins the running step the moment a slot and enough pool blocks free up,
and leaves the instant it emits EOS or its token budget.

Loop shape (one :meth:`Scheduler.tick`):

1. **Deadlines** — cancel live and queued requests past their deadline.
2. **Admit** — FIFO over arrived requests while a slot is free and the
   allocator covers the first prefill chunk.
3. **Prefill one chunk per prefilling slot** (oldest first; chunked on
   the engine's ladder so a long prompt cannot stall running decodes).
4. **Decode step** (or speculative round) for every live slot, then
   retire finished ones and recycle their blocks.

**Prefix sharing**: admission asks the engine's prefix trie for the
longest cached prefix of ``prompt + carried`` and maps those physical
blocks into the new slot's table (one refcount each); prefill resumes at
the first unmatched token.  A partial match lends the leading tokens of a
cached block: the slot copies that block on its first write into it
(:meth:`~chainermn_tpu_torch.serving.engine.DecodeEngine.cow_copy`), so
the cached original is never mutated.  Full prompt blocks are inserted
when prefill finishes, full ``prompt + generated`` blocks at retirement.

**Backpressure**: blocks are allocated lazily.  When the free list runs
dry the scheduler first drains the prefix cache (LRU leaves nobody else
holds), then evicts the youngest-admitted slot: its references return to
the allocator and the request re-queues at the front carrying the tokens
it already generated (recompute-style preemption).

Metrics publish into the port's registry (``serve.queue_depth``,
``serve.slot_occupancy``, ``serve.tokens``, ``serve.prefill_ms``,
``serve.decode_ms``, ``serve.mixed_ms``, ``serve.prefix.*``,
``serve.spec.*``, ``serve.health.deadline_cancels``).  A decode step that
follows unsynced non-final prefill chunks books to ``serve.mixed_ms``, so
``serve.decode_ms`` holds only clean decode iterations.

The decode step is a fault hook (site ``serve_step``, counted by decode
iteration).

The constructor keeps the JAX scheduler's seams for the planes not ported
yet (``slo``, ``timeline``, ``memory``, ``incidents``, ``ledger``,
``policy``): they must be None, and the scheduler then behaves as the JAX
scheduler does with observability planes off and no policy.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from chainermn_tpu_torch import observability as _obs
from chainermn_tpu_torch.observability.metrics import (
    DEFAULT_MS_EDGES,
    NoopInstrument,
)
from chainermn_tpu_torch.resilience import faults as _faults
from chainermn_tpu_torch.serving.kv_pool import PoolExhausted, blocks_for
from chainermn_tpu_torch.serving.recovery import deadline_ms_from_env


@dataclass
class Request:
    """One generation request."""

    id: int
    prompt: Sequence[int]
    max_new_tokens: int
    temperature: float = 0.0
    eos_token: Optional[int] = None
    #: arrival time on the scheduler clock (0 = available immediately).
    arrival: float = 0.0
    #: per-request sampling seed.
    seed: int = 0
    #: optional deadline, milliseconds after ``arrival``: a request still
    #: unfinished past it is cancelled (``Completion.status ==
    #: "deadline"``).  None defers to ``CMN_SERVE_DEADLINE_MS``.
    deadline_ms: Optional[float] = None
    #: tenant label (prefix-trie ownership).
    tenant: str = "default"
    #: priority class (read by the policy plane, not ported yet).
    priority: int = 0


@dataclass
class Completion:
    """A finished request: generated tokens + latency accounting.

    ``first_admitted_at`` is when the request first started service;
    ``admitted_at`` the final admission (they differ only after an
    eviction).  ``prefix_hit_tokens`` counts prompt+carried tokens served
    from the prefix cache over every admission; ``spec_proposed`` /
    ``spec_accepted`` are this request's draft bookkeeping.
    """

    id: int
    tokens: List[int]
    reason: str  # "eos" | "length" | "deadline"
    prompt_len: int
    arrival: float
    admitted_at: float
    finished_at: float
    evictions: int = 0
    first_admitted_at: float = 0.0
    prefix_hit_tokens: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    #: ``"ok"`` for a normal completion, else the terminal verdict.
    status: str = "ok"
    error: Optional[str] = None
    retries: int = 0


@dataclass
class _QueueEntry:
    req: Request
    #: tokens generated before an eviction — re-prefilled and kept.
    carried: List[int] = field(default_factory=list)
    evictions: int = 0
    #: when the request first entered a slot (survives evictions).
    first_admit: Optional[float] = None
    prefix_hit_tokens: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    retries: int = 0
    last_error: Optional[str] = None


def terminal_completion(entry: _QueueEntry, status: str, now: float,
                        error: Optional[str] = None) -> Completion:
    """The one Completion shape for requests that end without serving to
    completion (deadline here; poisoned/shed with the router)."""
    return Completion(
        id=entry.req.id,
        tokens=list(entry.carried),
        reason=status,
        prompt_len=len(entry.req.prompt),
        arrival=entry.req.arrival,
        admitted_at=(
            entry.first_admit if entry.first_admit is not None else now
        ),
        finished_at=now,
        evictions=entry.evictions,
        first_admitted_at=entry.first_admit or 0.0,
        prefix_hit_tokens=entry.prefix_hit_tokens,
        spec_proposed=entry.spec_proposed,
        spec_accepted=entry.spec_accepted,
        status=status,
        error=error if error is not None else entry.last_error,
        retries=entry.retries,
    )


class _Slot:
    def __init__(self, idx: int, entry: _QueueEntry, max_blocks: int,
                 admit_time: float, admit_seq: int):
        self.idx = idx
        self.entry = entry
        self.text = list(entry.req.prompt) + list(entry.carried)
        self.table = np.zeros((max_blocks,), np.int32)
        self.blocks: List[int] = []
        self.pos = 0                    # positions prefilled so far
        self.generated: List[int] = []  # this admission's new tokens
        self.last_token: int = 0
        self.prefilling = True
        self.admit_time = admit_time
        self.admit_seq = admit_seq
        #: table index of a borrowed partial prefix block (copy-on-write
        #: pending: resolved before this slot's first write into it).
        self.cow_idx: Optional[int] = None

    @property
    def total_generated(self) -> int:
        return len(self.entry.carried) + len(self.generated)


class _Clock:
    """Real seconds since construction, with idle gaps skippable."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._skew = 0.0

    def now(self) -> float:
        return time.perf_counter() - self._t0 + self._skew

    def skip_to(self, t: float) -> None:
        delta = t - self.now()
        if delta > 0:
            self._skew += delta


class Scheduler:
    """Admission queue + iteration-level scheduling over a
    :class:`~chainermn_tpu_torch.serving.engine.DecodeEngine`."""

    def __init__(self, engine, registry=None, clock: Optional[_Clock] = None,
                 slo=None, timeline=None, memory=None, incidents=None,
                 fault=None, deadline_ms: Optional[float] = None,
                 ledger=None, policy=None):
        planes = {"slo": slo, "timeline": timeline, "memory": memory,
                  "incidents": incidents, "ledger": ledger,
                  "policy": policy}
        given = [n for n, v in planes.items() if v not in (None, False)]
        if given:
            raise NotImplementedError(
                f"serving planes {given} are not ported yet (ROADMAP "
                "Queue 1, serving planes); pass None"
            )
        self.slo = self.timeline = self.memory = None
        self.incidents = self.ledger = self.policy = None
        self.engine = engine
        self.clock = clock or _Clock()
        self._queue: List[_QueueEntry] = []
        self._slots: List[Optional[_Slot]] = [None] * engine.capacity
        self._admit_seq = 0
        self.completions: List[Completion] = []
        self._iterations = 0
        #: True while non-final prefill chunks queued since the last device
        #: readback may still be running (the ``serve.mixed_ms`` tag).
        self._unsynced_prefill = False
        self._fault = (
            fault if fault is not None else _faults.process_injector()
        )
        self._default_deadline_ms = (
            deadline_ms if deadline_ms is not None
            else deadline_ms_from_env()
        )
        # An explicitly passed registry always publishes; the process
        # registry rides the CMN_OBS master switch.
        if registry is None and not _obs.enabled():
            noop = NoopInstrument()
            self._m_queue = self._m_occ = self._m_tokens = noop
            self._m_prefill = self._m_decode = self._m_mixed = noop
            self._m_px_lookups = self._m_px_hit = self._m_px_rate = noop
            self._m_px_cached = self._m_px_cow = noop
            self._m_px_evicted = noop
            self._m_spec_prop = self._m_spec_acc = noop
            self._m_spec_rate = self._m_deadline = noop
        else:
            reg = registry if registry is not None else _obs.registry()
            self._m_queue = reg.gauge("serve.queue_depth")
            self._m_occ = reg.gauge("serve.slot_occupancy")
            self._m_tokens = reg.counter("serve.tokens")
            self._m_prefill = reg.histogram("serve.prefill_ms",
                                            edges=DEFAULT_MS_EDGES)
            self._m_decode = reg.histogram("serve.decode_ms",
                                           edges=DEFAULT_MS_EDGES)
            self._m_mixed = reg.histogram("serve.mixed_ms",
                                          edges=DEFAULT_MS_EDGES)
            self._m_px_lookups = reg.counter("serve.prefix.lookups")
            self._m_px_hit = reg.counter("serve.prefix.hit_tokens")
            self._m_px_rate = reg.gauge("serve.prefix.hit_rate")
            self._m_px_cached = reg.gauge("serve.prefix.cached_blocks")
            self._m_px_cow = reg.counter("serve.prefix.cow_copies")
            self._m_px_evicted = reg.counter("serve.prefix.evicted_blocks")
            self._m_spec_prop = reg.counter("serve.spec.proposed")
            self._m_spec_acc = reg.counter("serve.spec.accepted")
            self._m_spec_rate = reg.gauge("serve.spec.accept_rate")
            self._m_deadline = reg.counter(
                "serve.health.deadline_cancels"
            )
        #: lifetime host-side accounting (benchmarks read these directly).
        self.prefix_lookup_tokens = 0
        self.prefix_hit_tokens = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        #: decode iterations run, and their summed wall time (ms).
        self.decode_iterations = 0
        self.decode_ms_total = 0.0

    # ---------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        """Enqueue; raises :class:`PoolExhausted` if the request could
        never fit the pool/slot geometry even running alone."""
        self.check_fit(req)
        self._queue.append(_QueueEntry(req))

    def check_fit(self, req: Request) -> None:
        """The submit-time geometry gate, callable without enqueueing."""
        plen = len(req.prompt)
        if plen < 1:
            raise ValueError(f"request {req.id}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.id}: max_new_tokens < 1")
        eng = self.engine
        cap = eng.max_blocks * eng.block_len
        total = plen + req.max_new_tokens
        # A speculative round writes up to spec_k positions past the final
        # generated token (the verify chunk).
        probe_end = total + eng.spec_k
        # Worst-case padded prefill end over every possible (re-)admission
        # text length (carried grows to max_new - 1 under eviction): the
        # padded tail must stay inside the block table and, for learned
        # positions, inside the position table.
        worst_end = self._worst_prefill_end(plen, total - 1)
        if max(probe_end, worst_end) > cap:
            raise PoolExhausted(
                f"request {req.id}: {plen}+{req.max_new_tokens} tokens "
                f"(worst padded prefill end {worst_end}, speculative "
                f"probe end {probe_end}) exceeds the per-slot cap {cap} "
                f"(max_blocks={eng.max_blocks} x "
                f"block_len={eng.block_len})"
            )
        if blocks_for(probe_end, eng.block_len) > eng.pool.num_blocks - 1:
            raise PoolExhausted(
                f"request {req.id}: needs "
                f"{blocks_for(probe_end, eng.block_len)} blocks, pool has "
                f"{eng.pool.num_blocks - 1} allocatable"
            )
        if eng.model.pos_enc == "learned" and \
                max(probe_end, worst_end) > eng.model.max_len:
            raise ValueError(
                f"request {req.id}: worst padded prefill end {worst_end} "
                f"(speculative probe end {probe_end}) exceeds the learned "
                f"position table ({eng.model.max_len}); use a rope model "
                "or shorter requests"
            )

    def complete_terminal(self, entry: _QueueEntry, status: str,
                          error: Optional[str] = None) -> Completion:
        """Terminate ``entry`` without serving it: one definite Completion
        carrying whatever tokens were generated before.  The entry must
        already be off the queue and out of any slot."""
        comp = terminal_completion(entry, status, self.clock.now(),
                                   error=error)
        self.completions.append(comp)
        return comp

    # ----------------------------------------------------------- deadline
    def _deadline_s(self, req: Request) -> Optional[float]:
        dl = req.deadline_ms
        if dl is None:
            dl = self._default_deadline_ms
        return dl / 1e3 if dl is not None and dl > 0 else None

    def _cancel_deadlines(self) -> bool:
        """Cancel every over-deadline request, live slots (blocks freed)
        and queued entries: ``status="deadline"``."""
        now = self.clock.now()
        progressed = False
        for slot in [s for s in self._slots if s is not None]:
            dl = self._deadline_s(slot.entry.req)
            if dl is None or now - slot.entry.req.arrival <= dl:
                continue
            self.engine.release_blocks(slot.blocks)
            self._slots[slot.idx] = None
            slot.entry.carried = (
                list(slot.entry.carried) + list(slot.generated)
            )
            self.complete_terminal(slot.entry, "deadline")
            self._m_deadline.inc()
            progressed = True
        kept = []
        for entry in self._queue:
            dl = self._deadline_s(entry.req)
            if dl is not None and now - entry.req.arrival > dl:
                self.complete_terminal(entry, "deadline")
                self._m_deadline.inc()
                progressed = True
            else:
                kept.append(entry)
        if len(kept) != len(self._queue):
            self._queue = kept
        return progressed

    @property
    def pending(self) -> bool:
        """Work outstanding: anything queued or resident in a slot."""
        return bool(
            self._queue or any(s is not None for s in self._slots)
        )

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def slot_occupancy(self) -> float:
        """Live slots / capacity."""
        return (
            sum(s is not None for s in self._slots) / self.engine.capacity
        )

    @property
    def has_free_slot(self) -> bool:
        return any(s is None for s in self._slots)

    def next_arrival(self) -> Optional[float]:
        """The head entry's arrival (FIFO: the only entry whose arrival
        can unblock anything), or None on an empty queue."""
        return self._queue[0].req.arrival if self._queue else None

    def _worst_prefill_end(self, lo: int, hi: int) -> int:
        """Max padded prefill end over admission text lengths in
        ``[lo, hi]``.  The end is residue-monotone in the text length, so
        scanning the top ``prefill_chunk`` lengths covers every residue's
        maximum."""
        C = self.engine.prefill_ladder[-1]
        return max(
            self._padded_end(0, t)
            for t in range(max(lo, hi - C + 1), hi + 1)
        )

    def _try_admit(self) -> bool:
        if not self._queue:
            return False
        now = self.clock.now()
        entry = self._queue[0]
        if entry.req.arrival > now:
            return False
        free = [i for i, s in enumerate(self._slots) if s is None]
        if not free:
            return False
        eng = self.engine
        BL = eng.block_len
        text = list(entry.req.prompt) + list(entry.carried)
        # Match before the allocator gate: a hot fully cached prompt
        # borrows nearly all its blocks from the trie.
        matched, blocks, first = self._admission_plan(text)
        if not eng.pool.allocator.can_alloc(first):
            # The free list may be empty only because the prefix trie is
            # hoarding retired blocks: reuse potential never blocks a
            # live admission.
            if eng.prefix is None:
                return False
            need = first - eng.pool.allocator.free_blocks
            self._m_px_evicted.inc(eng.prefix.evict(need))
            # The eviction may have released matched blocks: re-plan.
            matched, blocks, first = self._admission_plan(text)
            if not eng.pool.allocator.can_alloc(first):
                return False
        self._queue.pop(0)
        if entry.first_admit is None:
            entry.first_admit = now
        slot = _Slot(free[0], entry, eng.max_blocks, now, self._admit_seq)
        self._admit_seq += 1
        self._slots[free[0]] = slot
        if eng.prefix is not None:
            if matched:
                eng.pool.allocator.share(blocks)
                for i, b in enumerate(blocks):
                    slot.table[i] = b
                slot.blocks = list(blocks)
                slot.pos = matched
                if matched % BL:
                    # The last mapped block is partially ours: this slot's
                    # first write into it copies it first.
                    slot.cow_idx = matched // BL
                entry.prefix_hit_tokens += matched
                self._m_px_hit.inc(matched)
            self._m_px_lookups.inc()
            self.prefix_lookup_tokens += len(text)
            self.prefix_hit_tokens += matched
            self._m_px_rate.set(
                self.prefix_hit_tokens / max(self.prefix_lookup_tokens, 1)
            )
            self._m_px_cached.set(eng.prefix.cached_blocks)
        self.engine.seed_slot(free[0], entry.req.seed,
                              entry.req.temperature)
        return True

    def _ladder_size(self, remaining: int) -> int:
        """The prefill chunk geometry for ``remaining`` tokens: full-size
        chunks while more than ``prefill_chunk`` remains, then the
        smallest ladder size covering the tail.  The one definition of
        the ladder policy."""
        ladder = self.engine.prefill_ladder
        if remaining >= ladder[-1]:
            return ladder[-1]
        return next(c for c in ladder if c >= remaining)

    def _padded_end(self, start: int, text_len: int) -> int:
        """Padded prefill end for a prefill that starts at ``start``."""
        remaining = text_len - start
        if remaining <= 0:
            return start
        r = remaining % self.engine.prefill_ladder[-1]
        if r == 0:
            return text_len
        return text_len - r + self._ladder_size(r)

    def _admission_plan(self, text):
        """``(matched, blocks, first_fresh)`` for ``text`` against the
        current trie: the capped prefix match, its table blocks, and the
        fresh blocks the first prefill chunk needs net of the mapped
        prefix (+1 for the copy of a partial block)."""
        eng = self.engine
        BL = eng.block_len
        matched, blocks, n_tbl = 0, [], 0
        if eng.prefix is not None:
            blocks, matched = eng.prefix.match(text, limit=len(text) - 1)
            matched = self._cap_match(matched, len(text))
            n_tbl = (matched + BL - 1) // BL
            blocks = blocks[:n_tbl]
        end1 = min(
            matched + self._ladder_size(len(text) - matched), len(text)
        )
        first = max(
            blocks_for(end1, BL) - n_tbl + (1 if matched % BL else 0), 0
        )
        return matched, blocks, first

    def _cap_match(self, matched: int, text_len: int) -> int:
        """Largest usable prefix match <= ``matched``: the remainder's
        padded prefill end must stay inside the block table and, for
        learned positions, the position table."""
        eng = self.engine
        cap = eng.max_blocks * eng.block_len
        if eng.model.pos_enc == "learned":
            cap = min(cap, eng.model.max_len)
        while matched > 0 and self._padded_end(matched, text_len) > cap:
            matched -= 1
        return matched

    # ----------------------------------------------------------- eviction
    def _evict_slot(self, victim: _Slot) -> None:
        """Recompute-requeue eviction: generated tokens fold into
        ``carried`` and the entry re-queues at the head."""
        self.engine.release_blocks(victim.blocks)
        victim.entry.carried = (
            list(victim.entry.carried) + list(victim.generated)
        )
        victim.entry.evictions += 1
        self._queue.insert(0, victim.entry)
        self._slots[victim.idx] = None

    def _evict_youngest(self) -> bool:
        live = [s for s in self._slots if s is not None]
        if not live:
            return False
        self._evict_slot(max(live, key=lambda s: s.admit_seq))
        return True

    def _alloc_blocks(self, slot: _Slot, n: int) -> Optional[List[int]]:
        """``n`` fresh blocks for ``slot`` under pool pressure: drain the
        prefix cache first, then evict the youngest slot (possibly
        ``slot`` itself, in which case ``None`` is returned)."""
        eng = self.engine
        while True:
            if self._slots[slot.idx] is not slot:
                # Already evicted by a co-slot's allocation this step;
                # growing it now would orphan the new blocks.
                return None
            got = eng.alloc_blocks(n)
            if got is not None:
                return got
            if eng.prefix is not None:
                need = n - eng.pool.allocator.free_blocks
                released = eng.prefix.evict(need)
                if released:
                    self._m_px_evicted.inc(released)
                    continue
            live = [s for s in self._slots if s is not None]
            if len(live) == 1 and live[0] is slot:
                raise PoolExhausted(
                    f"request {slot.entry.req.id} cannot fit the pool "
                    "even running alone: grow num_blocks"
                )
            self._evict_youngest()

    def _alloc_for(self, slot: _Slot, n_needed: int) -> None:
        """Grow ``slot`` to ``n_needed`` blocks, evicting under pressure."""
        while len(slot.blocks) < n_needed:
            got = self._alloc_blocks(slot, n_needed - len(slot.blocks))
            if got is None:
                return  # the needy slot evicted itself; re-queued
            for b in got:
                slot.table[len(slot.blocks)] = b
                slot.blocks.append(b)

    def _resolve_cow(self, slot: _Slot) -> None:
        """Copy the slot's borrowed partial prefix block before its first
        write into it: fresh block, one whole-block copy (target + draft
        pools), borrowed reference dropped."""
        if slot.cow_idx is None:
            return
        got = self._alloc_blocks(slot, 1)
        if got is None:
            return  # evicted itself under pressure; moot
        idx = slot.cow_idx
        src = slot.blocks[idx]
        self.engine.cow_copy(src, got[0])
        slot.table[idx] = got[0]
        slot.blocks[idx] = got[0]
        self.engine.release_blocks([src])
        slot.cow_idx = None
        self._m_px_cow.inc()

    # ------------------------------------------------------------ prefill
    def _prefill_round(self) -> bool:
        """One chunk for every currently prefilling slot, oldest first."""
        progressed = False
        for slot in sorted(
            (s for s in self._slots if s is not None and s.prefilling),
            key=lambda s: s.admit_seq,
        ):
            if self._slots[slot.idx] is not slot:
                continue  # evicted by an earlier candidate's allocation
            progressed = self._prefill_chunk(slot) or progressed
        return progressed

    def _prefill_chunk(self, slot: _Slot) -> bool:
        eng = self.engine
        p0 = slot.pos
        size = self._ladder_size(len(slot.text) - p0)
        end = min(p0 + size, len(slot.text))
        self._alloc_for(slot, blocks_for(end, eng.block_len))
        if self._slots[slot.idx] is not slot:
            return True  # evicted itself under pressure; progress made
        self._resolve_cow(slot)
        if self._slots[slot.idx] is not slot:
            return True
        chunk = np.zeros((size,), np.int32)
        chunk[: end - p0] = slot.text[p0:end]
        last = end == len(slot.text)
        t0 = time.perf_counter()
        tok = eng.prefill(
            slot.idx, chunk, p0, slot.table,
            last_idx=(end - p0 - 1) if last else -1,
        )
        self._m_prefill.observe((time.perf_counter() - t0) * 1e3)
        # A final chunk's first-token readback waits for every queued
        # operation; a non-final chunk is queued only, and its compute
        # lands in the next synced op (the mixed-iteration tag).
        self._unsynced_prefill = not last
        slot.pos = end
        if last:
            slot.prefilling = False
            if eng.prefix is not None:
                eng.prefix.insert(
                    slot.text,
                    slot.blocks[: len(slot.text) // eng.block_len],
                    owner=slot.entry.req.tenant,
                )
                self._m_px_cached.set(eng.prefix.cached_blocks)
            self._emit(slot, int(tok))
        return True

    # ------------------------------------------------------------- decode
    def _decode_step(self) -> bool:
        live = [
            s for s in self._slots if s is not None and not s.prefilling
        ]
        if not live:
            return False
        S = self.engine.capacity
        k = self.engine.spec_k
        tokens = np.zeros((S,), np.int32)
        pos = np.zeros((S,), np.int32)
        tables = np.zeros((S, self.engine.max_blocks), np.int32)
        active = np.zeros((S,), bool)
        for s in live:
            # The step writes position `pos` (a speculative round writes
            # through `pos + spec_k`): make sure those blocks exist.
            self._alloc_for(
                s, blocks_for(s.pos + 1 + k, self.engine.block_len)
            )
        live = [
            s for s in self._slots if s is not None and not s.prefilling
        ]
        if not live:
            return True  # everything evicted itself; still progress
        for s in live:
            tokens[s.idx] = s.last_token
            pos[s.idx] = s.pos
            tables[s.idx] = s.table
            active[s.idx] = True
        mixed = self._unsynced_prefill
        self._iterations += 1
        t0 = time.perf_counter()
        if self._fault is not None:
            # Inside the timed window, so an injected stretch lands in
            # this iteration's histogram like a real slowdown.
            self._fault.hook("serve_step", count=self._iterations)
        if k:
            out, n_accept = self.engine.spec_step(tokens, pos, tables,
                                                  active)
        else:
            out = self.engine.step(tokens, pos, tables, active)
        dur_ms = (time.perf_counter() - t0) * 1e3
        self._unsynced_prefill = False
        self.decode_iterations += 1
        self.decode_ms_total += dur_ms
        if mixed:
            self._m_mixed.observe(dur_ms)
        else:
            self._m_decode.observe(dur_ms)
        for s in live:
            if k:
                # Emit the accepted drafts plus the target's correction,
                # token by token: EOS or the budget can retire the slot
                # mid-round, and the over-accepted tail is dropped (its
                # K/V lies past pos and is rewritten later).
                na = int(n_accept[s.idx])
                emitted = 0
                for j in range(na + 1):
                    s.pos += 1
                    self._emit(s, int(out[s.idx, j]))
                    emitted += 1
                    if self._slots[s.idx] is not s:
                        break  # retired mid-round (EOS / budget)
                if s.entry.req.temperature <= 0:
                    # A mid-round retirement leaves the tail drafts
                    # neither accepted nor rejected.
                    acc = min(emitted, na)
                    prop = acc if emitted <= na else k
                    s.entry.spec_proposed += prop
                    s.entry.spec_accepted += acc
                    self.spec_proposed += prop
                    self.spec_accepted += acc
                    self._m_spec_prop.inc(prop)
                    self._m_spec_acc.inc(acc)
                    self._m_spec_rate.set(
                        self.spec_accepted / max(self.spec_proposed, 1)
                    )
            else:
                s.pos += 1
                self._emit(s, int(out[s.idx]))
        return True

    def _emit(self, slot: _Slot, tok: int) -> None:
        """Account one generated token; retire the slot when done."""
        self._m_tokens.inc()
        slot.generated.append(tok)
        slot.last_token = tok
        req = slot.entry.req
        reason = None
        if req.eos_token is not None and tok == req.eos_token:
            reason = "eos"
        elif slot.total_generated >= req.max_new_tokens:
            reason = "length"
        if reason is None:
            return
        eng = self.engine
        if eng.prefix is not None:
            # Multi-turn reuse: cache the full blocks of prompt + generated
            # history (positions [0, pos) are written; the last emitted
            # token's K/V never is).
            seq = slot.text + slot.generated
            eng.prefix.insert(
                seq[: slot.pos],
                slot.blocks[: slot.pos // eng.block_len],
                owner=req.tenant,
            )
            self._m_px_cached.set(eng.prefix.cached_blocks)
        eng.release_blocks(slot.blocks)
        self._slots[slot.idx] = None
        self.completions.append(Completion(
            id=req.id,
            tokens=list(slot.entry.carried) + list(slot.generated),
            reason=reason,
            prompt_len=len(req.prompt),
            arrival=req.arrival,
            admitted_at=slot.admit_time,
            finished_at=self.clock.now(),
            evictions=slot.entry.evictions,
            first_admitted_at=slot.entry.first_admit,
            prefix_hit_tokens=slot.entry.prefix_hit_tokens,
            spec_proposed=slot.entry.spec_proposed,
            spec_accepted=slot.entry.spec_accepted,
            retries=slot.entry.retries,
        ))

    # --------------------------------------------------------------- run
    def tick(self) -> bool:
        """One scheduling iteration (deadlines, admission, one prefill
        chunk per refilling slot, one decode step) plus the gauge
        refresh.  Returns whether anything progressed."""
        progressed = False
        if self._cancel_deadlines():
            progressed = True
        while self._try_admit():
            progressed = True
        if self._prefill_round():
            progressed = True
        if self._decode_step():
            progressed = True
        self._m_queue.set(len(self._queue))
        self._m_occ.set(self.slot_occupancy)
        return progressed

    def run(self, requests: Optional[Sequence[Request]] = None
            ) -> List[Completion]:
        """Submit ``requests`` (optional) and drain queue + slots."""
        for r in requests or ():
            self.submit(r)
        while self.pending:
            if not self.tick():
                if any(s is not None for s in self._slots):
                    raise RuntimeError(  # pragma: no cover - defensive
                        "scheduler made no progress with live slots"
                    )
                # Idle: jump the clock to the head entry's arrival.
                nxt = self.next_arrival()
                if nxt is None or nxt <= self.clock.now():
                    raise RuntimeError(
                        "scheduler made no progress on arrived work"
                    )
                self.clock.skip_to(nxt)
        self.finish()
        return list(self.completions)

    def finish(self) -> None:
        """The drain epilogue: closing gauge publishes."""
        self._m_queue.set(0)
        self._m_occ.set(0.0)
