"""Disaggregated prefill/decode serving: role-split replicas with live
KV-block migration over an object plane.

Chunked prefill bounds how long a prompt can stall running decodes, but
every iteration that interleaves a prefill chunk still books to
``serve.mixed_ms`` instead of ``serve.decode_ms``.  The fix (DistServe,
OSDI'24; Splitwise, ISCA'24) splits the two phases:

* **prefill roles** run admission + the chunked-prefill ladder and never
  take a decode step;
* **decode roles** run *clean* decode steps only — the captured decode
  step is replayed, never re-captured, under arbitrary migration churn,
  because the migration's device half is the engine's
  :meth:`~chainermn_tpu_torch.serving.engine.DecodeEngine.read_block` /
  :meth:`~chainermn_tpu_torch.serving.engine.DecodeEngine.write_block`
  (watched as the one-signature ``kv_gather`` / ``kv_put`` programs),
  which copy into the pool tensors in place;
* between them, the **KV-block migration primitive**: a finished slot's
  live physical blocks (target and spec-draft pools alike; bf16 as its
  int16 bits, int8 with its scales), block table, carried tokens and
  position are serialized, shipped as framed ``send_obj`` payloads, and
  the block table is rewritten against the destination allocator on
  arrival — byte-identical KV, so a migrated request continues exactly
  as it would have on the source (greedy tokens identical; sampling too,
  since the per-request generator is keyed by ``(seed, position)``).

Shared physical blocks migrate ONCE per payload: the wire format dedupes
by source block id, and the installer maps every referencing slot onto
one destination block via ``BlockAllocator.share`` — refcounted sharing
survives the move.  Migrated full prompt/history blocks are inserted
into the destination's prefix trie, so hot-prefix sharing survives too.

:func:`drain_all` moves everything a scheduler holds to a peer
(decode-ready slots with their KV; still-prefilling slots and queued
entries as recompute entries), so a serving process told to stop loses
no request.  A role built with ``guard=`` (a
:class:`~chainermn_tpu_torch.resilience.PreemptionGuard`) polls it every
tick; bind the role's drain to its peer with
``guard.attach_drain(lambda: role.drain(peer))``, so a SIGTERM migrates
every live slot and queued entry over the transport and the rank exits
75.

The transport takes any ``send_obj``/``recv_obj`` endpoint: the
in-process :class:`LocalComm`, a :class:`~chainermn_tpu_torch.hostcomm.
HostComm` or a communicator's object plane across processes.  Failure
accounting rides the ``CMN_FAULT`` grammar: the transport is a
``migrate`` hook site (``drop@migrate:N`` loses the Nth migration frame
on the wire), and a dropped or torn frame is caught by the receiver's
sequence/checksum validation — :class:`MigrationError`,
counted by ``serve.migration.failed``, watched by the critical
``migration_failed`` default incident rule.

Metrics (``serve.migration.*``): ``slots_migrated``, ``blocks_moved``,
``bytes``, ``migrate_ms`` and ``install_ms`` histograms, ``failed`` —
same publishing latch as the scheduler.

Env knobs: ``CMN_DISAGG_ROLES`` (comma role-per-rank spec for
:func:`roles_from_env`), ``CMN_DISAGG_DRAIN_PEER`` (drain destination),
``CMN_DISAGG_TIMEOUT_MS`` (migration recv deadline).
"""

from __future__ import annotations

import os
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from chainermn_tpu_torch.observability.metrics import (
    NoopInstrument as _NoopInstrument,
)
from chainermn_tpu_torch.resilience import faults as _faults
from chainermn_tpu_torch.serving.scheduler import (
    Completion,
    Request,
    Scheduler,
    _QueueEntry,
    _Slot,
)

#: Migration wire-format tag; bump on breaking layout changes (a peer
#: running older code must fail loudly, not misinstall blocks).
MIGRATION_SCHEMA = "cmn-kvmig-1"

#: The roles a serving rank can take.
ROLES = ("mixed", "prefill", "decode")


class MigrationError(RuntimeError):
    """A migration frame was dropped, torn, or malformed.  Counted by
    ``serve.migration.failed`` and watched by the ``migration_failed``
    default incident rule.  ``frame`` carries the received frame when it
    is itself INTACT (a sequence gap means an *earlier* frame was lost
    — this one's slots are still salvageable); ``None`` for a torn or
    malformed frame."""

    def __init__(self, msg: str, frame: Optional[dict] = None):
        super().__init__(msg)
        self.frame = frame


def roles_from_env(size: int) -> List[str]:
    """Per-rank roles from ``CMN_DISAGG_ROLES`` (comma-separated, e.g.
    ``"prefill,decode,decode"``); default: every rank ``mixed`` (no
    disaggregation).  A short spec repeats its last role to ``size``."""
    spec = os.environ.get("CMN_DISAGG_ROLES", "")
    if not spec:
        return ["mixed"] * size
    roles = [r.strip() for r in spec.split(",") if r.strip()]
    for r in roles:
        if r not in ROLES:
            raise ValueError(
                f"CMN_DISAGG_ROLES: unknown role {r!r} (one of {ROLES})"
            )
    if not roles:
        return ["mixed"] * size
    while len(roles) < size:
        roles.append(roles[-1])
    return roles[:size]


def drain_peer_from_env(rank: int, size: int,
                        roles: Optional[Sequence[str]] = None
                        ) -> Optional[int]:
    """The preemption drain destination for ``rank``:
    ``CMN_DISAGG_DRAIN_PEER`` when set (must name another live rank),
    else the next rank round-robin that can actually RECEIVE a
    migration stream — prefill ranks have no receive path, so with
    ``roles`` given (typically :func:`roles_from_env`) they are skipped
    and never chosen.  ``None`` when nobody is left to drain to
    (single-rank jobs; an all-prefill remainder).  The chosen peer must
    poll this rank — a :class:`DecodeRole` destination lists every rank
    that can drain to it in ``peer_ranks`` (wire the INVERSE of this
    function's choices, or simply every other non-prefill rank)."""
    spec = os.environ.get("CMN_DISAGG_DRAIN_PEER", "")
    if spec:
        peer = int(spec)
        if not (0 <= peer < size) or peer == rank:
            raise ValueError(
                f"CMN_DISAGG_DRAIN_PEER={peer} invalid for rank {rank} "
                f"of {size}"
            )
        if roles is not None and roles[peer] == "prefill":
            raise ValueError(
                f"CMN_DISAGG_DRAIN_PEER={peer} is a prefill rank — it "
                "never polls the migration plane, so a drained stream "
                "would be silently lost; pick a decode/mixed rank"
            )
        return peer
    for step in range(1, size):
        peer = (rank + step) % size
        if roles is None or roles[peer] != "prefill":
            return peer
    return None


# --------------------------------------------------------------- codec
def _pack_entry(entry: _QueueEntry) -> dict:
    r = entry.req
    return {
        "req": {
            "id": r.id, "prompt": list(r.prompt),
            "max_new_tokens": r.max_new_tokens,
            "temperature": r.temperature, "eos_token": r.eos_token,
            "arrival": r.arrival, "seed": r.seed,
            "deadline_ms": r.deadline_ms,
            "tenant": r.tenant,
            # Priority class survives migration, recovery re-dispatch
            # and the disagg handoff.
            "priority": r.priority,
        },
        "carried": list(entry.carried),
        "evictions": entry.evictions,
        "first_admit": entry.first_admit,
        "prefix_hit_tokens": entry.prefix_hit_tokens,
        "spec_proposed": entry.spec_proposed,
        "spec_accepted": entry.spec_accepted,
        "retries": entry.retries,
    }


def _unpack_entry(rec: dict) -> _QueueEntry:
    return _QueueEntry(
        req=Request(**rec["req"]),
        carried=list(rec["carried"]),
        evictions=rec["evictions"],
        first_admit=rec["first_admit"],
        prefix_hit_tokens=rec["prefix_hit_tokens"],
        spec_proposed=rec["spec_proposed"],
        spec_accepted=rec["spec_accepted"],
        # .get(): a cmn-kvmig-1 frame without the key still installs.
        retries=rec.get("retries", 0),
    )


def pack_slots(sched: Scheduler, slots: Sequence[_Slot]) -> dict:
    """Serialize live DECODE-READY slots (prefill finished) into one
    migration body: per-slot continuation state + the deduped physical
    blocks backing their tables (target and draft pools alike, read
    through the engine's ``read_block``).  Blocks
    shared across the packed slots (prefix sharing) appear ONCE."""
    from chainermn_tpu_torch.serving.sharding import mesh_model_size

    eng = sched.engine
    # A tensor-parallel engine reads its own KH/M heads; every model rank
    # ships as many, so the request's bytes are M times this rank's.
    ranks = mesh_model_size(getattr(eng, "mesh", None))
    blocks: Dict[int, dict] = {}
    recs = []
    for slot in slots:
        if slot.prefilling:
            raise ValueError(
                f"slot {slot.idx} (request {slot.entry.req.id}) is still "
                "prefilling — migrate it as a recompute entry instead "
                "(pack_slots ships finished KV only)"
            )
        for b in slot.blocks:
            if b not in blocks:
                blocks[b] = eng.read_block(b)
        if sched.ledger is not None:
            # Booked at pack (the send side — once per migration): each
            # slot pays for ITS blocks' bytes, shared blocks charged to
            # every referencing slot (pinner-pays, same stance as
            # block-seconds) — so the ledger total can exceed the
            # deduped wire bytes ``serve.migration.bytes`` counts.
            sched.ledger.book(
                slot.entry.req.id, "migration_bytes",
                ranks * sum(_block_nbytes(blocks[b]) for b in slot.blocks),
            )
        recs.append({
            **_pack_entry(slot.entry),
            "generated": list(slot.generated),
            "pos": int(slot.pos),
            "last_token": int(slot.last_token),
            "blocks": list(slot.blocks),
        })
    return {"slots": recs, "entries": [], "blocks": blocks}


def _block_nbytes(data: dict) -> int:
    """KV bytes one packed block carries (target + draft pools)."""
    total = 0
    for pool in ("target", "draft"):
        if data.get(pool) is None:
            continue
        for layer in data[pool]:
            for arr in layer.values():
                total += arr.nbytes
    return total


def payload_bytes(body: dict) -> int:
    """KV bytes a migration body moves (the ``serve.migration.bytes``
    feed) — block array bytes only; the host-side slot records are
    noise next to them."""
    return sum(_block_nbytes(d) for d in body["blocks"].values())


def _crc(body: dict) -> int:
    """Checksum over every block's bytes, in deterministic order — the
    torn-frame detector (a frame whose KV bytes were corrupted in
    flight must not be installed as if byte-identical)."""
    c = 0
    for b in sorted(body["blocks"]):
        data = body["blocks"][b]
        for pool in ("target", "draft"):
            if data.get(pool) is None:
                continue
            for layer in data[pool]:
                for name in sorted(layer):
                    c = zlib.crc32(layer[name].tobytes(), c)
    return c


def detach_slots(sched: Scheduler, slots: Sequence[_Slot]) -> None:
    """Release migrated slots from the SOURCE scheduler: their block
    references return to the allocator (shared/trie-held blocks survive
    by refcount, exactly as retirement) and the slots free up.  Call
    only after the payload is on the wire."""
    for slot in slots:
        if sched._slots[slot.idx] is not slot:
            continue
        sched.engine.release_blocks(slot.blocks)
        sched._slots[slot.idx] = None
        if sched.ledger is not None:
            # Settle source-side occupancy; the install restarts the
            # integral at the destination (a fleet-shared ledger sees a
            # clean handoff; role-split ledgers each stay consistent).
            sched.ledger.set_blocks(
                slot.entry.req.id, 0, sched.clock.now()
            )
        if sched.timeline is not None:
            sched.timeline.record(
                "migrate_out", t=sched.clock.now(),
                req=slot.entry.req.id, slot=slot.idx,
                info={"pos": int(slot.pos), "blocks": len(slot.blocks)},
            )


def install_payload(sched: Scheduler, body: dict, defer: bool = False
                    ) -> Tuple[int, int, Optional[dict]]:
    """Install a migration body into the DESTINATION scheduler.

    Per slot: allocate fresh physical blocks (first referencing slot
    owns them; later slots :meth:`~chainermn_tpu_torch.serving.kv_pool.
    BlockAllocator.share` — sharing survives migration with no
    double-free), write the KV in place through the engine's
    ``write_block``, REWRITE the block table against the destination
    allocator's ids, rebuild the slot's host state, and insert the full
    prompt/history blocks into the destination prefix trie so the
    migrated prefix is mappable by future admissions.

    A slot the destination cannot place right now (no free slot / pool
    blocks): with ``defer=True`` (the decode role) its record and block
    data move to a REMAINDER body the caller retries when a slot frees
    — the KV was already paid for, and re-prefilling it on a decode
    rank would put mixed iterations right back on the clean histograms;
    with ``defer=False`` it falls back to a recompute ENTRY (carried
    tokens ride along).  Either way nothing is ever lost.

    Returns ``(slots_installed, entries_queued, remainder_or_None)``.
    """
    eng = sched.engine
    now = sched.clock.now()
    t0 = time.perf_counter()
    dst_map: Dict[int, int] = {}
    claimed: Dict[int, bool] = {}
    installed = queued = 0
    deferred: List[dict] = []
    for rec in body["slots"]:
        entry = _unpack_entry(rec)
        free = [i for i, s in enumerate(sched._slots) if s is None]
        fresh = [b for b in rec["blocks"] if b not in dst_map]
        if free and not eng.pool.allocator.can_alloc(len(fresh)) and \
                eng.prefix is not None:
            # Cached-only trie blocks are reuse potential — a live
            # migrated slot beats them, same policy as admission.  Only
            # when a slot is actually available: with every slot busy
            # the record defers regardless, and a deferred-retry loop
            # that evicted the trie each tick would strip exactly the
            # migrated hot prefixes this installer exists to preserve.
            sched._m_px_evicted.inc(eng.prefix.evict(
                len(fresh) - eng.pool.allocator.free_blocks
            ))
        if not free or not eng.pool.allocator.can_alloc(len(fresh)):
            if defer:
                deferred.append(rec)
            else:
                # Recompute fallback: requeue with everything generated
                # so far carried — the destination prefills it back
                # (usually a trie hit on blocks installed moments ago).
                entry.carried = (
                    list(entry.carried) + list(rec["generated"])
                )
                sched.submit_entry(entry)
                queued += 1
            continue
        got = eng.alloc_blocks(len(fresh))
        for src, dst in zip(fresh, got):
            dst_map[src] = dst
            eng.write_block(dst, body["blocks"][src])
            claimed[dst] = False
        slot = _Slot(free[0], entry, eng.max_blocks, now,
                     sched._admit_seq)
        sched._admit_seq += 1
        slot.blocks = []
        for b in rec["blocks"]:
            dst = dst_map[b]
            if claimed[dst]:
                eng.pool.allocator.share([dst])
            claimed[dst] = True
            slot.table[len(slot.blocks)] = dst
            slot.blocks.append(dst)
        slot.pos = int(rec["pos"])
        slot.generated = list(rec["generated"])
        slot.last_token = int(rec["last_token"])
        slot.prefilling = False
        sched._slots[free[0]] = slot
        if sched.ledger is not None:
            # begin() is idempotent: on a fleet-shared ledger the record
            # exists; a role-split destination with its own ledger opens
            # one here (tenant rides the codec).  Occupancy integration
            # restarts at the installed block count.
            sched.ledger.begin(entry.req, now)
            sched.ledger.set_blocks(
                entry.req.id, len(slot.blocks), now
            )
        eng.seed_slot(free[0], entry.req.seed, entry.req.temperature)
        if eng.prefix is not None:
            # Positions [0, pos) are written — same insertable span as
            # retirement's: the migrated hot prefix becomes a trie hit
            # for the next identical prompt at the destination.
            seq = slot.text + slot.generated
            eng.prefix.insert(
                seq[: slot.pos],
                slot.blocks[: slot.pos // eng.block_len],
            )
        if sched.timeline is not None:
            sched.timeline.record(
                "migrate_in", t=now, req=entry.req.id, slot=free[0],
                info={"pos": slot.pos, "blocks": len(slot.blocks)},
            )
        installed += 1
    for rec in body["entries"]:
        sched.submit_entry(_unpack_entry(rec))
        queued += 1
    if eng.prefix is not None:
        # Same gauge refresh as the scheduler's own insert/evict sites:
        # the trie pins migration just created (or the eviction it
        # forced) must show in ``serve.prefix.cached_blocks`` NOW, not
        # at the next local retirement — the memory watermark sampler
        # reads this exactly in the migration-churn window.
        sched._m_px_cached.set(eng.prefix.cached_blocks)
    if installed:
        # Drain the ``write_block`` copies NOW: left queued, the next
        # decode step's token readback would absorb them into its timed
        # window, and the clean-decode histograms / SLO token p95 would
        # silently carry migration-install cost (exactly the attribution
        # leak ``serve.mixed_ms`` exists to prevent for prefill).  The
        # install cost books to ``serve.migration.install_ms`` instead.
        eng.sync()
        sched._m_mig_install.observe((time.perf_counter() - t0) * 1e3)
    remainder = None
    if deferred:
        need = {b for rec in deferred for b in rec["blocks"]}
        # A deferred slot sharing a block with one just installed gets
        # its own copy on retry (dst_map is per-call): byte-identical
        # content, just without the refcount link — correct, merely less
        # shared.
        remainder = {
            "slots": deferred, "entries": [],
            "blocks": {b: body["blocks"][b] for b in need},
        }
    return installed, queued, remainder


# ----------------------------------------------------------- transport
class MigrationTransport:
    """Framed slot migration over any ``send_obj``/``recv_obj`` object
    plane (an in-process :class:`LocalComm` endpoint here).

    Each frame carries the schema tag, a per-destination sequence
    number, and a CRC over the KV bytes; the receiver validates all
    three, so a dropped frame (``CMN_FAULT=drop@migrate:N`` — the wire
    loses the Nth migration send) surfaces as a sequence gap on the
    next frame and a torn frame as a checksum mismatch — both raise
    :class:`MigrationError` and count ``serve.migration.failed``.

    Publishing follows the scheduler's latch: an explicit ``registry``
    always publishes ``serve.migration.*``; otherwise the ambient
    global registry rides the ``CMN_OBS`` master switch.

    Between tensor-parallel engines (``model_rank``, the engine mesh's
    rank): a peer is named by its group's model rank 0, and model rank
    ``m`` sends to and receives from rank ``peer + m`` of the world, so
    each model rank ships its own ``KH/M`` heads of every block in a
    frame of its own, with its own checksum.  The slot records are the
    same on every model rank (their schedulers are replicated).
    """

    def __init__(self, comm, registry=None, timeout_ms: Optional[int] = None,
                 injector=None, model_rank: int = 0):
        import chainermn_tpu_torch.observability as _obs
        from chainermn_tpu_torch.observability.metrics import (
            DEFAULT_MS_EDGES,
            registry as global_registry,
        )

        self.comm = comm
        self.model_rank = int(model_rank)
        if timeout_ms is None:
            env = os.environ.get("CMN_DISAGG_TIMEOUT_MS", "")
            timeout_ms = int(env) if env else None
        self.timeout_ms = timeout_ms
        self._fault = (
            injector if injector is not None
            else _faults.process_injector()
        )
        self._seq_out: Dict[int, int] = {}
        self._seq_in: Dict[int, int] = {}
        if registry is None and not _obs.enabled():
            noop = _NoopInstrument()
            self._m_slots = self._m_blocks = self._m_bytes = noop
            self._m_ms = self._m_failed = noop
        else:
            reg = registry if registry is not None else global_registry()
            self._m_slots = reg.counter("serve.migration.slots_migrated")
            self._m_blocks = reg.counter("serve.migration.blocks_moved")
            self._m_bytes = reg.counter("serve.migration.bytes")
            self._m_ms = reg.histogram(
                "serve.migration.migrate_ms", edges=DEFAULT_MS_EDGES
            )
            self._m_failed = reg.counter("serve.migration.failed")

    # ------------------------------------------------------------- send
    def send(self, body: dict, dest: int) -> None:
        """Frame and ship one migration body (schema + seq + crc)."""
        seq = self._seq_out.get(dest, 0)
        self._seq_out[dest] = seq + 1
        frame = {
            "schema": MIGRATION_SCHEMA, "seq": seq, "kind": "slots",
            "crc": _crc(body), "body": body,
        }
        self._m_slots.inc(len(body["slots"]))
        self._m_blocks.inc(len(body["blocks"]))
        self._m_bytes.inc(payload_bytes(body))
        if self._fault is not None and \
                self._fault.hook("migrate") == "drop":
            # Injected drop: the frame is lost ON THE WIRE — the sender
            # proceeds as delivered (seq consumed), the receiver sees a
            # sequence gap on the next frame.
            return
        self._send(frame, dest)

    def send_eof(self, dest: int) -> None:
        """Signal this source has no more migrations (role shutdown /
        drain complete) — receivers stop polling it."""
        seq = self._seq_out.get(dest, 0)
        self._seq_out[dest] = seq + 1
        self._send({"schema": MIGRATION_SCHEMA, "seq": seq, "kind": "eof"},
                   dest)

    def _send(self, frame: dict, dest: int) -> None:
        self.comm.send_obj(frame, dest + self.model_rank, op="migrate")

    def _recv(self, source: int, timeout_ms: Optional[int]):
        kw = {} if timeout_ms is None else {"timeout_ms": timeout_ms}
        return self.comm.recv_obj(source + self.model_rank, op="migrate",
                                  **kw)

    def received(self, source: int) -> int:
        """The next sequence number expected from ``source``: every
        frame below it has arrived here or is known lost (a gap or a
        torn frame)."""
        return self._seq_in.get(source, 0)

    def observe_ms(self, ms: float) -> None:
        """Book one end-to-end migration latency (pack + send +
        detach — the source-side cost of moving the slots)."""
        self._m_ms.observe(ms)

    # ------------------------------------------------------------- recv
    def recv(self, source: int, timeout_ms: Optional[int] = None) -> dict:
        """Receive + validate one migration frame.  Raises
        :class:`MigrationError` (and counts ``serve.migration.failed``)
        on schema mismatch, sequence gap (a dropped frame's slots are
        gone — the sender released them), or CRC mismatch (torn KV)."""
        if timeout_ms is None:
            timeout_ms = self.timeout_ms
        frame = self._recv(source, timeout_ms)
        if not isinstance(frame, dict) or \
                frame.get("schema") != MIGRATION_SCHEMA:
            self._m_failed.inc()
            # Consume the bad frame's slot in the sequence when it has
            # one: the NEXT valid frame must not be condemned as a gap
            # (a second failed count + a "slots lost" log for a frame
            # that arrived intact).
            if isinstance(frame, dict) and \
                    isinstance(frame.get("seq"), int):
                self._seq_in[source] = frame["seq"] + 1
            raise MigrationError(
                f"migration frame from rank {source} has schema "
                f"{frame.get('schema') if isinstance(frame, dict) else type(frame).__name__!r}"
                f" (want {MIGRATION_SCHEMA}) — peer version skew?"
            )
        expect = self._seq_in.get(source, 0)
        got = frame.get("seq")
        # The frame itself is intact: later frames must keep validating,
        # so the expected sequence resumes AFTER this one.
        self._seq_in[source] = int(got) + 1
        if got != expect:
            self._m_failed.inc()
            # The gap condemns the EARLIER frame(s); this one is still
            # installable if its own checksum holds — hand it back on
            # the error so the caller can salvage its slots.
            intact = (
                frame["kind"] != "slots"
                or _crc(frame["body"]) == frame["crc"]
            )
            raise MigrationError(
                f"migration frame from rank {source}: sequence {got}, "
                f"expected {expect} — {got - expect} frame(s) dropped in "
                "flight (their slots are lost; re-prefill from the "
                "request log upstream)",
                frame=frame if intact else None,
            )
        if frame["kind"] == "slots" and _crc(frame["body"]) != frame["crc"]:
            self._m_failed.inc()
            raise MigrationError(
                f"migration frame from rank {source} seq {got}: KV "
                "checksum mismatch — torn frame, refusing to install"
            )
        return frame

    def poll(self, source: int,
             timeout_ms: Optional[int] = 0) -> Optional[dict]:
        """Non/short-blocking :meth:`recv`: ``None`` when no frame
        arrived within ``timeout_ms``.  Validation errors still raise."""
        try:
            return self.recv(source, timeout_ms=timeout_ms)
        except MigrationError:
            raise
        except TimeoutError as e:
            # PeerFailedError subclasses TimeoutError; only a genuine
            # deadline expiry is a quiet "nothing yet" — a transport
            # failure or detector verdict must surface.
            if getattr(e, "kind", "timeout") != "timeout":
                raise
            return None


# ------------------------------------------------------ migration verbs
def handoff_slots(src: Scheduler, dst: Scheduler,
                  slots: Optional[Sequence[_Slot]] = None
                  ) -> Tuple[int, int]:
    """In-process scale-down / rolling-deploy handoff: pack
    ``slots`` (default: every decode-ready slot) from ``src`` and
    install them straight into ``dst`` — the same cmn-kvmig-1 body the
    framed transport ships, minus the wire, so the engines'
    ``read_block``/``write_block`` do the move and the survivor never
    re-captures.  Slots detach from ``src`` only AFTER
    the install returns: an exception mid-install leaves the source
    intact (over-held beats lost; the caller's fault boundary decides
    what to do with the husk).  Returns ``(slots_installed,
    entries_queued)`` — ``entries_queued`` counts slots the destination
    could not place live (no free slot / pool blocks) that fell back to
    recompute entries on its queue, carried tokens preserved."""
    slots = src.ready_slots() if slots is None else list(slots)
    if not slots:
        return 0, 0
    body = pack_slots(src, slots)
    installed, queued, _ = install_payload(dst, body)
    detach_slots(src, slots)
    return installed, queued


def migrate_slots(sched: Scheduler, transport: MigrationTransport,
                  dest: int, slots: Sequence[_Slot]) -> int:
    """Move live decode-ready ``slots`` to peer ``dest``: pack → framed
    send → detach from the source.  Returns the slot count."""
    if not slots:
        return 0
    t0 = time.perf_counter()
    body = pack_slots(sched, slots)
    transport.send(body, dest)
    detach_slots(sched, slots)
    transport.observe_ms((time.perf_counter() - t0) * 1e3)
    return len(body["slots"])


def drain_all(sched: Scheduler, transport: MigrationTransport,
              dest: int, eof: bool = True,
              deferred: Sequence[dict] = (),
              eof_ranks: Sequence[int] = ()) -> dict:
    """Preemption drain: migrate EVERYTHING this scheduler holds to
    ``dest`` — decode-ready slots ship their live KV, still-prefilling
    slots and every queued entry ship as recompute entries (carried
    tokens ride along) — then optionally signal ``eof``.  Zero in-flight
    requests are lost; the peer's completions are greedy-identical to
    what an unpreempted run would have produced (byte-identical KV +
    stateless per-request RNG).  ``deferred`` forwards migration bodies
    a decode role had parked waiting for capacity (they hold requests
    no other rank knows about — a drain that dropped them would break
    the zero-loss contract; :meth:`DecodeRole.drain` passes its
    backlog).  ``eof_ranks`` closes the stream toward EVERY peer this
    rank was feeding, not just the drain destination — a decode rank
    still waiting on this source's eof would otherwise never terminate
    (:meth:`PrefillRole.drain` passes its full ``decode_ranks``).
    Returns a summary dict (for a log line or a flight record)."""
    t0 = time.perf_counter()
    fwd_slots = 0
    for b in deferred:
        transport.send(b, dest)
        fwd_slots += len(b["slots"]) + len(b["entries"])
    ready = sched.ready_slots()
    body = pack_slots(sched, ready)
    for slot in sched._slots:
        if slot is None or not slot.prefilling:
            continue
        entry = slot.entry
        entry.carried = list(entry.carried) + list(slot.generated)
        body["entries"].append(_pack_entry(entry))
    while sched._queue:
        body["entries"].append(_pack_entry(sched._queue.pop(0)))
    transport.send(body, dest)
    detach_slots(sched, ready)
    for i, slot in enumerate(sched._slots):
        if slot is not None:
            sched.engine.release_blocks(slot.blocks)
            sched._slots[i] = None
            if sched.ledger is not None:
                # Still-prefilling slots drained as recompute entries:
                # settle their occupancy at release like any eviction.
                sched.ledger.set_blocks(
                    slot.entry.req.id, 0, sched.clock.now()
                )
    if eof:
        for d in dict.fromkeys([dest, *eof_ranks]):
            transport.send_eof(d)
    transport.observe_ms((time.perf_counter() - t0) * 1e3)
    out = {
        "dest": dest,
        "slots": len(body["slots"]),
        "entries": len(body["entries"]),
        "blocks": len(body["blocks"]),
        "bytes": payload_bytes(body),
    }
    if fwd_slots:
        out["deferred_forwarded"] = fwd_slots
    return out


# ---------------------------------------------------------------- roles
class PrefillRole:
    """Drives a :class:`~chainermn_tpu_torch.serving.Scheduler` in
    prefill-only mode: admission + the chunked-prefill ladder, then
    every slot whose prefill finished (first token sampled) ships to a
    decode rank — this rank never takes a decode step, so its
    ``serve.mixed_ms`` is the only place prefill/decode interference
    can land, and the decode ranks' histograms stay clean.

    Requests that complete AT prefill (``max_new_tokens == 1``, or EOS
    on the first token) retire locally — their completions merge with
    the decode ranks' downstream.
    """

    def __init__(self, sched: Scheduler, transport: MigrationTransport,
                 decode_ranks: Sequence[int], guard=None):
        if not decode_ranks:
            raise ValueError("prefill role needs >= 1 decode rank")
        self.sched = sched
        self.transport = transport
        self.decode_ranks = list(decode_ranks)
        self.guard = guard
        self._rr = 0
        self._ticks = 0

    def submit(self, req: Request) -> None:
        self.sched.submit(req)

    def tick(self) -> bool:
        """One prefill-role iteration: admit, one chunk per refilling
        slot, ship every finished slot (round-robin over the decode
        ranks).  Returns whether anything progressed."""
        self._ticks += 1
        if self.guard is not None:
            self.guard.poll_serving(self._ticks)
        if self.sched._latches:
            self.sched.clock.latch()
        progressed = False
        while self.sched._try_admit():
            progressed = True
        if self.sched._prefill_round():
            progressed = True
        ready = [
            s for s in self.sched._slots
            if s is not None and not s.prefilling
        ]
        if ready:
            # Round-robin PER SLOT (near-simultaneous completions are
            # the common case — similar-length prompts admitted
            # together), grouped per destination so blocks shared
            # within a batch still ship once.
            groups: Dict[int, List[_Slot]] = {}
            for s in ready:
                dest = self.decode_ranks[
                    self._rr % len(self.decode_ranks)
                ]
                self._rr += 1
                groups.setdefault(dest, []).append(s)
            for dest, batch in groups.items():
                migrate_slots(self.sched, self.transport, dest, batch)
            progressed = True
        self.sched._m_queue.set(len(self.sched._queue))
        self.sched._m_occ.set(self.sched.slot_occupancy)
        return progressed

    @property
    def pending(self) -> bool:
        return self.sched.pending

    def finish(self) -> None:
        """Signal every decode rank this source is done, close books."""
        for d in self.decode_ranks:
            self.transport.send_eof(d)
        self.sched.finish()

    def drain(self, dest: int) -> dict:
        """This role's preemption drain: everything the scheduler holds goes to
        ``dest``, and EVERY decode rank this role feeds gets the eof —
        a decode peer still waiting on this source would otherwise
        never terminate its loop."""
        return drain_all(
            self.sched, self.transport, dest,
            eof_ranks=self.decode_ranks,
        )


class DecodeRole:
    """Drives a :class:`~chainermn_tpu_torch.serving.Scheduler` as a decode
    rank: installs migration frames from the prefill ranks, then runs
    the scheduler's normal tick — with no local admissions and no
    prefilling slots that is CLEAN decode steps only (every iteration
    books to ``serve.decode_ms``; the one-compile contract holds under
    churn).  Drained recompute ENTRIES (preemption) do re-enter through
    prefill here — resilience beats purity when a peer is dying.

    ``peer_ranks`` names the decode/mixed peers whose PREEMPTION DRAIN
    may target this rank (i.e. every rank for which
    :func:`drain_peer_from_env` can pick us): they are polled for
    frames exactly like prefill sources, but a healthy peer never
    sends anything — so unlike prefill sources they do NOT gate
    :attr:`done` (waiting on an eof a healthy peer never emits would
    deadlock every unpreempted run).  Wiring a drain source into
    ``prefill_ranks`` instead is exactly that deadlock — use
    ``peer_ranks``.

    On a tensor-parallel engine every model rank receives its own frames
    (a transport with ``model_rank``), each when the wire brings it and
    each with its own checksum, but the ranks' schedulers must install
    the same slots in the same tick or their collectives pair different
    steps.  So each rank parks the valid frames it polled by sequence
    number, and one all-gather over the engine's mesh per tick hands the
    scheduler, per source, every sequence number that each model rank
    has received or knows lost: a frame valid on every model rank is
    installed, and one that any model rank lost (torn, or a gap on its
    wire alone) is lost on every rank alike, as a one-rank engine loses
    a torn frame."""

    def __init__(self, sched: Scheduler, transport: MigrationTransport,
                 prefill_ranks: Sequence[int], guard=None,
                 peer_ranks: Sequence[int] = ()):
        self.sched = sched
        self.transport = transport
        self.prefill_ranks = list(prefill_ranks)
        self.peer_ranks = [
            r for r in peer_ranks if r not in self.prefill_ranks
        ]
        self.guard = guard
        self._eof = set()
        #: sources whose eof arrived here (not necessarily agreed yet).
        self._closed = set()
        #: per source, the valid frames polled and not yet handed over,
        #: by sequence number.
        self._inbox: Dict[int, Dict[int, dict]] = {}
        #: per source, the next sequence number to hand over.
        self._next: Dict[int, int] = {}
        self._ticks = 0
        #: migration bodies waiting for a slot/blocks to free up (the
        #: KV is already paid for — deferring beats re-prefilling).
        self._deferred: List[dict] = []

    def _install(self, body: dict) -> bool:
        installed, queued, rest = install_payload(
            self.sched, body, defer=True
        )
        if rest is not None:
            self._deferred.append(rest)
        return bool(installed or queued)

    def tick(self, poll_ms: int = 0) -> bool:
        """One decode-role iteration: retry deferred installs, drain
        arrived migration frames from every still-open source, then one
        scheduler tick."""
        self._ticks += 1
        if self.guard is not None:
            self.guard.poll_serving(self._ticks)
        progressed = False
        if self._deferred:
            backlog, self._deferred = self._deferred, []
            for body in backlog:
                if self._install(body):
                    progressed = True
        sources = (*self.prefill_ranks, *self.peer_ranks)
        for src in sources:
            inbox = self._inbox.setdefault(src, {})
            while src not in self._closed:
                try:
                    frame = self.transport.poll(src, timeout_ms=poll_ms)
                except MigrationError as e:
                    # One lost/torn frame must not take the rank (and
                    # every resident slot) with it: the failure is
                    # counted (``serve.migration.failed`` — the
                    # ``migration_failed`` rule fires at the next
                    # incident evaluation), sequence validation already
                    # resumed, and an intact frame that merely REPORTED
                    # the gap still gets its slots installed.
                    import sys as _sys

                    _sys.stderr.write(
                        f"[chainermn_tpu_torch.serving.disagg] from rank "
                        f"{src}: {e}\n"
                    )
                    if e.frame is None:
                        continue
                    frame = e.frame
                if frame is None:
                    break
                inbox[frame["seq"]] = frame
                if frame["kind"] == "eof":
                    self._closed.add(src)
        for src, frame in self._agreed(sources):
            if frame is None:
                progressed = True
            elif frame["kind"] == "eof":
                self._eof.add(src)
            elif self._install(frame["body"]):
                progressed = True
        if self.sched.tick():
            progressed = True
        return progressed

    def _agreed(self, sources) -> List[Tuple[int, Optional[dict]]]:
        """The frames to hand over now, in source and sequence order
        (None for a lost one): on a one-rank engine every sequence
        number received or known lost; on a tensor-parallel one (one
        all-gather) those below every model rank's horizon, a frame
        only where every model rank holds a valid copy."""
        held = [(self.transport.received(src), sorted(self._inbox[src]))
                for src in sources]
        mesh = getattr(self.sched.engine, "mesh", None)
        every = mesh.allgather_obj(held) \
            if mesh is not None and mesh.size > 1 else [held]
        out = []
        for k, src in enumerate(sources):
            upto = min(e[k][0] for e in every)
            valid = set.intersection(*(set(e[k][1]) for e in every))
            for seq in range(self._next.get(src, 0), upto):
                frame = self._inbox[src].pop(seq, None)
                if seq not in valid and frame is not None:
                    # Valid here, lost on a peer model rank: lost here
                    # too, counted as the peer counted it.
                    import sys as _sys

                    self.transport._m_failed.inc()
                    _sys.stderr.write(
                        f"[chainermn_tpu_torch.serving.disagg] from rank "
                        f"{src} seq {seq}: lost on another model rank, "
                        "dropped on every rank\n")
                out.append((src, frame if seq in valid else None))
            self._next[src] = upto
        return out

    @property
    def done(self) -> bool:
        """Every PREFILL source signalled eof and nothing is left to
        serve.  ``peer_ranks`` (potential drain sources) don't gate
        this: a healthy peer never sends an eof."""
        return (
            all(src in self._eof for src in self.prefill_ranks)
            and not self.sched.pending
            and not self._deferred
        )

    def drain(self, dest: int) -> dict:
        """This role's preemption drain (a decode rank's): everything the scheduler holds
        PLUS the deferred migration backlog — bodies parked here hold
        requests no other rank knows about, so a drain that skipped
        them would silently break the zero-loss contract."""
        deferred, self._deferred = self._deferred, []
        return drain_all(
            self.sched, self.transport, dest, deferred=deferred
        )

    def run_loop(self, poll_ms: int = 50) -> List[Completion]:
        """Multi-rank service loop: tick until every prefill source is
        done and the last slot retires (the decode rank's ``main``).
        Ticks BEFORE checking :attr:`done`, so a pure drain receiver
        (no prefill sources, only ``peer_ranks``) installs the frames
        already queued for it instead of terminating vacuously."""
        while True:
            progressed = self.tick(poll_ms=poll_ms)
            if self.done:
                break
            if not progressed:
                nxt = self.sched.next_arrival()
                if nxt is not None:
                    self.sched.clock.skip_to(nxt)
        self.sched.finish()
        return list(self.sched.completions)


def serve_disaggregated(prefill: PrefillRole, decode: DecodeRole,
                        requests: Optional[Sequence[Request]] = None
                        ) -> List[Completion]:
    """Single-process loop for one prefill/decode role pair on a
    SHARED scheduler clock (tier-1 tests, benchmarks): interleave the
    two roles' ticks until the stream drains, then merge completions
    (sorted by finish time).  Multi-rank deployments run each role's
    own loop instead (:meth:`DecodeRole.run_loop`)."""
    for r in requests or ():
        prefill.submit(r)
    clock = prefill.sched.clock
    while prefill.pending:
        # Decode first: both roles share one process (and, on the CPU
        # rig, one device), so ticking prefill first would queue its
        # chunk dispatches ahead of the decode step inside every loop
        # iteration — exactly the contamination the role split exists
        # to remove.  Real deployments separate the devices; the order
        # here keeps the in-process approximation honest.
        d = decode.tick()
        p = prefill.tick()
        if not (p or d):
            nxt = prefill.sched.next_arrival()
            if nxt is None:  # pragma: no cover - defensive
                raise RuntimeError(
                    "disagg pair made no progress with work pending"
                )
            clock.skip_to(nxt)
    prefill.finish()
    while not decode.done:
        if not decode.tick():
            nxt = decode.sched.next_arrival()
            if nxt is None:  # pragma: no cover - defensive
                raise RuntimeError(
                    "decode role made no progress with work pending"
                )
            clock.skip_to(nxt)
    decode.sched.finish()
    out = list(prefill.sched.completions) + list(decode.sched.completions)
    return sorted(out, key=lambda c: (c.finished_at, c.id))


# ------------------------------------------------------- in-process comm
class _LocalEndpoint:
    """One rank's view of a :class:`LocalComm` — the ``send_obj`` /
    ``recv_obj`` surface :class:`MigrationTransport` needs."""

    def __init__(self, mesh: "LocalComm", rank: int):
        self._mesh = mesh
        self.rank = rank
        self.size = mesh.size

    def send_obj(self, obj, dest: int, timeout_ms=None,
                 op: str = "send_obj") -> None:
        import pickle

        # Pickle round-trip: wire-faithful framing (the payload must
        # survive real serialization, as a cross-process plane's would).
        self._mesh.queues[(self.rank, dest)].append(pickle.dumps(obj))

    def recv_obj(self, source: int, timeout_ms=None,
                 op: str = "recv_obj"):
        import pickle

        q = self._mesh.queues[(source, self.rank)]
        if not q:
            raise TimeoutError(
                f"recv_obj from {source}: no frame queued (LocalComm is "
                "single-threaded — timeouts cannot be waited out)"
            )
        return pickle.loads(q.popleft())


class LocalComm:
    """In-process N-rank object plane over queue pairs, packaged for single-process role-split
    serving (tier-1 tests, the ``--disagg`` bench arm).  Frames pickle
    through, so payloads are exercised against real serialization;
    ``recv_obj`` on an empty queue raises ``TimeoutError`` immediately
    (single-threaded — there is nobody else to wait for)."""

    def __init__(self, size: int):
        from collections import deque

        self.size = int(size)
        self.queues = {
            (s, d): deque()
            for s in range(size) for d in range(size) if s != d
        }

    def endpoint(self, rank: int) -> _LocalEndpoint:
        return _LocalEndpoint(self, rank)
