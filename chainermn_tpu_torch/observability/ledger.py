"""Usage ledger — per-request cost attribution, per-tenant metering.

A :class:`CostLedger` assembles, for every request the scheduler serves,
one :class:`UsageRecord` — prefill tokens *computed* vs prefix-hit
tokens *saved*, decode iterations consumed, speculative tokens
proposed/accepted, **KV block-seconds** (per-slot block occupancy
integrated over the scheduler clock — the scarce resource a quota must
meter), COW copies, migration bytes, eviction requeues, retry counts,
queue wait, and the terminal status — attributed across every path a
request can take (eviction-recompute, prefix sharing, deadline
terminals).

Attribution policy, in two sentences: *saved* prefix tokens are credited
to the request that hit the cache (``prefix_hit_tokens``), but the
blocks it maps — shared or fresh — count toward ITS block-seconds while
mapped (pool pressure is charged to the pinner); trie-only pinned blocks
with no live holder are fleet overhead, visible as
``serve.prefix.cached_blocks``, never attributed to a tenant.
Recompute after an eviction books its prefill tokens AGAIN — recompute
is a real cost and the ledger reports what was paid, not what an oracle
run would have cost.

**Conservation** is the headline invariant: every dimension is booked as
an *integer* (block-seconds in integer block-microseconds) simultaneously
into the request's record, its tenant's running total, and the fleet
total — so ``sum over tenants == fleet totals`` holds *exactly* (no
float re-association slack), every submitted request carries exactly one
finalized record, and :meth:`CostLedger.verify_conservation` detects any
lost, double-booked, or unfinalized cost.

Publishing rides the standard latch: an explicit ``registry`` always
publishes the ``serve.tenant.*`` family (per-tenant tokens /
block-seconds / finished-request gauges plus the
``serve.tenant.top_share`` top-consumer gauge); ``registry=None``
follows the ``CMN_OBS`` master switch.  ``CMN_OBS_LEDGER=0`` turns the
whole ledger off (the scheduler then builds none);
``CMN_OBS_LEDGER_TOP_K`` sizes the top-consumers list in snapshots.
Everything is host-side dict arithmetic — never a device sync.

Offline: :meth:`CostLedger.export` writes the ``cmn-usage-1`` schema
that ``python -m chainermn_tpu_torch.observability.usage report <path>``
renders (per-tenant cost table, top consumers, cost of retries,
prefix-cache savings).  The serving router passes ONE ledger into
every replica (revivals and scale-ups included), so a request moved
across replicas keeps one record.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from chainermn_tpu_torch.observability.metrics import _env_float

#: Ledger export schema tag; bump on breaking layout changes.
USAGE_SCHEMA = "cmn-usage-1"

#: The integer cost dimensions every record carries — conservation is
#: checked per dimension over these exact-int fields.  Time-valued
#: dimensions are integers too (``block_us`` = blocks x microseconds of
#: occupancy; ``queue_wait_us`` microseconds): integer addition is
#: associative, so per-tenant sums equal fleet totals bit-exactly no
#: matter the booking interleave.
DIMENSIONS = (
    "prefill_tokens",     # prompt/carried tokens actually computed
    "prefix_hit_tokens",  # tokens served from the prefix cache (saved)
    "tokens",             # generated tokens emitted
    "decode_iterations",  # decode-step participations (spec rounds = 1)
    "spec_proposed",
    "spec_accepted",
    "block_us",           # KV block-microseconds of pool occupancy
    "cow_copies",
    "migration_bytes",    # KV bytes shipped for this request's blocks
    "evictions",          # eviction/harvest requeues (recompute events)
    "retries",            # replica deaths this request was harvested from
    "queue_wait_us",      # arrival -> first admission (or terminal)
)


def ledger_enabled() -> bool:
    """``CMN_OBS_LEDGER`` — master switch for cost attribution
    (default on; ``0`` = the scheduler/router construct no ledger)."""
    return _env_float("CMN_OBS_LEDGER", 1.0) != 0.0


def top_k_from_env() -> int:
    """``CMN_OBS_LEDGER_TOP_K`` — top consumers named in usage
    snapshots / incident bundles (default 5)."""
    return max(1, int(_env_float("CMN_OBS_LEDGER_TOP_K", 5)))


def _us(seconds: float) -> int:
    """Quantize a clock interval to integer microseconds (>= 0)."""
    return max(0, int(round(seconds * 1e6)))


@dataclass
class UsageRecord:
    """One request's attributed cost.  ``status`` is ``None`` while the
    request is in flight and exactly one of ``"ok"`` / ``"poisoned"`` /
    ``"shed"`` / ``"deadline"`` once finalized — the same terminal
    vocabulary as :class:`~chainermn_tpu_torch.serving.scheduler.Completion`.
    """

    id: int
    tenant: str = "default"
    arrival: float = 0.0
    status: Optional[str] = None
    finished_at: Optional[float] = None
    prefill_tokens: int = 0
    prefix_hit_tokens: int = 0
    tokens: int = 0
    decode_iterations: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    block_us: int = 0
    cow_copies: int = 0
    migration_bytes: int = 0
    evictions: int = 0
    retries: int = 0
    queue_wait_us: int = 0

    @property
    def finalized(self) -> bool:
        return self.status is not None

    @property
    def block_seconds(self) -> float:
        return self.block_us / 1e6

    @property
    def queue_wait_s(self) -> float:
        return self.queue_wait_us / 1e6

    def to_dict(self) -> dict:
        d = {"id": self.id, "tenant": self.tenant,
             "arrival": self.arrival, "status": self.status,
             "finished_at": self.finished_at}
        for dim in DIMENSIONS:
            d[dim] = getattr(self, dim)
        return d


def _zero_dims() -> Dict[str, int]:
    return {dim: 0 for dim in DIMENSIONS}


class CostLedger:
    """Fleet-wide cost attribution: one open :class:`UsageRecord` per
    request id, booked from the scheduler's seams, finalized exactly once
    at the request's terminal.

    A standalone Scheduler builds its own; one ledger passed into several
    schedulers keeps ONE record per request id across them (the shape
    the JAX router uses).

    All mutators take ``now`` explicitly (the caller's scheduler-clock
    read) instead of holding a clock: block-second integration then uses
    the same timestamps as every other lifecycle book at that site.
    """

    def __init__(self, registry=None, top_k: Optional[int] = None):
        import weakref

        import chainermn_tpu_torch.observability as _obs
        from chainermn_tpu_torch.observability import flight as _flight
        from chainermn_tpu_torch.observability.metrics import (
            registry as global_registry,
        )

        # The standard publishing latch: explicit registry always
        # publishes; None rides the CMN_OBS master switch.
        if registry is None and not _obs.enabled():
            self._reg = None
        else:
            self._reg = (
                registry if registry is not None else global_registry()
            )
        self.top_k = top_k if top_k is not None else top_k_from_env()
        self._records: Dict[int, UsageRecord] = {}
        #: fleet totals, incremented at every book — the conservation
        #: reference the per-tenant sums are checked against.
        self._totals: Dict[str, int] = _zero_dims()
        #: per-tenant running totals (same increments, same order).
        self._tenants: Dict[str, Dict[str, int]] = {}
        #: finalized-request count per tenant (the requests gauge).
        self._finished: Dict[str, int] = {}
        #: open block-second integration state per request:
        #: (blocks currently held, clock time of the last settle).
        self._open_blocks: Dict[int, Tuple[int, float]] = {}
        #: request ids whose queue wait is already booked (first
        #: admission happens once fleet-wide; ``first_admit`` rides the
        #: migration codec so re-admissions never re-book).
        self._waited: set = set()
        #: double-finalize attempts (conservation evidence — the
        #: terminal invariant says this stays empty).
        self._double_finalized: List[int] = []
        # Keyed flight provider: any crash / preemption / SIGUSR1
        # snapshot names who was hogging at fire time.  Weakref'd like
        # the scheduler's "serving" provider — the registry must never
        # pin a dropped ledger (and through its records, nothing else).
        ref = weakref.ref(self)
        _flight.register_provider(
            "usage",
            lambda: (
                s.usage_state() if (s := ref()) is not None
                else {"released": True}
            ),
        )

    # ------------------------------------------------------------ booking
    def begin(self, req, now: float) -> UsageRecord:
        """Open (or return) the record for ``req`` — idempotent by id,
        so every seam that submits a request can call it without
        double-opening."""
        rec = self._records.get(req.id)
        if rec is None:
            rec = UsageRecord(
                id=req.id,
                tenant=str(getattr(req, "tenant", "default")),
                arrival=float(req.arrival),
            )
            self._records[req.id] = rec
        return rec

    def book(self, rid: int, dim: str, amount: int) -> None:
        """Book ``amount`` of ``dim`` to request ``rid`` — record,
        tenant total, and fleet total move together (the conservation
        discipline).  Unknown ids are dropped whole (never half-booked
        into a total without a record)."""
        if not amount:
            return
        rec = self._records.get(rid)
        if rec is None:
            return
        amount = int(amount)
        setattr(rec, dim, getattr(rec, dim) + amount)
        self._totals[dim] += amount
        t = self._tenants.get(rec.tenant)
        if t is None:
            t = self._tenants[rec.tenant] = _zero_dims()
        t[dim] += amount

    def set_blocks(self, rid: int, blocks: int, now: float) -> None:
        """Piecewise block-second integration: settle the interval since
        the last change at the OLD block count, then hold ``blocks``
        from ``now`` on.  Call at every occupancy edge — admission
        (shared prefix blocks included: pool pressure charges the
        pinner), allocator growth, retirement/eviction/harvest/deadline
        release (``blocks=0``), migration detach and install."""
        state = self._open_blocks.pop(rid, None)
        if state is not None:
            held, since = state
            if held:
                self.book(rid, "block_us", held * _us(now - since))
        if blocks:
            self._open_blocks[rid] = (int(blocks), now)

    def admitted(self, rid: int, now: float) -> None:
        """Book queue wait at the request's FIRST admission fleet-wide
        (call under the scheduler's ``first_admit is None`` guard)."""
        if rid in self._waited:
            return
        rec = self._records.get(rid)
        if rec is None:
            return
        self._waited.add(rid)
        self.book(rid, "queue_wait_us", _us(now - rec.arrival))

    def finalize(self, rid: int, status: str,
                 now: float) -> Optional[UsageRecord]:
        """Close the record exactly once: settle any open block
        occupancy, book terminal queue wait for never-admitted requests
        (shed/poisoned-at-dispatch waited their whole life), stamp the
        status, publish the tenant's gauges.  A second finalize is
        recorded as evidence (``verify_conservation`` fails on it) and
        changes nothing."""
        rec = self._records.get(rid)
        if rec is None:
            return None
        if rec.finalized:
            self._double_finalized.append(rid)
            return rec
        self.set_blocks(rid, 0, now)
        if rid not in self._waited:
            self._waited.add(rid)
            self.book(rid, "queue_wait_us", _us(now - rec.arrival))
        rec.status = str(status)
        rec.finished_at = now
        self._finished[rec.tenant] = self._finished.get(rec.tenant, 0) + 1
        self._publish(rec.tenant)
        return rec

    # --------------------------------------------------------- publishing
    def _publish(self, tenant: str) -> None:
        if self._reg is None:
            return
        t = self._tenants.get(tenant) or _zero_dims()
        self._reg.gauge(f"serve.tenant.{tenant}.tokens").set(t["tokens"])
        self._reg.gauge(f"serve.tenant.{tenant}.block_seconds").set(
            t["block_us"] / 1e6
        )
        self._reg.gauge(f"serve.tenant.{tenant}.requests").set(
            self._finished.get(tenant, 0)
        )
        total = self._totals["block_us"]
        if total > 0:
            top = max(
                self._tenants.values(),
                key=lambda d: d["block_us"],
            )["block_us"]
            self._reg.gauge("serve.tenant.top_share").set(top / total)

    # ------------------------------------------------------ introspection
    @property
    def totals(self) -> Dict[str, int]:
        return dict(self._totals)

    def record(self, rid: int) -> Optional[UsageRecord]:
        return self._records.get(rid)

    @property
    def records(self) -> List[UsageRecord]:
        return list(self._records.values())

    def aggregate(self) -> Dict[str, dict]:
        """Per-tenant aggregation recomputed FROM THE RECORDS (not the
        running totals — so ``verify_conservation`` can cross-check the
        two accumulations against each other)."""
        out: Dict[str, dict] = {}
        for rec in self._records.values():
            t = out.get(rec.tenant)
            if t is None:
                t = out[rec.tenant] = {
                    **_zero_dims(), "requests": 0,
                    "by_status": {},
                }
            t["requests"] += 1
            if rec.status is not None:
                t["by_status"][rec.status] = (
                    t["by_status"].get(rec.status, 0) + 1
                )
            for dim in DIMENSIONS:
                t[dim] += getattr(rec, dim)
        return out

    def top(self, k: Optional[int] = None) -> List[dict]:
        """Top consumers by block-seconds (the quota-relevant scarce
        resource), heaviest first."""
        k = k if k is not None else self.top_k
        agg = self.aggregate()
        ranked = sorted(
            agg.items(), key=lambda kv: (-kv[1]["block_us"], kv[0])
        )
        return [
            {
                "tenant": t,
                "block_seconds": round(d["block_us"] / 1e6, 6),
                "tokens": d["tokens"],
                "requests": d["requests"],
            }
            for t, d in ranked[:k]
        ]

    def verify_conservation(
        self, requests: Optional[Sequence] = None
    ) -> dict:
        """The conservation oracle: per-dimension, the sum over every
        record equals the fleet totals AND the per-tenant running
        totals, exactly (integers — zero slack); every record is
        finalized exactly once; no block-second integration is left
        open.  With ``requests`` given, also checks that every
        submitted request has exactly one record (none lost, none
        invented).  ``report["holds"]`` is the verdict."""
        agg = self.aggregate()
        mismatched: Dict[str, dict] = {}
        for dim in DIMENSIONS:
            rec_sum = sum(t[dim] for t in agg.values())
            run_sum = sum(
                t[dim] for t in self._tenants.values()
            )
            if not (rec_sum == run_sum == self._totals[dim]):
                mismatched[dim] = {
                    "records": rec_sum, "tenant_running": run_sum,
                    "fleet_total": self._totals[dim],
                }
        unfinalized = sorted(
            r.id for r in self._records.values() if not r.finalized
        )
        open_blocks = sorted(self._open_blocks)
        report = {
            "requests": len(self._records),
            "tenants": len(agg),
            "mismatched_dimensions": mismatched,
            "unfinalized": unfinalized,
            "double_finalized": sorted(set(self._double_finalized)),
            "open_block_integrations": open_blocks,
        }
        if requests is not None:
            want = {r.id for r in requests}
            have = set(self._records)
            report["lost"] = sorted(want - have)
            report["unknown"] = sorted(have - want)
        report["holds"] = (
            not mismatched and not unfinalized
            and not self._double_finalized and not open_blocks
            and not report.get("lost") and not report.get("unknown")
        )
        return report

    def usage_state(self) -> dict:
        """Compact live snapshot — the keyed ``"usage"`` flight-record
        provider and incident-bundle source (who is hogging right
        now)."""
        top = self.top()
        return {
            "schema": USAGE_SCHEMA,
            "requests": len(self._records),
            "finalized": sum(
                1 for r in self._records.values() if r.finalized
            ),
            "tenants": len(self._tenants) or len(
                {r.tenant for r in self._records.values()}
            ),
            "tokens": self._totals["tokens"],
            "block_seconds": round(self._totals["block_us"] / 1e6, 6),
            "top": top,
            "top_tenant": top[0]["tenant"] if top else None,
        }

    # ------------------------------------------------------------- export
    def export(self) -> dict:
        """The full ``cmn-usage-1`` artifact the offline analyzer
        (``python -m chainermn_tpu_torch.observability.usage report``)
        renders."""
        return {
            "schema": USAGE_SCHEMA,
            "totals": self.totals,
            "tenants": self.aggregate(),
            "top": self.top(),
            "records": [
                r.to_dict() for r in sorted(
                    self._records.values(), key=lambda r: r.id
                )
            ],
            "conservation": self.verify_conservation(),
        }

    def dump(self, path: str) -> str:
        """Write :meth:`export` as JSON; returns ``path``."""
        import json

        with open(path, "w") as fh:
            json.dump(self.export(), fh, indent=1, sort_keys=True)
            fh.write("\n")
        return path

    def replay(self, ops: Sequence[tuple]) -> None:
        """Apply a :class:`LedgerTape`'s recorded bookings, in order."""
        for name, args in ops:
            getattr(self, name)(*args)


# ------------------------------------------------------------ LedgerTape
class _Req(NamedTuple):
    """What :meth:`CostLedger.begin` reads of a request."""

    id: int
    tenant: str
    arrival: float


#: the bookings a scheduler makes on its ledger, each with the converter
#: of its arguments into what the ledger reads of them (picklable).
_TAPED = {
    "begin": lambda req, now: (
        _Req(req.id, str(getattr(req, "tenant", "default")),
             float(req.arrival)), now),
    "book": None, "set_blocks": None, "admitted": None, "finalize": None,
}


class LedgerTape:
    """The ledger a replica's scheduler holds in a tensor-parallel fleet.

    Between :meth:`start` and :meth:`stop` (one replica tick, or one
    step of a drain) every booking is recorded, its arguments reduced to
    what the ledger reads, and NOT applied: :meth:`stop` returns the
    record, which every rank of the fleet replays on its own
    :class:`CostLedger` in replica order (:meth:`CostLedger.replay`), so
    the ledgers stay equal.  A recorded ``finalize`` returns None; the
    router sets each completion's ``usage`` after the replay.  Outside a
    recording, calls go to ``ledger`` itself."""

    def __init__(self, ledger: CostLedger):
        self.ledger = ledger
        self._ops: Optional[list] = None

    def start(self) -> None:
        self._ops = []

    def stop(self) -> list:
        ops, self._ops = self._ops or [], None
        return ops

    def __getattr__(self, name):
        attr = getattr(self.ledger, name)
        if self._ops is None or name not in _TAPED:
            return attr
        light = _TAPED[name]

        def call(*args):
            self._ops.append((name, light(*args) if light else args))
            return None

        return call
