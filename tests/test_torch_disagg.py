"""The port's disaggregated prefill/decode serving against the JAX
package's (``tests/serving_tests/test_disagg.py``), on the serving test
geometry over the in-process ``LocalComm``.

Held against the JAX run, exactly: the migration codec's slot records
and the moved block ids, the installer's table rewrite under a
colliding destination allocator, shared blocks migrating once without a
double free, destination trie hits, the role-split run with prefix
sharing and a draft (the decode role's one capture, zero mixed
iterations), dropped and torn frames counted, the drains (the deferred
backlog forwarded, an eof to every decode rank, the direct
``drain_all`` that the JAX package reaches through its preemption
guard), role-aware dispatch and the env knobs.  Tokens by the greedy
divergence structure; the KV values the two frameworks computed within
fp32 rounding (rtol 1e-4, atol 1e-5: sums in another order).

On the port alone: a migrated block re-reads byte for byte.
"""

import pickle

import numpy as np
import pytest

from torch_fleet_common import (
    FixedClock,
    assert_same,
    build_models,
    jax_pkg,
    make_prompts,
    port_pkg,
    tokens_of,
)
from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1

PAIR = dict(capacity=3, num_blocks=48, prefill_chunk=16)
KV_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pkgs():
    models = build_models()
    return jax_pkg(models), port_pkg(models)


@pytest.fixture(scope="module")
def prompts():
    return make_prompts()


def both(pkgs, scenario, *args, **kw):
    return tuple(scenario(p, *args, **kw) for p in pkgs)


def _pair(pkg, n=2, **eng_kw):
    """A prefill role and decode role(s) over one LocalComm and clock."""
    kw = {**PAIR, **eng_kw}
    comm, clock = pkg.LocalComm(n), FixedClock()
    regs = [pkg.MetricsRegistry() for _ in range(n)]
    trs = [pkg.MigrationTransport(comm.endpoint(i), registry=regs[i])
           for i in range(n)]
    pr = pkg.PrefillRole(
        pkg.Scheduler(pkg.engine(**kw), registry=regs[0], clock=clock),
        trs[0], decode_ranks=list(range(1, n)))
    drs = [pkg.DecodeRole(
        pkg.Scheduler(pkg.engine(**kw), registry=regs[i], clock=clock),
        trs[i], prefill_ranks=[0]) for i in range(1, n)]
    return pr, drs, regs, comm


def _prefill_until_ready(sched):
    for _ in range(64):
        while sched._try_admit():
            pass
        sched._prefill_round()
        live = [s for s in sched._slots if s is not None]
        if live and all(not s.prefilling for s in live):
            return live
    raise AssertionError("prefill never finished")


def _block_bytes(engine, block):
    data = engine.read_block(block)
    out = b""
    for pool in ("target", "draft"):
        if data[pool] is None:
            continue
        for layer in data[pool]:
            for name in sorted(layer):
                out += layer[name].tobytes()
    return out


def _kv(engine, blocks):
    return {b: [a for layer in engine.read_block(b)["target"]
                for _, a in sorted(layer.items())] for b in blocks}


def _records(body):
    return [{k: v for k, v in rec.items()} for rec in body["slots"]]


def codec_scenario(pkg, prompts):
    pr, (dr,), (regp, regd), _ = _pair(pkg)
    src, dst = pr.sched, dr.sched
    for i in range(2):
        src.submit(pkg.Request(id=i, prompt=prompts[i], max_new_tokens=8,
                               tenant="acme"))
    slots = _prefill_until_ready(src)
    body = pkg.disagg.pack_slots(src, slots)
    want = {s.entry.req.id: [_block_bytes(src.engine, b) for b in s.blocks]
            for s in slots}
    kv = _kv(src.engine, sorted(body["blocks"]))
    n = pkg.disagg.migrate_slots(src, pr.transport, 1, slots)
    frame = dr.transport.recv(0)
    installed = pkg.disagg.install_payload(dst, frame["body"])
    live = [s for s in dst._slots if s is not None]
    return {
        "records": _records(body), "blocks": sorted(body["blocks"]),
        "frame": (frame["schema"], frame["seq"], frame["kind"]),
        "migrated": n, "installed": installed[:2],
        "rest": installed[2],
        "dst_tables": {s.entry.req.id: list(s.blocks) for s in live},
        "dst_pos": {s.entry.req.id: (s.pos, len(s.text), s.prefilling)
                    for s in live},
        "counters": {k: pkg.counter(regp, "serve.migration." + k)
                     for k in ("slots_migrated", "blocks_moved", "bytes",
                               "failed")},
        "migrate_ms": pkg.hcount(regp, "serve.migration.migrate_ms"),
        "_kv": kv,
        "_identity": all(
            [_block_bytes(dst.engine, b) for b in s.blocks]
            == want[s.entry.req.id] for s in live),
    }


def test_codec_records_match_jax_and_bytes_survive(pkgs, prompts):
    ref, got = both(pkgs, codec_scenario, prompts)
    assert_same({k: v for k, v in got.items() if not k.startswith("_")},
                {k: v for k, v in ref.items() if not k.startswith("_")})
    assert got["installed"] == (2, 0) and got["rest"] is None
    assert got["counters"]["bytes"] > 0 and got["migrate_ms"] == 1
    # The KV itself: each framework computed it, fp32 rounding apart.
    assert set(got["_kv"]) == set(ref["_kv"])
    for b, arrays in got["_kv"].items():
        for a, w in zip(arrays, ref["_kv"][b]):
            np.testing.assert_allclose(a, w, **KV_TOL)
    # Within the port: every installed block re-reads byte for byte.
    assert got["_identity"]


def colliding_scenario(pkg, prompts):
    pr, (dr,), _, _ = _pair(pkg)
    src, dst = pr.sched, dr.sched
    src.submit(pkg.Request(id=0, prompt=prompts[4], max_new_tokens=8))
    slots = _prefill_until_ready(src)
    src_ids = list(slots[0].blocks)
    held = dst.engine.alloc_blocks(max(src_ids) + 1)
    sent = dst.engine.read_block(src_ids[0])
    dst.engine.write_block(src_ids[0], {
        "target": [{n: np.full_like(a, 3) for n, a in layer.items()}
                   for layer in sent["target"]], "draft": None})
    before = _block_bytes(dst.engine, src_ids[0])
    want = [_block_bytes(src.engine, b) for b in src_ids]
    pkg.disagg.migrate_slots(src, pr.transport, 1, slots)
    install = pkg.disagg.install_payload(dst, dr.transport.recv(0)["body"])
    slot = next(s for s in dst._slots if s is not None)
    return {"held": held, "src_ids": src_ids, "installed": install[0],
            "dst_table": list(slot.blocks),
            "fresh": all(b not in held for b in slot.blocks),
            "_identity": [_block_bytes(dst.engine, b)
                          for b in slot.blocks] == want,
            "_sentinel": _block_bytes(dst.engine, src_ids[0]) == before}


def test_table_rewrite_under_colliding_allocator_matches_jax(pkgs,
                                                             prompts):
    ref, got = both(pkgs, colliding_scenario, prompts)
    assert_same({k: v for k, v in got.items() if not k.startswith("_")},
                {k: v for k, v in ref.items() if not k.startswith("_")})
    assert got["installed"] == 1 and got["fresh"]
    assert got["_identity"] and got["_sentinel"]


def shared_scenario(pkg):
    rng = np.random.RandomState(7)
    base = rng.randint(1, 257, size=16).tolist()
    p1 = base + rng.randint(1, 257, size=3).tolist()
    p2 = base + rng.randint(1, 257, size=4).tolist()
    pr, (dr,), _, _ = _pair(pkg)
    src, dst = pr.sched, dr.sched
    src.run([pkg.Request(id=100, prompt=base + [5], max_new_tokens=1)])
    src.submit(pkg.Request(id=0, prompt=p1, max_new_tokens=8))
    src.submit(pkg.Request(id=1, prompt=p2, max_new_tokens=8))
    slots = _prefill_until_ready(src)
    shared = sorted(set(slots[0].blocks) & set(slots[1].blocks))
    body = pkg.disagg.pack_slots(src, slots)
    pkg.disagg.migrate_slots(src, pr.transport, 1, slots)
    pkg.disagg.install_payload(dst, dr.transport.recv(0)["body"])
    dslots = [s for s in dst._slots if s is not None]
    dshared = sorted(set(dslots[0].blocks) & set(dslots[1].blocks))
    refs = [dst.engine.pool.allocator.refcount(b) for b in dshared]
    comps = dst.run([])
    dst.engine.drop_prefix_cache()
    return {"shared": shared, "wire_blocks": len(body["blocks"]),
            "refs_total": sum(len(s.blocks) for s in slots),
            "dshared": dshared, "refcounts": refs,
            "completions": sorted(c.id for c in comps),
            "free_after_gc": dst.engine.free_blocks(),
            "tokens": tokens_of(comps)}


def test_shared_blocks_migrate_once_matches_jax(pkgs):
    ref, got = both(pkgs, shared_scenario)
    assert_same(got, ref)
    assert got["shared"] and got["wire_blocks"] < got["refs_total"]
    assert len(got["dshared"]) == len(got["shared"])
    assert min(got["refcounts"]) >= 2
    assert got["free_after_gc"] == PAIR["num_blocks"] - 1


def trie_scenario(pkg, prompts):
    pr, (dr,), _, _ = _pair(pkg)
    src, dst = pr.sched, dr.sched
    src.submit(pkg.Request(id=0, prompt=prompts[4], max_new_tokens=4))
    slots = _prefill_until_ready(src)
    pkg.disagg.migrate_slots(src, pr.transport, 1, slots)
    pkg.disagg.install_payload(dst, dr.transport.recv(0)["body"])
    blocks, matched = dst.engine.prefix.match(prompts[4])
    comps = dst.run([pkg.Request(id=1, prompt=prompts[4],
                                 max_new_tokens=4)])
    return {"matched": matched, "blocks": list(blocks),
            "hits": {c.id: c.prefix_hit_tokens for c in comps},
            "tokens": tokens_of(comps)}


def test_destination_trie_hits_match_jax(pkgs, prompts):
    ref, got = both(pkgs, trie_scenario, prompts)
    assert_same(got, ref)
    assert got["matched"] >= 16 and got["hits"][1] > 0


def role_split_scenario(pkg):
    pr, (dr,), (regp, regd), _ = _pair(pkg, draft=True, spec_k=2,
                                        num_blocks=64)
    rng = np.random.RandomState(2)
    base = rng.randint(1, 257, size=12).tolist()
    ps = [base + rng.randint(1, 257, size=3).tolist() for _ in range(4)]
    ps += [rng.randint(1, 257, size=9).tolist() for _ in range(3)]
    comps = pkg.serve_disaggregated(pr, dr, [
        pkg.Request(id=i, prompt=p, max_new_tokens=7)
        for i, p in enumerate(ps)])
    de, pe = dr.sched.engine, pr.sched.engine
    return {
        "ids": sorted(c.id for c in comps),
        "decode_compiles": de.decode_compiles,
        "put_compiles": de.put_compiles,
        "gather_compiles": pe.gather_compiles,
        "mixed": pkg.hcount(regd, "serve.mixed_ms"),
        "clean_decode": pkg.hcount(regd, "serve.decode_ms") > 0,
        "prefill_role_decodes": pkg.hcount(regp, "serve.decode_ms"),
        "migrated": pkg.counter(regp, "serve.migration.slots_migrated"),
        "prefix_hits": pkg.counter(regp, "serve.prefix.hit_tokens") > 0,
        "tokens": tokens_of(comps),
    }


def test_role_split_with_sharing_and_draft_matches_jax(pkgs):
    ref, got = both(pkgs, role_split_scenario)
    assert_same(got, ref)
    assert got["decode_compiles"] == 1 == got["put_compiles"]
    assert got["mixed"] == 0 == got["prefill_role_decodes"]
    assert got["migrated"] == 7 and got["prefix_hits"]


def defer_scenario(pkg):
    pr, (dr,), (_, reg), _ = _pair(pkg, capacity=2, num_blocks=64)
    rng = np.random.RandomState(3)
    ps = [rng.randint(1, 257, size=int(n)).tolist()
          for n in rng.randint(4, 18, size=7)]
    comps = pkg.serve_disaggregated(pr, dr, [
        pkg.Request(id=i, prompt=p, max_new_tokens=9)
        for i, p in enumerate(ps)])
    return {"ids": sorted(c.id for c in comps),
            "prefills": pkg.hcount(reg, "serve.prefill_ms"),
            "mixed": pkg.hcount(reg, "serve.mixed_ms"),
            "decode_compiles": dr.sched.engine.decode_compiles,
            "tokens": tokens_of(comps)}


def test_decode_role_defers_never_prefills_matches_jax(pkgs):
    ref, got = both(pkgs, defer_scenario)
    assert_same(got, ref)
    assert got["prefills"] == 0 == got["mixed"]
    assert got["decode_compiles"] == 1 and got["ids"] == list(range(7))


def dropped_scenario(pkg, prompts):
    comm = pkg.LocalComm(2)
    reg0, reg1 = pkg.MetricsRegistry(), pkg.MetricsRegistry()
    t0 = pkg.MigrationTransport(comm.endpoint(0), registry=reg0,
                                injector=pkg.inj("drop@migrate:1"))
    t1 = pkg.MigrationTransport(comm.endpoint(1), registry=reg1)
    src = pkg.Scheduler(pkg.engine(**PAIR), registry=reg0,
                        clock=FixedClock())
    for i in range(2):
        src.submit(pkg.Request(id=i, prompt=prompts[i], max_new_tokens=4))
    slots = _prefill_until_ready(src)
    pkg.disagg.migrate_slots(src, t0, 1, slots[:1])
    pkg.disagg.migrate_slots(src, t0, 1, slots[1:])
    try:
        t1.recv(0)
        err = None
    except pkg.MigrationError as e:
        err = ("dropped" in str(e), e.frame is not None)
    failed = pkg.counter(reg1, "serve.migration.failed")
    src.submit(pkg.Request(id=2, prompt=prompts[2], max_new_tokens=4))
    pkg.disagg.migrate_slots(src, t0, 1, _prefill_until_ready(src))
    return {"error": err, "failed": failed, "next": t1.recv(0)["kind"]}


def test_dropped_frame_detected_matches_jax(pkgs, prompts):
    ref, got = both(pkgs, dropped_scenario, prompts)
    assert_same(got, ref)
    assert got == {"error": (True, True), "failed": 1, "next": "slots"}


def survive_drop_scenario(pkg, prompts):
    comm, clock = pkg.LocalComm(2), FixedClock()
    reg0, reg1 = pkg.MetricsRegistry(), pkg.MetricsRegistry()
    pr = pkg.PrefillRole(
        pkg.Scheduler(pkg.engine(**PAIR), registry=reg0, clock=clock),
        pkg.MigrationTransport(comm.endpoint(0), registry=reg0,
                               injector=pkg.inj("drop@migrate:1")),
        decode_ranks=[1])
    dr = pkg.DecodeRole(
        pkg.Scheduler(pkg.engine(**PAIR), registry=reg1, clock=clock),
        pkg.MigrationTransport(comm.endpoint(1), registry=reg1),
        prefill_ranks=[0])
    pr.submit(pkg.Request(id=0, prompt=prompts[0], max_new_tokens=4))
    while not pr.sched.completions and any(
            s is not None for s in pr.sched._slots) or pr.sched._queue:
        if not pr.tick():
            break
    pr.submit(pkg.Request(id=1, prompt=prompts[1], max_new_tokens=4))
    comps = pkg.serve_disaggregated(pr, dr, [])
    return {"ids": [c.id for c in comps],
            "failed": pkg.counter(reg1, "serve.migration.failed"),
            "tokens": tokens_of(comps)}


def test_decode_role_survives_dropped_frame_matches_jax(pkgs, prompts,
                                                        capsys):
    ref, got = both(pkgs, survive_drop_scenario, prompts)
    assert_same(got, ref)
    assert got["ids"] == [1] and got["failed"] == 1


def torn_scenario(pkg, prompts):
    comm = pkg.LocalComm(2)
    reg1 = pkg.MetricsRegistry()
    t0 = pkg.MigrationTransport(comm.endpoint(0))
    t1 = pkg.MigrationTransport(comm.endpoint(1), registry=reg1)
    src = pkg.Scheduler(pkg.engine(**PAIR), clock=FixedClock())
    src.submit(pkg.Request(id=0, prompt=prompts[0], max_new_tokens=4))
    slots = _prefill_until_ready(src)
    t0.send(pkg.disagg.pack_slots(src, slots), 1)
    q = comm.queues[(0, 1)]
    frame = pickle.loads(q.popleft())
    arr = frame["body"]["blocks"][slots[0].blocks[0]]["target"][0]["k"]
    arr.reshape(-1).view(np.uint8)[0] ^= 0xFF
    q.append(pickle.dumps(frame))
    try:
        t1.recv(0)
        err = None
    except pkg.MigrationError as e:
        err = "checksum" in str(e)
    return {"error": err,
            "failed": pkg.counter(reg1, "serve.migration.failed")}


def test_torn_frame_detected_matches_jax(pkgs, prompts):
    ref, got = both(pkgs, torn_scenario, prompts)
    assert_same(got, ref)
    assert got == {"error": True, "failed": 1}


def deferred_drain_scenario(pkg, prompts):
    """A decode rank's drain forwards its deferred backlog to the peer
    that polls it through ``peer_ranks``."""
    roles = ["prefill", "decode", "decode"]
    comm, clock = pkg.LocalComm(3), FixedClock()
    regs = [pkg.MetricsRegistry() for _ in range(3)]
    tr = [pkg.MigrationTransport(comm.endpoint(i), registry=regs[i])
          for i in range(3)]
    pr = pkg.PrefillRole(pkg.Scheduler(pkg.engine(**PAIR), registry=regs[0],
                                       clock=clock), tr[0], decode_ranks=[1])
    d1 = pkg.DecodeRole(
        pkg.Scheduler(pkg.engine(**{**PAIR, "capacity": 1}),
                      registry=regs[1], clock=clock),
        tr[1], prefill_ranks=[0], peer_ranks=[2])
    d2 = pkg.DecodeRole(
        pkg.Scheduler(pkg.engine(**PAIR), registry=regs[2], clock=clock),
        tr[2], prefill_ranks=[], peer_ranks=[1])
    for i in range(3):
        pr.submit(pkg.Request(id=i, prompt=prompts[i], max_new_tokens=6))
    while pr.pending:
        pr.tick()
    pr.finish()
    d1.tick()
    deferred = len(d1._deferred)
    summary = d1.drain(2)
    comps = d2.run_loop(poll_ms=0)
    done = list(pr.sched.completions) + list(d1.sched.completions) + comps
    return {"peer": pkg.disagg.drain_peer_from_env(1, 3, roles),
            "deferred": deferred, "summary": summary,
            "ids": sorted(c.id for c in done),
            "left": (len(d1._deferred), d1.sched.pending),
            "tokens": tokens_of(done)}


def test_decode_role_drain_forwards_deferred_matches_jax(pkgs, prompts):
    ref, got = both(pkgs, deferred_drain_scenario, prompts)
    got["summary"].pop("bytes"), ref["summary"].pop("bytes")
    assert_same(got, ref)
    assert got["peer"] == 2 and got["deferred"] >= 1
    assert got["summary"]["deferred_forwarded"] >= 2
    assert got["ids"] == [0, 1, 2] and got["left"] == (0, False)


def prefill_drain_scenario(pkg, prompts):
    """A prefill rank feeding two decode ranks drains to one and sends
    the eof to both; every request still completes."""
    pr, roles, _, _ = _pair(pkg, n=3)
    for i in range(4):
        pr.submit(pkg.Request(id=i, prompt=prompts[i], max_new_tokens=5))
    ticks = 0
    while pr.pending:
        ticks += 1
        pr.tick()
        if ticks >= 3:
            break
        for r in roles:
            r.tick()
    summary = pr.drain(1)
    done = []
    for r in roles:
        done.extend(r.run_loop(poll_ms=0))
    done += list(pr.sched.completions)
    return {"summary": {k: v for k, v in summary.items() if k != "bytes"},
            "ids": sorted(c.id for c in done),
            "served": [len(r.sched.completions) for r in roles],
            "tokens": tokens_of(done)}


def test_prefill_drain_eofs_every_decode_rank_matches_jax(pkgs, prompts):
    ref, got = both(pkgs, prefill_drain_scenario, prompts)
    assert_same(got, ref)
    assert got["ids"] == [0, 1, 2, 3] and all(s > 0 for s in got["served"])


def drain_all_scenario(pkg):
    """The JAX package reaches ``drain_all`` through its preemption guard
    (``PreemptionGuard.attach_drain``); here it is called directly at the
    same tick."""
    comm, clock = pkg.LocalComm(2), FixedClock()
    reg0, reg1 = pkg.MetricsRegistry(), pkg.MetricsRegistry()
    t0 = pkg.MigrationTransport(comm.endpoint(0), registry=reg0)
    src_e = pkg.engine(**PAIR)
    src = pkg.Scheduler(src_e, registry=reg0, clock=clock)
    peer = pkg.DecodeRole(
        pkg.Scheduler(pkg.engine(**PAIR), registry=reg1, clock=clock),
        pkg.MigrationTransport(comm.endpoint(1), registry=reg1),
        prefill_ranks=[0])
    rng = np.random.RandomState(1)
    ps = [rng.randint(1, 257, size=int(n)).tolist()
          for n in (5, 12, 9, 3, 17, 12, 7)]
    for i, p in enumerate(ps):
        src.submit(pkg.Request(id=i, prompt=p, max_new_tokens=8))
    for _ in range(4):
        src.tick()
    summary = pkg.drain_all(src, t0, dest=1)
    comps = peer.run_loop(poll_ms=0)
    merged = list(src.completions) + list(comps)
    src_e.drop_prefix_cache()
    return {"summary": {k: v for k, v in summary.items() if k != "bytes"},
            "migrated": pkg.counter(reg0, "serve.migration.slots_migrated"),
            "ids": sorted(c.id for c in merged),
            "src_free": src_e.free_blocks(), "src_pending": src.pending,
            "tokens": tokens_of(merged)}


def test_drain_all_zero_loss_matches_jax(pkgs):
    ref, got = both(pkgs, drain_all_scenario)
    assert_same(got, ref)
    assert got["migrated"] > 0 and got["ids"] == list(range(7))
    assert got["src_free"] == PAIR["num_blocks"] - 1
    assert not got["src_pending"]


def role_dispatch_scenario(pkg, prompts):
    router = pkg.Router([pkg.engine(), pkg.engine()],
                        roles=["mixed", "decode"], max_queue=8,
                        registry=pkg.MetricsRegistry(), clock=FixedClock())
    comps = router.run([pkg.Request(id=i, prompt=prompts[i % 5],
                                    max_new_tokens=3) for i in range(5)])
    stats = router.replica_stats()
    return {"assignments": dict(router.assignments),
            "roles": [s["role"] for s in stats],
            "completions": [s["completions"] for s in stats],
            "tokens": tokens_of(comps)}


def test_router_dispatches_by_role_matches_jax(pkgs, prompts):
    ref, got = both(pkgs, role_dispatch_scenario, prompts)
    assert_same(got, ref)
    assert all(reps == [0] for reps in got["assignments"].values())
    assert got["completions"] == [5, 0]


@pytest.mark.parametrize("roles_env,drain_env", [
    (None, None), ("prefill,decode", None), ("prefill,decode,decode", "0"),
])
def test_roles_and_drain_peer_env_match_jax(pkgs, monkeypatch, roles_env,
                                            drain_env):
    for k, v in (("CMN_DISAGG_ROLES", roles_env),
                 ("CMN_DISAGG_DRAIN_PEER", drain_env)):
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)

    def probe(pkg):
        out = [pkg.disagg.roles_from_env(4)]
        for rank, size, roles in ((1, 2, None), (2, 3, None),
                                  (2, 3, ["prefill", "decode", "decode"])):
            try:
                out.append(pkg.disagg.drain_peer_from_env(rank, size, roles))
            except ValueError:
                out.append("ValueError")
        return out

    jp, tp = pkgs
    assert probe(tp) == probe(jp)


def test_migration_failed_rule_fires_on_port_counter(pkgs, tmp_path):
    _, tp = pkgs
    rules = [r for r in tp.incident.default_rules()
             if r.name == "migration_failed"]
    assert rules and rules[0].severity == "critical"
    reg = tp.MetricsRegistry()
    mgr = tp.incident.IncidentManager(registry=reg, rules=rules,
                                      directory=str(tmp_path),
                                      cooldown_s=0.0)
    assert mgr.evaluate() == []
    reg.counter("serve.migration.failed").inc()
    fired = mgr.evaluate()
    assert len(fired) == 1 and fired[0]["rule"]["name"] == "migration_failed"
