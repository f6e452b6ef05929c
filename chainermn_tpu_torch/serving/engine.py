"""Fixed-shape continuous-batching decode engine over the paged KV pool.

The serving loop is one decode step whose shapes never change:
``capacity`` slots × 1 token, every iteration.  Slot churn (requests
finishing, new prompts admitted) changes only the contents of the step's
inputs (block tables, positions, live mask), never their shapes or
dtypes.  Idle slots ride along masked: their cache writes land in the
reserved parking block 0 and their sampled tokens are discarded.

One step = the model's paged decode branch, which under
``decode_attention="fused"`` runs the hand-written paged kernel
(:func:`~chainermn_tpu_torch.ops.paged_decode_attention`) once per layer,
then per-slot sampling.

**Speculative decoding** (``draft_model``/``spec_k``): the hot loop
becomes one *round*: ``k`` sequential draft proposals per slot (plus one
backfill step for the last proposal's K/V), then one target verify
forward over all ``k + 1`` positions (the paged kernel's multi-query
mode), greedy prefix acceptance per slot.  Greedy output is exactly the
target's own generation; sampling slots accept zero drafts and sample
the verify step's position-0 logits.  The draft owns its own pools but
shares the target's block tables and allocator, so admission, prefix
sharing, eviction and rollback stay one accounting decision.

**Prefix sharing** (``prefix_cache=True``): the engine owns a
:class:`~chainermn_tpu_torch.serving.prefix_cache.PrefixCache` over its
allocator; the scheduler maps cached prompt blocks at admission and
copies shared partial blocks through :meth:`DecodeEngine.cow_copy`.

Prefill runs one slot's chunk per call, in sizes drawn from a small fixed
**ladder** (``prefill_chunk`` and its halves down to 8).

**Captured once, replayed** (the JAX engine's compile-once contract): on
a CUDA device each hot program is captured as a CUDA graph the first
time it is called with a signature, after two warm-up runs on a side
stream that build the kernel library, cuBLAS's workspaces and the
allocator's blocks, and replayed after that:

* the decode step (:meth:`DecodeEngine.step`): the model's forward and
  the greedy ``argmax``, one graph per control-vector signature;
* prefill (:meth:`DecodeEngine.prefill`): one graph per ladder geometry
  and block-table width.  It runs the target's forward over the chunk
  (and the draft's, on a speculative engine) from a 0-d device start
  position, takes the hidden row at the device index ``last_idx`` and
  applies the fp32 LM head to that row only, as the JAX ``prefill_impl``
  does.  A prefix-cache hit that starts mid-block changes only the
  buffer's contents, never the signature;
* the speculative round (:meth:`DecodeEngine.spec_step`): the ``k + 1``
  draft steps, the ``(k + 1)``-position verify forward (the paged
  kernel's multi-query mode), the argmax and the ``cumprod`` acceptance.

Every call copies its control vectors into the graph's static device
buffer (one host-to-device copy from pinned memory) and replays;
temperature sampling (and, in a round, the zeroing of sampled slots'
accepted counts) runs outside the graphs, from their static outputs.  The
KV pools exist before any capture and the graphs write them in place, so
their addresses never change; the copy-on-write copy and the KV block
reads and writes run eagerly on the same stream between replays.  A
capture that fails raises: no program quietly runs eagerly on a card.
On the CPU the same function bodies run eagerly.

Every program registers with the process capture watch
(:mod:`chainermn_tpu_torch.observability.device`) under the JAX engine's
budgets: ``decode_step`` and ``spec_round`` 1, ``prefill``
``len(prefill_ladder)``, ``cow``/``kv_gather``/``kv_put`` 1.  The
``*_compiles`` properties read it: captures on a card, distinct input
signatures on the CPU and of the programs that always run eagerly.  A
second signature records a blame diff naming the changed argument and
axis.  ``decode_replays``, ``prefill_replays`` and ``spec_replays`` count
replays.  A replay runs the decode-attention kernels without their
wrappers, so their ``launches`` counters do not move; the kernels count
their own runs on the card (``ops.decode_attention.kernel_runs``).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from chainermn_tpu_torch.observability import device as _odevice
from chainermn_tpu_torch.ops import decode_attention as _da
from chainermn_tpu_torch.ops.decode_attention import MAX_VERIFY_T
from chainermn_tpu_torch.serving.kv_pool import PagedKVPool
from chainermn_tpu_torch.serving.prefix_cache import PrefixCache
from chainermn_tpu_torch.utils.device import resolve_device

_MASK64 = (1 << 64) - 1


def lane_seed(seed: int, position: int) -> int:
    """The sampling generator's seed for one token: a splitmix64 mix of
    the request's seed and the absolute position of the token it
    conditions on."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(position) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _key_of(v):
    """The cheap per-call signature key of one argument."""
    if isinstance(v, np.ndarray):
        return v.shape, v.dtype.str
    if isinstance(v, (bool, int, float)):
        return type(v).__name__
    return v


#: eager runs of the decode step on a side stream before its capture.
CAPTURE_WARMUP = 2

#: the wrappers whose launches a captured decode step replays.
_COUNTED = (_da.paged_decode_attention, _da.fused_decode_attention)

#: one warm-up side stream per device, shared by every engine: cuBLAS
#: keeps a workspace per (handle, stream) for the life of the process, so
#: a fresh stream per engine would leave one workspace behind per engine
#: that ever captured (a fleet builds and drops engines).
_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _side_stream(dev) -> "torch.cuda.Stream":
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _SIDE_STREAMS:
        _SIDE_STREAMS[key] = torch.cuda.Stream(dev)
    return _SIDE_STREAMS[key]


def _capture(dev, body):
    """``body()`` warmed up ``CAPTURE_WARMUP`` times on the shared side
    stream, then captured once: ``(graph, its static outputs, the kernel
    launches the capture recorded per counted wrapper)``.  Each replay
    runs those launches again, and the kernels count the runs on the card
    (``ops.decode_attention.kernel_runs``)."""
    side = _side_stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(CAPTURE_WARMUP):
            body()
    torch.cuda.current_stream(dev).wait_stream(side)
    before = [w.captured for w in _COUNTED]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = body()
    return graph, out, {w.__name__: w.captured - b
                        for w, b in zip(_COUNTED, before)}


#: pinned staging buffers per captured graph: a call fills the next one
#: while the copies of earlier calls may still be queued behind work on
#: the card (a prefill chunk that is not a request's last returns without
#: waiting for the card).
STAGING = 4


class _Graph:
    """One program captured for one signature over a static int32
    control buffer, filled from pinned memory by one copy before each
    replay.  ``fields`` names the buffer's consecutive parts and their
    lengths; ``body(**views)`` is the program's device work on views of
    the buffer.  All-zero controls are the warm-ups' inputs: every slot
    idle and every block-table entry the parking block 0, so warming up
    writes nothing a request reads.  The pinned buffers go round a ring
    of ``STAGING``; one is refilled only after its previous copy has run
    (its event), so a queued copy never reads a later call's values."""

    def __init__(self, dev, fields, body):
        n = sum(size for _, size in fields)
        self.ctrl = torch.zeros((n,), dtype=torch.int32, device=dev)
        self.hosts = [torch.zeros((n,), dtype=torch.int32).pin_memory()
                      for _ in range(STAGING)]
        self.copied = [torch.cuda.Event() for _ in range(STAGING)]
        self.next = 0
        self.slices, views, at = {}, {}, 0
        for name, size in fields:
            self.slices[name] = slice(at, at + size)
            views[name] = self.ctrl[at:at + size]
            at += size
        self.graph, self.out, self.captured = _capture(
            dev, lambda: body(**views))

    def replay(self, **values) -> None:
        i = self.next
        self.next = (i + 1) % STAGING
        host, copied = self.hosts[i], self.copied[i]
        copied.synchronize()  # returns at once if never recorded
        h = host.numpy()
        for name, v in values.items():
            h[self.slices[name]] = np.asarray(v).reshape(-1)
        self.ctrl.copy_(host, non_blocking=True)
        copied.record()
        self.graph.replay()


class DecodeEngine:
    """Continuous-batching decode over a :class:`PagedKVPool`.

    Args:
      model: a :class:`~chainermn_tpu_torch.models.TransformerLM` holding
        its weights (load trained ones with ``load_state_dict``, e.g. from
        :func:`~chainermn_tpu_torch.utils.params_from_flax`).  "fused"
        runs the paged kernel in the hot loop, "einsum" the gathered plain
        attention.
      capacity: decode slots per step (the fixed batch dimension).
      num_blocks: physical blocks in the pool (block 0 stays reserved).
      block_len: positions per block.
      max_blocks_per_slot: block-table width; caps a request at
        ``max_blocks_per_slot * block_len`` positions.  Defaults to
        covering ``model.max_len`` (+ ``spec_k``).
      prefill_chunk: largest prompt-tokens-per-prefill-call geometry.
      prefill_ladder: the allowed prefill chunk sizes (its max must equal
        ``prefill_chunk``); defaults to ``prefill_chunk`` and its halves
        down to 8.
      top_k: engine-wide sampling truncation (0 = off).
      draft_model: optional draft ``TransformerLM`` for speculative
        decoding (same vocab).  Requires ``spec_k``.
      spec_k: draft proposals per round (0 = speculation off).
      prefix_cache: share identical prompt prefixes through a refcounted
        block trie (on by default).
      mesh: the tensor-parallel engine is not ported yet and raises.
      device: where the pools live and the steps run; must be the
        model's device.  None means the current CUDA device and raises
        where there is none (pass ``device="cpu"`` for the plain path).

    Sampling keys each token by (the request's seed, the absolute
    position it conditions on) through :func:`lane_seed` and a
    ``torch.Generator``, so a request's samples depend only on its seed
    and its own positions, never on co-scheduling, slot placement or
    eviction.  The bits cannot equal the JAX engine's
    ``fold_in(PRNGKey(seed), position)`` samples: the two frameworks'
    generators differ.
    """

    def __init__(self, model, capacity: int, num_blocks: int,
                 block_len: int = 16,
                 max_blocks_per_slot: Optional[int] = None,
                 prefill_chunk: int = 32, top_k: int = 0,
                 prefill_ladder: Optional[List[int]] = None,
                 draft_model=None, spec_k: int = 0,
                 prefix_cache: bool = True, mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "the tensor-parallel (mesh=) engine is not ported yet "
                "(ROADMAP Queue 1, serving fleet: TP engine)"
            )
        dev = resolve_device(device, "DecodeEngine")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if (draft_model is None) != (spec_k == 0):
            raise ValueError(
                "speculative decoding needs BOTH draft_model and "
                f"spec_k >= 1 (got draft_model={draft_model is not None}, "
                f"spec_k={spec_k})"
            )
        for name, m in (("model", model), ("draft_model", draft_model)):
            if m is not None and m.device != dev:
                raise ValueError(
                    f"{name} parameters are on {m.device}, the engine "
                    f"runs on {dev}: move the model first"
                )
        if draft_model is not None:
            if draft_model.vocab != model.vocab:
                raise ValueError(
                    f"draft vocab {draft_model.vocab} != target vocab "
                    f"{model.vocab}: proposals would be meaningless"
                )
            if not 1 <= spec_k <= MAX_VERIFY_T - 1:
                raise ValueError(
                    f"spec_k must be in [1, {MAX_VERIFY_T - 1}] "
                    f"(verify chunk is k + 1 positions), got {spec_k}"
                )
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}"
            )
        if prefill_ladder is None:
            ladder = {prefill_chunk}
            c = prefill_chunk // 2
            while c >= 8:
                ladder.add(c)
                c //= 2
        else:
            ladder = set(int(c) for c in prefill_ladder)
            if not ladder or min(ladder) < 1:
                raise ValueError(f"bad prefill_ladder {prefill_ladder}")
            if max(ladder) != prefill_chunk:
                raise ValueError(
                    f"prefill_ladder max ({max(ladder)}) must equal "
                    f"prefill_chunk ({prefill_chunk}): the scheduler's "
                    "padding bound at submit() assumes it"
                )
        self.mesh = None
        self.device = dev
        self.model = model
        self.draft_model = draft_model
        self.capacity = capacity
        self.block_len = block_len
        self.spec_k = spec_k
        self.top_k = top_k
        self.prefill_chunk = prefill_chunk
        #: allowed prefill chunk geometries, ascending.
        self.prefill_ladder = tuple(sorted(ladder))
        self.pool = PagedKVPool(model, num_blocks, block_len, device=dev)
        self.pools = self.pool.pools
        if draft_model is not None:
            dpool = PagedKVPool(draft_model, num_blocks, block_len,
                                device=dev)
            self.draft_pools = dpool.pools
            #: device bytes per block across target + draft pools.
            self.pool.bytes_per_block += dpool.bytes_per_block
        else:
            self.draft_pools = None
        self.max_blocks = (
            max_blocks_per_slot if max_blocks_per_slot is not None
            else max(1, math.ceil((model.max_len + spec_k) / block_len))
        )
        #: prefix trie over this engine's allocator (None = sharing off).
        self.prefix = (
            PrefixCache(block_len, self.pool.allocator)
            if prefix_cache else None
        )
        #: per-slot sampling seeds and temperatures, written at admission.
        self.seeds = np.zeros((capacity,), np.int64)
        self.temp = np.zeros((capacity,), np.float32)
        #: the model's geometry, part of every program's signature.
        self._geometry = (
            f"{type(model).__name__}(vocab={model.vocab}, "
            f"n_layers={model.n_layers}, d_model={model.d_model}, "
            f"n_heads={model.n_heads}, kv_heads={model.kv_heads}, "
            f"dtype={model.dtype}, kv_dtype={model.kv_dtype}, "
            f"decode_attention={model.decode_attention}, "
            f"window={model.window}, blocks={num_blocks}x{block_len}, "
            f"draft={draft_model is not None})"
        )
        w = _odevice.watch()
        self._step = w.register("decode_step", budget=1,
                                cost_fn=self.decode_cost)
        self._prefill = w.register("prefill",
                                   budget=len(self.prefill_ladder))
        self._spec = (w.register("spec_round", budget=1,
                                 cost_fn=self.spec_cost)
                      if draft_model is not None else None)
        self._cow = w.register("cow", budget=1)
        self._gather = w.register("kv_gather", budget=1)
        self._put = w.register("kv_put", budget=1)
        #: captured graphs by signature key (CUDA only): the decode
        #: step's, prefill's (one per ladder geometry) and the
        #: speculative round's.
        self._graphs: Dict[tuple, _Graph] = {}
        self._prefill_graphs: Dict[tuple, _Graph] = {}
        self._spec_graphs: Dict[tuple, _Graph] = {}
        #: set by :meth:`release`: the device state is gone.
        self.released = False

    # ----------------------------------------------------------- helpers
    def release(self) -> None:
        """Free this engine's device state: its captured graphs (decode,
        prefill and speculative round, and with them their memory pools)
        and every KV pool, target and draft.  The fleet calls it when the
        engine leaves (a dead, retired or deregistered replica), so the
        card's memory returns to what the live replicas hold even while
        the engine object is still referenced.  Host state (allocator,
        trie, counters) stays readable; any further device call
        raises."""
        if self.released:
            return
        self.sync()
        for graphs in (self._graphs, self._prefill_graphs,
                       self._spec_graphs):
            graphs.clear()
        for layer in self._all_pools():
            layer.clear()
        self.released = True

    def _live(self) -> None:
        if self.released:
            raise RuntimeError(
                "this DecodeEngine was released (it left its fleet); "
                "build a new one"
            )

    def _up(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _run(self, prog, args: dict, fn):
        """``fn()``, recording a new signature of ``prog`` (its ``args``,
        the model's geometry, the first call's wall time) with the
        capture watch."""
        key = tuple(_key_of(v) for v in args.values())
        if prog.known(key):
            return fn()
        t0 = time.perf_counter()
        out = fn()
        _odevice.watch().record(prog, key, {**args, "model":
                                            self._geometry},
                                time.perf_counter() - t0, "eager")
        return out

    def _graph(self, prog, graphs: dict, args: dict, build) -> _Graph:
        """The graph of ``prog`` for ``args``' signature, captured by
        ``build()`` on the first call of that signature (recorded with the
        capture watch), counted as one replay of ``prog``: the caller
        replays it."""
        key = tuple(_key_of(v) for v in args.values())
        g = graphs.get(key)
        if g is None:
            t0 = time.perf_counter()
            g = build()
            torch.cuda.synchronize(self.device)
            graphs[key] = g
            _odevice.watch().record(prog, key, {**args, "model":
                                                self._geometry},
                                    time.perf_counter() - t0, "capture")
        prog.replays += 1
        return g

    def _pick(self, logits: torch.Tensor, slots, positions,
              greedy: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Tokens for ``logits`` ``(n, V)`` of ``slots`` conditioned at
        absolute ``positions``: greedy where the slot's temperature is
        <= 0 (``greedy`` when given: the argmax already taken), else
        temperature (and engine top-k) sampling."""
        slots = np.asarray(slots)
        temps = self.temp[slots]
        if greedy is None:
            nxt = torch.argmax(logits, dim=-1)
        elif (temps > 0).any():
            nxt = greedy.clone()
        else:
            return greedy
        for i in np.flatnonzero(temps > 0):
            scaled = logits[i] / max(float(temps[i]), 1e-6)
            if self.top_k:
                k = min(self.top_k, scaled.shape[-1])
                kth = torch.topk(scaled, k).values[-1]
                scaled = torch.where(scaled >= kth, scaled,
                                     torch.full_like(scaled, -math.inf))
            g = torch.Generator(device=self.device)
            g.manual_seed(lane_seed(self.seeds[slots[i]], positions[i]))
            nxt[i] = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                       generator=g)[0]
        return nxt

    # ------------------------------------------------------------- slots
    def seed_slot(self, slot: int, seed: int, temperature: float) -> None:
        """Arm a slot's sampling seed and temperature (admission only)."""
        self.seeds[slot] = int(seed)
        self.temp[slot] = float(temperature)

    # ----------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, slot: int, chunk: np.ndarray, p0: int,
                table: np.ndarray, last_idx: int = -1) -> Optional[int]:
        """Run one prefill chunk for ``slot``.

        ``chunk`` is one of the ``prefill_ladder`` geometries,
        right-padded past the prompt (pad positions are masked until real
        tokens overwrite them; pads past the allocation fall through the
        zero tail of ``table`` into parking block 0).  ``p0`` may start
        mid-block (a prefix-cache hit resumes at the first unmatched
        token).  ``last_idx >= 0`` marks the final chunk: the first
        generated token is sampled from the logits at that in-chunk index
        and returned.
        """
        self._live()
        chunk = np.asarray(chunk, np.int32)
        if chunk.ndim != 1 or chunk.shape[0] not in self.prefill_ladder:
            raise ValueError(
                f"chunk must be 1-D with a ladder size "
                f"{self.prefill_ladder}, got {chunk.shape}"
            )
        table = np.asarray(table, np.int32)[None]
        C, MB = chunk.shape[0], table.shape[1]
        args = {"chunk": chunk, "p0": int(p0), "table": table}
        if self.device.type == "cuda":
            g = self._graph(self._prefill, self._prefill_graphs, args,
                            lambda: _Graph(self.device, (
                                ("chunk", C), ("p0", 1), ("last", 1),
                                ("table", MB)), self._prefill_views))
            g.replay(chunk=chunk, p0=p0, last=max(last_idx, 0), table=table)
            logits, greedy = g.out
        else:
            ctrl = self._up(np.concatenate(
                [chunk, [p0, max(last_idx, 0)], table[0]]).astype(np.int32))
            logits, greedy = self._run(
                self._prefill, args,
                lambda: self._prefill_views(ctrl[:C], ctrl[C:C + 1],
                                            ctrl[C + 1:C + 2], ctrl[C + 2:]))
        if last_idx < 0:
            return None
        return int(self._pick(logits, [slot], [int(p0) + last_idx],
                              greedy=greedy)[0])

    def _prefill_views(self, chunk, p0, last, table):
        """Prefill's device work on int32 views of its control buffer:
        the target's (and the draft's) forward over the chunk from the
        0-d start position ``p0[0]``, then the fp32 LM head at the
        in-chunk row ``last[0]`` only.  ``(1, V)`` logits and their
        greedy token."""
        toks = chunk.long()[None]
        tbl = table.view(1, -1)
        start = p0[0]
        h, _ = self.model(toks, return_hidden=True, cache=self.pools,
                          decode_pos=start, block_tables=tbl)
        if self.draft_model is not None:
            self.draft_model(toks, return_hidden=True,
                             cache=self.draft_pools, decode_pos=start,
                             block_tables=tbl)
        logits = self.model.head(h.index_select(1, last.long())[:, 0])
        return logits, torch.argmax(logits, dim=-1)

    # ------------------------------------------------------------ decode
    @staticmethod
    def _host(tokens, pos, tables, active):
        return (np.asarray(tokens, np.int32), np.asarray(pos, np.int32),
                np.asarray(tables, np.int32), np.asarray(active, bool))

    _SLOT_ARGS = ("tokens", "pos", "tables", "active")

    def _slot_program(self, prog, graphs: dict, host, body):
        """``body(tokens, pos, tables, active)`` over the fixed-capacity
        control vectors ``host``: replayed from its graph for this
        signature on a card, run eagerly on the CPU (a new signature
        recorded with the capture watch)."""
        tokens, pos, tables, active = host
        args = dict(zip(self._SLOT_ARGS, host))
        if self.device.type != "cuda":
            tok, p, tbl, act = (self._up(a) for a in host)
            return self._run(prog, args,
                             lambda: body(tok.long(), p, tbl, act))
        S, MB = tables.shape
        g = self._graph(prog, graphs, args, lambda: _Graph(self.device, (
            ("tokens", S), ("pos", S), ("active", S), ("tables", S * MB)),
            lambda tokens, pos, active, tables: body(
                tokens.long(), pos, tables.view(S, MB), active)))
        g.replay(tokens=tokens, pos=pos, active=active, tables=tables)
        return g.out

    def _forward(self, tok, pos, tables, active):
        """The decode step's device work: ``(capacity, V)`` fp32 logits and
        their greedy tokens."""
        logits, _ = self.model(tok[:, None], cache=self.pools,
                               decode_pos=pos, block_tables=tables,
                               slot_mask=active)
        logits = logits[:, 0]
        return logits, torch.argmax(logits, dim=-1)

    @torch.no_grad()
    def step(self, tokens: np.ndarray, pos: np.ndarray,
             tables: np.ndarray, active: np.ndarray) -> np.ndarray:
        """One fixed-capacity decode iteration.

        Args (host arrays, shapes fixed by construction):
          tokens: ``(capacity,)`` int32, each slot's last token.
          pos: ``(capacity,)`` int32, the position this step writes.
          tables: ``(capacity, max_blocks)`` int32 block tables.
          active: ``(capacity,)`` bool, live slots.

        Returns ``(capacity,)`` int32 tokens (garbage at inactive slots).
        On a CUDA device the first call of a signature captures the step
        and every call replays it.
        """
        self._live()
        host = self._host(tokens, pos, tables, active)
        logits, greedy = self._replay(host)
        nxt = self._pick(logits, np.arange(self.capacity), host[1],
                         greedy=greedy)
        return nxt.to(torch.int32).cpu().numpy()

    def _replay(self, host):
        """The decode step over ``host``'s control vectors: its static
        logits and greedy tokens (a replay on a card)."""
        return self._slot_program(self._step, self._graphs, host,
                                  self._forward)

    @torch.no_grad()
    def decode_cost(self) -> dict:
        """The decode step's cost model for the capture watch's roofline
        (``observability/device.py`` states the formula): FLOPs counted by
        ``FlopCounterMode`` over one eager all-idle step (idle slots write
        only the parking block), the bytes of the weights it reads, its
        control vectors and the logits it writes, and per attended
        position the KV bytes read and, when the hand-written paged kernel
        runs the attention (the counter cannot see it), its FLOPs."""
        from torch.utils.flop_counter import FlopCounterMode

        m, S, MB = self.model, self.capacity, self.max_blocks
        tables = torch.zeros((S, MB), dtype=torch.int32, device=self.device)
        idle = tables[:, 0]
        with FlopCounterMode(display=False) as fc:
            self._forward(idle.long(), idle, tables, idle)
        rows = {"embed.weight", "pos"}  # gathered: S rows read
        weights = sum(
            (S * p[0].numel() if n in rows else p.numel()) * p.element_size()
            for n, p in m.named_parameters()
        )
        layer = self.pools[0]
        kv_pos = sum(t.element_size() * t.shape[-1] if t.dim() == 4
                     else t.element_size()
                     for t in layer.values()) * m.kv_heads
        kernel = (self.device.type == "cuda"
                  and m.decode_attention == "fused" and not m.window)
        return {
            "flops": float(fc.get_total_flops()),
            "bytes accessed": float(weights + S * (3 + MB) * 4
                                    + S * m.vocab * 4),
            "kv_bytes_per_position": float(m.n_layers * kv_pos),
            "attention_flops_per_position": (
                m.n_layers * _odevice.attention_core_flops(
                    1, m.n_heads, 1, m.head_dim, kv_len=1, n_backward=0)
                if kernel else 0.0
            ),
        }

    @torch.no_grad()
    def spec_step(self, tokens: np.ndarray, pos: np.ndarray,
                  tables: np.ndarray, active: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """One speculative round (same fixed shapes as :meth:`step`).  The
        slot at ``pos`` must have block-table coverage up to ``pos +
        spec_k`` (the verify chunk's writes).

        Returns ``(tokens, n_accept)``: ``(capacity, spec_k + 1)`` int32
        round tokens and ``(capacity,)`` int32 accepted draft counts; slot
        ``s`` emits ``tokens[s, :n_accept[s] + 1]``.
        """
        if self.draft_model is None:
            raise RuntimeError(
                "spec_step on a non-speculative engine: construct with "
                "draft_model/spec_k"
            )
        self._live()
        host = self._host(tokens, pos, tables, active)
        toks, n_accept, logits0 = self._slot_program(
            self._spec, self._spec_graphs, host, self._spec_forward)
        # Sampling slots sample position 0's logits (the plain step's)
        # and accept no draft: outside the graph.  One copy to the host.
        tok0 = self._pick(logits0, np.arange(self.capacity), host[1],
                          greedy=toks[:, 0])
        both = torch.cat([tok0[:, None], toks[:, 1:], n_accept[:, None]],
                         dim=1).to(torch.int32).cpu().numpy()
        n = both[:, -1].copy()
        n[self.temp > 0] = 0
        return both[:, :-1].copy(), n

    def _spec_forward(self, tok, p, tbl, act):
        """The speculative round's device work: ``k + 1`` draft steps
        (the last only backfills the final proposal's K/V into the draft
        pools), one target verify forward over the ``(k + 1)``-position
        chunk, the greedy argmax and the prefix acceptance.  Returns the
        round's greedy tokens ``(S, k + 1)``, the accepted draft counts
        ``(S,)`` and the verify step's position-0 logits ``(S, V)``."""
        k = self.spec_k
        cur, drafts = tok, []
        for i in range(k + 1):
            dlogits, _ = self.draft_model(
                cur[:, None], cache=self.draft_pools, decode_pos=p + i,
                block_tables=tbl, slot_mask=act,
            )
            cur = torch.argmax(dlogits[:, 0], dim=-1)
            drafts.append(cur)
        chunk = torch.stack([tok] + drafts[:k], dim=1)  # (S, k + 1)
        logits, _ = self.model(chunk, cache=self.pools, decode_pos=p,
                               block_tables=tbl, slot_mask=act)
        g = torch.argmax(logits, dim=-1)
        agree = (g[:, :k] == chunk[:, 1:]).to(torch.int32)
        n_accept = torch.cumprod(agree, dim=1).sum(dim=1)
        return g, n_accept, logits[:, 0]

    @torch.no_grad()
    def spec_cost(self) -> dict:
        """The speculative round's cost model for the capture watch's
        roofline, as :meth:`decode_cost` builds the decode step's: FLOPs
        counted over one eager all-idle round, every weight of both
        models read once per forward (``k + 1`` draft steps, one verify),
        and per attended position the KV bytes each forward reads and,
        where the paged kernel runs the attention, its FLOPs."""
        from torch.utils.flop_counter import FlopCounterMode

        m, d, S, MB = self.model, self.draft_model, self.capacity, \
            self.max_blocks
        k = self.spec_k
        tables = torch.zeros((S, MB), dtype=torch.int32, device=self.device)
        idle = tables[:, 0]
        with FlopCounterMode(display=False) as fc:
            self._spec_forward(idle.long(), idle, tables, idle)

        def weights(model, rows):
            gathered = {"embed.weight", "pos"}  # one row per token read
            return sum((rows * p[0].numel() if n in gathered else p.numel())
                       * p.element_size()
                       for n, p in model.named_parameters())

        def kv_pos(model, pools):
            return model.n_layers * model.kv_heads * sum(
                t.element_size() * t.shape[-1] if t.dim() == 4
                else t.element_size() for t in pools[0].values())

        def core(model):
            kernel = (self.device.type == "cuda"
                      and model.decode_attention == "fused"
                      and not model.window)
            return (model.n_layers * _odevice.attention_core_flops(
                1, model.n_heads, 1, model.head_dim, kv_len=1,
                n_backward=0) if kernel else 0.0)

        return {
            "flops": float(fc.get_total_flops()),
            "bytes accessed": float(
                (k + 1) * weights(d, S) + weights(m, S * (k + 1))
                + S * (3 + MB) * 4 + S * (k + 1) * m.vocab * 4),
            "kv_bytes_per_position": float(
                (k + 1) * kv_pos(d, self.draft_pools)
                + kv_pos(m, self.pools)),
            "attention_flops_per_position": (k + 1) * (core(d) + core(m)),
        }

    # ----------------------------------------------------- prefix sharing
    def _all_pools(self):
        yield from self.pools
        if self.draft_pools is not None:
            yield from self.draft_pools

    @torch.no_grad()
    def cow_copy(self, src: int, dst: int) -> None:
        """Copy physical block ``src`` onto ``dst`` across every layer of
        every pool (target + draft): the device half of copy-on-write."""
        self._live()

        def run():
            for layer in self._all_pools():
                for t in layer.values():
                    t[:, dst] = t[:, src]

        self._run(self._cow, {"src": int(src), "dst": int(dst)}, run)

    def drop_prefix_cache(self) -> int:
        """Release every trie-held block reference; returns the number of
        blocks released."""
        return self.prefix.clear() if self.prefix is not None else 0

    # ------------------------------------------------------- kv migration
    @staticmethod
    def _to_host(t: torch.Tensor) -> np.ndarray:
        # numpy has no bfloat16: ship its bits as int16 (byte-preserving).
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy()

    def read_block(self, block: int) -> dict:
        """One physical block's KV contents as host numpy arrays:
        ``{"target": [per-layer {name: (KH, block_len, Dh)}], "draft":
        same or None}``.  bf16 pools come back as their int16 bits."""
        self._live()

        def one(layer):
            return {n: self._to_host(t[:, block]) for n, t in layer.items()}

        return self._run(self._gather, {"block": int(block)}, lambda: {
            "target": [one(p) for p in self.pools],
            "draft": (None if self.draft_pools is None
                      else [one(p) for p in self.draft_pools]),
        })

    @torch.no_grad()
    def write_block(self, block: int, data: dict) -> None:
        """Install :meth:`read_block` data into physical ``block`` across
        every layer of every pool; the block then re-reads byte for byte
        as the source's :meth:`read_block`."""
        self._live()
        if (data.get("draft") is not None) != (self.draft_model is not None):
            raise ValueError(
                "migration payload draft pools do not match this engine "
                f"(payload draft={data.get('draft') is not None}, engine "
                f"draft={self.draft_model is not None})"
            )
        pairs = list(zip(self.pools, data["target"]))
        if self.draft_pools is not None:
            pairs += list(zip(self.draft_pools, data["draft"]))

        def run():
            for layer, payload in pairs:
                for n, t in layer.items():
                    src = torch.from_numpy(np.ascontiguousarray(payload[n]))
                    if t.dtype == torch.bfloat16:
                        src = src.view(torch.bfloat16)
                    t[:, block] = src.to(self.device)

        self._run(self._put, {"block": int(block)}, run)

    def sync(self) -> None:
        """Block until every queued operation on the pools has finished."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------- introspection
    @property
    def hot_program(self):
        """The steady-state loop's watched program: the speculative round
        when a draft is armed, else the decode step.  What the
        scheduler's ``device.*`` roofline gauges attribute to."""
        return self._spec if self._spec is not None else self._step

    @property
    def decode_compiles(self) -> int:
        """Captures (on a card; signatures on the CPU) of the hot-loop
        program: must stay 1 under arbitrary slot churn."""
        return self.hot_program.compiles

    @property
    def decode_replays(self) -> int:
        """Replays of the captured decode step (0 on the CPU)."""
        return self._step.replays

    @property
    def prefill_replays(self) -> int:
        """Replays of the captured prefill graphs (0 on the CPU)."""
        return self._prefill.replays

    @property
    def spec_replays(self) -> int:
        """Replays of the captured speculative round (0 on the CPU)."""
        return self._spec.replays if self._spec is not None else 0

    @property
    def verify_compiles(self) -> int:
        """Speculative round signatures (0 on a plain engine)."""
        return self._spec.compiles if self._spec is not None else 0

    @property
    def cow_compiles(self) -> int:
        """Copy-on-write block-copy signatures (must stay <= 1)."""
        return self._cow.compiles

    @property
    def gather_compiles(self) -> int:
        return self._gather.compiles

    @property
    def put_compiles(self) -> int:
        return self._put.compiles

    @property
    def prefill_compiles(self) -> int:
        """Captures of prefill on a card (signatures on the CPU): at most
        ``len(prefill_ladder)``."""
        return self._prefill.compiles

    def free_blocks(self) -> int:
        return self.pool.allocator.free_blocks

    def stats(self) -> dict:
        """Host-side engine state; never touches a device buffer."""
        free = self.pool.allocator.free_blocks
        allocatable = self.pool.num_blocks - 1  # block 0 reserved
        out = {
            "capacity": self.capacity,
            "num_blocks": self.pool.num_blocks,
            "block_len": self.block_len,
            "free_blocks": free,
            "blocks_in_use": allocatable - free,
            "block_occupancy": (
                (allocatable - free) / allocatable if allocatable else 0.0
            ),
            "decode_compiles": self.decode_compiles,
            "prefill_compiles": self.prefill_compiles,
        }
        if self.prefix is not None:
            out["prefix_cached_blocks"] = self.prefix.cached_blocks
        if self.spec_k:
            out["spec_k"] = self.spec_k
            out["verify_compiles"] = self.verify_compiles
        if self._graphs:
            out["decode_replays"] = self.decode_replays
        if self._prefill_graphs:
            out["prefill_replays"] = self.prefill_replays
        if self._spec_graphs:
            out["spec_replays"] = self.spec_replays
        # Programs over their declared budget (empty on a healthy
        # engine); the flight record's "compile" section carries the
        # per-program records and blame diffs.
        over = [p.program for p in (self._step, self._prefill, self._spec,
                                    self._cow, self._gather, self._put)
                if p is not None and p.over_budget]
        if over:
            out["compile_over_budget"] = over
        return out

    def alloc_blocks(self, n: int) -> Optional[List[int]]:
        return self.pool.allocator.alloc(n)

    def release_blocks(self, blocks) -> None:
        self.pool.allocator.free(blocks)
