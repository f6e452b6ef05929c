"""Shared rig of the port's serving-fleet parity tests
(``test_torch_router.py``, ``test_torch_fleet_recovery.py``,
``test_torch_disagg.py``, ``test_torch_elastic.py``).

One scenario function drives either package through a namespace
(:func:`jax_pkg` / :func:`port_pkg`) that holds its serving classes and an
engine factory on the serving test geometry of
``test_torch_serve_planes.py`` (vocab 257, 2 layers, d_model 64, fp32,
Flax parameters carried across with ``params_from_flax``).  The scenario
returns a summary dict; :func:`assert_same` holds the port's summary to
the JAX one: every integer, status, assignment and counter exactly, and
each ``tokens`` map by the greedy divergence structure (a near-argmax
fp32 tie may flip deep into a sequence under another kernel geometry; a
logic bug diverges at once).
"""

import types

import numpy as np
import torch

import jax
import jax.numpy as jnp

KW = dict(vocab=257, n_layers=2, d_model=64, n_heads=4, d_ff=128,
          max_len=128, pos_enc="rope")
ENG = dict(capacity=2, num_blocks=24, block_len=8, prefill_chunk=8)
PROMPT_SIZES = (5, 12, 9, 3, 17)


class FixedClock:
    """A scheduler clock that never moves: every decision and every
    integer the ledger books is independent of the host's speed."""

    def now(self):
        return 0.0

    def skip_to(self, t):
        pass


class StepClock:
    """A clock that moves only when told (deadline tests)."""

    def __init__(self):
        self.t = 0.0

    def now(self):
        return self.t

    def skip_to(self, t):
        self.t = max(self.t, float(t))


def build_models():
    """The JAX model, its numpy parameters, a 1-layer JAX draft with its
    parameters, and the port's twins of both carrying the same weights."""
    from chainermn_tpu.models import TransformerLM as JaxLM
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.utils import params_from_flax

    def pair(n_layers, key):
        jm = JaxLM(**{**KW, "n_layers": n_layers}, dtype=jnp.float32)
        params = jax.jit(jm.init)(jax.random.PRNGKey(key),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
        params = jax.tree_util.tree_map(np.asarray, params)
        tm = TransformerLM(**{**KW, "n_layers": n_layers},
                           dtype=torch.float32, decode_attention="fused",
                           device="cpu")
        tm.load_state_dict(params_from_flax(params, device="cpu"))
        return jm, params, tm

    return pair(KW["n_layers"], 0), pair(1, 3)


def make_prompts(seed=0, sizes=PROMPT_SIZES):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, KW["vocab"], size=n).tolist() for n in sizes]


def _common(ns):
    ns.counter = lambda reg, name: (
        reg.peek(name).value if reg.peek(name) is not None else None
    )
    ns.hcount = lambda reg, name: (
        reg.peek(name).count if reg.peek(name) is not None else 0
    )
    ns.inj = lambda spec: (
        ns.FaultInjector(ns.parse_fault_spec(spec)) if spec else None
    )
    return ns


def jax_pkg(models):
    """The JAX package's serving fleet behind the scenario interface."""
    from chainermn_tpu.observability import incident
    from chainermn_tpu.observability.metrics import MetricsRegistry
    from chainermn_tpu.resilience.faults import (
        FaultInjector,
        parse_fault_spec,
    )
    from chainermn_tpu import serving
    from chainermn_tpu.serving import disagg, elastic, recovery, scheduler

    (jm, params, _), (jd, dparams, _) = models

    def engine(draft=False, params=params, **kw):
        extra = (dict(draft_model=jd, draft_params=dparams,
                      spec_k=kw.pop("spec_k", 2)) if draft else {})
        return serving.DecodeEngine(jm, params, **{**ENG, **kw}, **extra)

    return _common(types.SimpleNamespace(
        name="jax", engine=engine, MetricsRegistry=MetricsRegistry,
        FaultInjector=FaultInjector, parse_fault_spec=parse_fault_spec,
        serving=serving, disagg=disagg, elastic=elastic,
        recovery=recovery, scheduler=scheduler, incident=incident,
        **{k: getattr(serving, k) for k in serving.__all__},
    ))


def port_pkg(models):
    """The port's serving fleet behind the scenario interface."""
    from chainermn_tpu_torch.observability import incident
    from chainermn_tpu_torch.observability.metrics import MetricsRegistry
    from chainermn_tpu_torch.resilience.faults import (
        FaultInjector,
        parse_fault_spec,
    )
    from chainermn_tpu_torch import serving
    from chainermn_tpu_torch.serving import (
        disagg,
        elastic,
        recovery,
        scheduler,
    )

    (_, _, tm), (_, _, td) = models

    def engine(draft=False, params=None, **kw):
        """``params`` (Flax parameters, or a model already carrying new
        weights) builds the engine over a new model carrying them, as a
        deploy of new weights would."""
        extra = (dict(draft_model=td, spec_k=kw.pop("spec_k", 2))
                 if draft else {})
        model = tm
        if isinstance(params, torch.nn.Module):
            model = params
        elif params is not None:
            from chainermn_tpu_torch.models import TransformerLM
            from chainermn_tpu_torch.utils import params_from_flax

            model = TransformerLM(**KW, dtype=torch.float32,
                                  decode_attention="fused", device="cpu")
            model.load_state_dict(params_from_flax(params, device="cpu"))
        return serving.DecodeEngine(model, **{**ENG, **kw}, **extra,
                                    device="cpu")

    return _common(types.SimpleNamespace(
        name="port", engine=engine, MetricsRegistry=MetricsRegistry,
        FaultInjector=FaultInjector, parse_fault_spec=parse_fault_spec,
        serving=serving, disagg=disagg, elastic=elastic,
        recovery=recovery, scheduler=scheduler, incident=incident,
        **{k: getattr(serving, k) for k in serving.__all__},
    ))


def assert_greedy_agreement(got, want, min_first_divergence=8, what=""):
    """Exact equality is the expectation; a near-argmax fp32 tie may flip
    deep into a sequence, a logic bug diverges at about token 0."""
    if got == want:
        return
    mm = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    assert len(got) == len(want) and mm and \
        mm[0] >= min_first_divergence, (
            f"{what}: diverged at token {mm[0] if mm else '?'} "
            f"(< {min_first_divergence}): a structural mismatch\n"
            f" got={got}\nwant={want}")


def assert_same(port, ref):
    """Hold a port scenario summary to the JAX one: ``tokens`` maps by
    the greedy divergence structure, everything else exactly."""
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    for key in ref:
        if key == "tokens":
            assert set(port[key]) == set(ref[key]), key
            for rid, want in ref[key].items():
                assert_greedy_agreement(port[key][rid], want,
                                        what=f"request {rid}")
        else:
            assert port[key] == ref[key], (key, port[key], ref[key])


def by_id(comps, *fields):
    """``{id: (field, ...)}`` over completions."""
    return {c.id: tuple(getattr(c, f) for f in fields) for c in comps}


def tokens_of(comps):
    return {c.id: list(c.tokens) for c in comps if c.status == "ok"}


def error_kind(err):
    """An attributed error's exception type (the texts of the two
    packages' injected faults differ)."""
    return None if err is None else str(err).split(":")[0]
