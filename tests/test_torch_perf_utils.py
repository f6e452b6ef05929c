"""The port's perf sentinel, timing and MFU utilities and model export
against the JAX package's (``chainermn_tpu/observability/perf.py``,
``chainermn_tpu/utils/__init__.py``, ``chainermn_tpu/utils/export.py``;
``tests/observability_tests/test_perf_sentinel.py`` and
``tests/utils_tests/test_export.py``).

Against the JAX package on the same inputs: ``load_history`` and
``judge_series`` on the same ``result/``-style records (the committed
history and seeded synthetic series: equal samples, equal verdicts),
``scaling_efficiency`` on seeded throughputs, and an exported MLP
forward against the JAX MLP on the same Flax parameters (rtol 1e-5,
atol 1e-6).  On the port: the JAX test files' behaviour cases, a card's
series never judged against the TPU history, the utilities, the
exported forward at any batch, and the refusal to export a forward that
reaches a hand-written kernel.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import jax

from chainermn_tpu import utils as jax_utils
from chainermn_tpu.models import MLP as JaxMLP
from chainermn_tpu.observability import perf as jax_perf
from chainermn_tpu_torch import utils
from chainermn_tpu_torch.models import MLP
from chainermn_tpu_torch.observability import perf
from chainermn_tpu_torch.utils.export import (
    export_forward,
    load_forward,
    load_forward_file,
    save_forward,
)
from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1

RESULT_DIR = perf.default_result_dir()


def _write(d, name, value, when, metric="widget_tokens_per_sec",
           platform="tpu", **extra):
    rec = {"metric": metric, "value": value, "unit": "tok/s",
           "platform": platform,
           "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                        time.gmtime(when)), **extra}
    with open(os.path.join(d, name), "w") as f:
        json.dump(rec, f)


# ---------------------------------------------------- parity with JAX
def _strip_platform(series):
    """Series keyed as the JAX package keys them (the port adds the
    platform to the key)."""
    out = {}
    for key, samples in series.items():
        k = json.loads(key)
        k.pop("platform", None)
        out[json.dumps(k, sort_keys=True, default=str)] = samples
    return out


def test_committed_history_loads_and_judges_as_jax():
    mine = perf.load_history(RESULT_DIR, platform="tpu")
    ref = jax_perf.load_history(RESULT_DIR)
    assert _strip_platform(mine) == ref
    assert sorted(json.dumps(perf.judge_series(s), sort_keys=True)
                  for s in mine.values()) == \
        sorted(json.dumps(jax_perf.judge_series(s), sort_keys=True)
               for s in ref.values())


@pytest.mark.parametrize("seed", range(5))
def test_judge_series_matches_jax_on_seeded_series(seed, tmp_path):
    rng = np.random.RandomState(seed)
    d = str(tmp_path)
    t0 = 1_700_000_000
    for m, metric in enumerate(("a_tokens_per_sec", "b_step_ms")):
        base = rng.uniform(100, 1000)
        for i in range(int(rng.randint(2, 8))):
            v = base * (1 + rng.uniform(-0.12, 0.12))
            _write(d, f"{m}_{i}.json", float(v), t0 + i * 3600,
                   metric=metric)
    mine, ref = perf.load_history(d), jax_perf.load_history(d)
    assert _strip_platform(mine) == ref
    for noise in (None, 2.0, 10.0):
        assert [perf.judge_series(s, noise) for s in mine.values()] == \
            [jax_perf.judge_series(s, noise) for s in ref.values()]
    assert perf.direction("x_latency_ms") == jax_perf.direction(
        "x_latency_ms") == "lower"


def test_scaling_efficiency_matches_jax():
    rng = np.random.RandomState(0)
    sizes = [1, 2, 4, 8]
    thr = list(rng.uniform(100, 1000, size=4))
    assert utils.scaling_efficiency(thr, sizes) == \
        jax_utils.scaling_efficiency(thr, sizes)


# ------------------------------------------------------------ the sentinel
def test_committed_history_is_green():
    report = perf.analyze(RESULT_DIR)
    assert report["verdict"] == "green", report["regressed"]
    assert report["series_judged"] >= 2
    assert report["series_total"] > report["series_judged"]


def test_injected_regression_names_metric_and_first_bad(tmp_path):
    t0, d = 1_700_000_000, str(tmp_path)
    for i, v in enumerate((1000.0, 1010.0, 995.0)):
        _write(d, f"a{i}.json", v, t0 + i * 3600)
    _write(d, "bad0.json", 900.0, t0 + 10 * 3600)
    _write(d, "bad1.json", 890.0, t0 + 11 * 3600)
    report = perf.analyze(d)
    assert report["verdict"] == "regressed"
    (worst,) = report["regressed"]
    assert worst["first_bad"] == "bad0.json"
    assert worst["magnitude_pct"] == pytest.approx(11.0, abs=0.5)
    assert perf.sentinel(d) == {
        "verdict": "regressed", "metric": "widget_tokens_per_sec",
        "drop_pct": worst["magnitude_pct"], "first_bad": "bad0.json",
        "regressed_series": 1}


def test_noise_band_folds_observed_spread(tmp_path):
    t0, d = 1_700_000_000, str(tmp_path)
    for i, v in enumerate((1000.0, 1150.0, 1000.0)):
        _write(d, f"n{i}.json", v, t0 + i * 3600)
    _write(d, "new.json", 950.0, t0 + 9 * 3600)
    assert perf.analyze(d)["verdict"] == "green"


def test_lower_better_direction_for_latency_metrics(tmp_path):
    t0, d = 1_700_000_000, str(tmp_path)
    for i in range(3):
        _write(d, f"l{i}.json", 10.0, t0 + i * 3600,
               metric="decode_latency_ms")
    _write(d, "lbad.json", 12.0, t0 + 9 * 3600, metric="decode_latency_ms")
    assert perf.analyze(d)["verdict"] == "regressed"
    os.unlink(os.path.join(d, "lbad.json"))
    _write(d, "lgood.json", 8.0, t0 + 9 * 3600, metric="decode_latency_ms")
    assert perf.analyze(d)["verdict"] == "green"


def test_config_discriminator_splits_series(tmp_path):
    t0, d = 1_700_000_000, str(tmp_path)
    _write(d, "b8.json", 6000.0, t0, batch=8)
    _write(d, "b8b.json", 6010.0, t0 + 3600, batch=8)
    _write(d, "b64.json", 48000.0, t0 + 7200, batch=64)
    report = perf.analyze(d)
    assert report["verdict"] == "green" and report["series_total"] == 2


def test_card_series_never_judged_against_tpu_history(tmp_path):
    """The same metric and config on the card forms its own series: a
    card number far below the TPU's is no regression of the TPU's."""
    t0, d = 1_700_000_000, str(tmp_path)
    for i in range(3):
        _write(d, f"t{i}.json", 2000.0, t0 + i * 3600)
    _write(d, "g0.json", 300.0, t0 + 9 * 3600, platform="gpu",
           device_kind="NVIDIA H100 80GB HBM3")
    report = perf.analyze(d)
    assert report["verdict"] == "green" and report["series_total"] == 2
    assert perf.analyze(d, platform="gpu")["series_total"] == 1
    assert perf.analyze(d, platform="tpu")["series_total"] == 1
    _write(d, "g1.json", 310.0, t0 + 10 * 3600, platform="gpu",
           device_kind="NVIDIA H100 80GB HBM3")
    _write(d, "g2.json", 200.0, t0 + 11 * 3600, platform="gpu",
           device_kind="NVIDIA H100 80GB HBM3")
    s = perf.sentinel(d, platform="gpu")
    assert s["verdict"] == "regressed" and s["first_bad"] == "g2.json"
    assert perf.sentinel(d, platform="tpu") == {"verdict": "green",
                                               "series": 1}


def test_live_payload_joins_exactly_its_series(tmp_path):
    t0, d = 1_700_000_000, str(tmp_path)
    for i in range(3):
        _write(d, f"s{i}.json", 2000.0, t0 + i * 3600)
    live = {"metric": "widget_tokens_per_sec", "value": 1500.0,
            "unit": "tok/s", "platform": "tpu", "cached": False}
    s = perf.sentinel(d, live=live)
    assert s["verdict"] == "regressed"
    assert s["first_bad"] == "<live bench_summary>"
    for other in ({"cached": True}, {"platform": "cpu"},
                  {"platform": "tpu (cached 2026)"}, {"batch": 512},
                  {"platform": "gpu"}):
        assert perf.sentinel(d, live={**live, **other})["verdict"] == \
            "green", other


def test_unstamped_artifacts_never_judged_as_newest(tmp_path):
    t0, d = 1_700_000_000, str(tmp_path)
    for i in range(2):
        _write(d, f"s{i}.json", 1000.0, t0 + i * 3600)
    with open(os.path.join(d, "zz_unstamped.json"), "w") as f:
        json.dump({"metric": "widget_tokens_per_sec", "value": 700.0,
                   "unit": "tok/s", "platform": "tpu"}, f)
    report = perf.analyze(d)
    assert report["verdict"] == "green"
    (series,) = [r for r in report["series"]
                 if r["status"] != "insufficient"]
    assert series["newest_file"] == "s1.json"


def test_non_headline_artifacts_are_skipped(tmp_path):
    d = str(tmp_path)
    with open(os.path.join(d, "trace.json"), "w") as f:
        json.dump({"traceEvents": []}, f)
    with open(os.path.join(d, "cpu.json"), "w") as f:
        json.dump({"metric": "m", "value": 1.0, "platform": "cpu"}, f)
    with open(os.path.join(d, "broken.json"), "w") as f:
        f.write("{not json")
    report = perf.analyze(d)
    assert report["verdict"] == "green" and report["series_total"] == 0


def test_cli_json_and_table(capsys):
    assert perf.main(["--result-dir", RESULT_DIR, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["verdict"] == "green"
    assert perf.main(["--result-dir", RESULT_DIR, "--platform", "gpu"]) == 0
    assert "verdict: green (0 series judged, 0 total)" in \
        capsys.readouterr().out


# ---------------------------------------------------------- the utilities
def test_atomic_json_dump(tmp_path):
    path = str(tmp_path / "a.json")
    utils.atomic_json_dump({"x": 1}, path)
    assert json.load(open(path)) == {"x": 1}
    with pytest.raises(TypeError):
        utils.atomic_json_dump({"x": object()}, path)
    assert json.load(open(path)) == {"x": 1}
    assert not os.path.exists(path + ".tmp")


def test_benchmark_and_sync():
    calls = []

    def step(x):
        calls.append(1)
        return {"y": x * 2, "z": [x]}

    out = utils.benchmark(step, torch.ones(3), warmup=2, iters=4)
    assert len(calls) == 6 and out["iters"] == 4.0
    assert 0 <= out["min_s"] <= out["mean_s"] <= out["max_s"]
    utils.sync({"a": torch.ones(2), "b": [torch.zeros(1), 3]})


def test_trace_writes_a_profile(tmp_path):
    with utils.trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "prof"))


def test_mfu_and_flash_fields():
    kind = "NVIDIA H100 80GB HBM3"
    peak = utils.PEAK_BF16_FLOPS[kind]
    assert utils.mfu(peak * 0.5, 1.0, device_kind=kind) == \
        pytest.approx(50.0)
    assert utils.mfu(1e12, 1.0, device_kind="cpu") is None
    assert utils.mfu(None, 1.0, device_kind=kind) is None
    fields = utils.flash_mfu_fields(peak * 0.25, peak * 0.25, 1.0,
                                    device_kind=kind)
    assert fields == {"tflops_flash_uncounted": round(peak * 0.25 / 1e12, 3),
                      "mfu_pct_incl_flash": 50.0}
    assert utils.flash_mfu_fields(1e12, 0.0, 1.0, device_kind=kind) == {}
    assert utils.flash_mfu_fields(1e12, 1e12, 1.0, device_kind="cpu") == {}

    class Program:
        def cost_analysis(self):
            return {"flops": peak * 0.1}

    assert utils.mfu(Program(), 1.0, device_kind=kind) == \
        pytest.approx(10.0)


def test_step_timer_extension():
    timer = utils.StepTimer(trigger=(2, "iteration"))

    class T:
        iteration = 0
        optimizer = None

    tr = T()
    for it in (2, 4):
        tr.iteration = it
        timer.extension(tr)
    assert len(timer.rates) == 2 and all(r > 0 for r in timer.rates)


# -------------------------------------------------------------- the export
def test_mlp_round_trip_matches_jax(tmp_path):
    from chainermn_tpu_torch.utils import mlp_params_from_flax

    jm = JaxMLP(hidden=(16,), n_out=4)
    x = np.random.RandomState(0).normal(size=(8, 6)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), x[:1])["params"]
    want = np.asarray(jm.apply({"params": params}, x))
    model = MLP(hidden=(16,), n_out=4, in_features=6, device="cpu")
    model.load_state_dict(mlp_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    blob = export_forward(model, torch.zeros(8, 6))
    assert isinstance(blob, bytes) and len(blob) > 100
    got = load_forward(blob)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    path = save_forward(str(tmp_path / "mlp.pt2"), model, torch.zeros(8, 6))
    got2 = load_forward_file(path)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got2, want, rtol=1e-5, atol=1e-6)
    assert not os.path.exists(path + ".tmp")


def test_exported_shape_is_fixed():
    model = MLP(hidden=(8,), n_out=2, in_features=3, device="cpu")
    restored = load_forward(export_forward(lambda t: model(t),
                                           torch.zeros(4, 3)))
    with pytest.raises(Exception):
        restored(torch.zeros(5, 3))


def test_vit_round_trip():
    from chainermn_tpu_torch.models import ViT

    model = ViT(num_classes=10, patch=8, d_model=32, n_heads=2, d_ff=64,
                n_layers=1, dtype=torch.float32, attention="xla",
                image_size=16, device="cpu").eval()
    x = torch.from_numpy(np.random.RandomState(1).normal(
        size=(2, 16, 16, 3)).astype(np.float32))
    with torch.no_grad():
        want = model(x)
    got = load_forward(export_forward(lambda t: model(t), x))(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_poly_batch_export_serves_any_batch():
    model = MLP(hidden=(8,), n_out=3, in_features=5, device="cpu")
    restored = load_forward(export_forward(lambda t: model(t),
                                           torch.zeros(4, 5),
                                           poly_batch=True))
    rng = np.random.RandomState(7)
    for b in (1, 4, 13):
        x = torch.from_numpy(rng.normal(size=(b, 5)).astype(np.float32))
        with torch.no_grad():
            torch.testing.assert_close(restored(x), model(x), rtol=0,
                                       atol=1e-6)


def test_export_refuses_a_forward_that_reaches_a_kernel():
    from chainermn_tpu_torch.ops.flash_attention import flash_attention_fwd

    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(Exception, match="cannot be exported"):
        export_forward(lambda t: flash_attention_fwd(t, t, t)[0], q)


def test_export_serving_example(tmp_path):
    from chainermn_tpu_torch.examples import export_serving

    res = export_serving.main(["--device", "cpu", "--steps", "4",
                               "--out", str(tmp_path / "m.pt2")])
    assert res["bytes"] > 100 and 0.0 <= res["accuracy"] <= 1.0
