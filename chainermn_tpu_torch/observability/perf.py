"""Perf-regression sentinel of the port
(``chainermn_tpu/observability/perf.py``): the bench trajectory, guarded
offline.

    python -m chainermn_tpu_torch.observability.perf [--json] [--result-dir D] [--platform gpu]

It reads every headline-shaped artifact (a dict with a top-level
``metric`` + numeric ``value`` and a measured ``platform``: ``tpu`` or
``gpu``), groups them into **series** of like-for-like captures (same
metric, same platform and device kind, same config discriminator — a
card's capture is never judged against a TPU history, a batch-512 run
never against a batch-256 one), establishes a per-series noise band, and
renders a verdict:

* ``green`` — every series' newest capture sits inside its band;
* ``regressed(metric, magnitude, first-bad artifact)`` — a series'
  newest capture left the band in the bad direction; ``first_bad`` names
  the EARLIEST artifact of the trailing out-of-band run (where the slide
  started, not where it was noticed).

The noise band is ``max(CMN_PERF_NOISE_PCT, observed history spread)``
relative to the baseline (median of the pre-newest samples): seconds-long
captures on a shared host swing several percent pass-to-pass (the
obs-A/B pair methodology quantified ±9–33 % per pair, 0.02 % at the
36-pair median), so a fixed percent floor without the observed-spread
fold would page on noise.  Direction is metric-aware: throughput-like
metrics regress DOWN, latency/overhead-like metrics (``*_ms``,
``*overhead*``, ``*latency*``) regress UP.

:func:`sentinel` is the compact verdict a bench folds into its summary
line; a live payload joins its own series before judging (the freshest
sample is the one most worth guarding).  ``platform=`` restricts the
scan to one platform's series.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

#: Noise-band floor, percent — ``CMN_PERF_NOISE_PCT``.
DEFAULT_NOISE_PCT = 5.0

#: Platforms whose artifacts are measurements (a forced-CPU plumbing run,
#: a ``"tpu (cached ...)"`` re-emit or a failed probe is not).
MEASURED_PLATFORMS = ("tpu", "gpu")

#: Top-level artifact fields that discriminate configurations within one
#: metric (missing fields simply don't contribute): two artifacts join
#: the same series only when ALL of these agree.
DISCRIMINATOR_KEYS = (
    "platform", "unit", "device_kind", "n_devices",
    # resnet/vit family (bench.py payloads)
    "global_batch", "per_chip_batch", "image_size", "stem", "vit_variant",
    "optimizer", "bn", "conv1", "maxpool", "accum_steps",
    # decode / serving / lm families
    "config", "batch", "prompt", "n_new", "capacity",
)

#: Metric-name fragments that mean "lower is better".
_LOWER_BETTER = ("overhead", "latency", "_ms", "step_time", "wait")


def _noise_pct() -> float:
    try:
        return float(os.environ.get("CMN_PERF_NOISE_PCT",
                                    str(DEFAULT_NOISE_PCT)))
    except ValueError:
        return DEFAULT_NOISE_PCT


def direction(metric: str) -> str:
    """``"higher"`` (throughput-like) or ``"lower"`` (latency-like)."""
    m = metric.lower()
    return "lower" if any(t in m for t in _LOWER_BETTER) else "higher"


def _parse_when(rec: dict, path: str) -> Optional[float]:
    """Sample order key: the embedded ``measured_at`` capture stamp
    (UTC — the trailing ``Z`` means ``timegm``, not local ``mktime``),
    or ``None`` for stamp-less artifacts.  File mtime is deliberately
    NOT a fallback ordering signal: a fresh ``git clone`` resets every
    mtime to checkout time, which would crown an arbitrary old artifact
    as the series' "newest" judged sample — unstamped history still
    counts toward the baseline/spread, it just can never be the sample
    under judgment while any stamped one exists."""
    import calendar

    stamp = rec.get("measured_at")
    if isinstance(stamp, str):
        for fmt in ("%Y-%m-%dT%H:%M:%SZ", "%Y-%m-%d"):
            try:
                return calendar.timegm(time.strptime(stamp, fmt))
            except ValueError:
                continue
    return None


def _series_key(rec: dict) -> str:
    disc = {
        k: rec[k] for k in DISCRIMINATOR_KEYS
        if rec.get(k) is not None
    }
    return json.dumps({"metric": rec["metric"], **disc}, sort_keys=True,
                      default=str)


def _measured(rec: dict, platform: Optional[str]) -> bool:
    p = rec.get("platform")
    return p in MEASURED_PLATFORMS and (platform is None or p == platform)


def load_history(result_dir: str,
                 platform: Optional[str] = None) -> Dict[str, List[dict]]:
    """Headline samples grouped into series (of ``platform`` only, when
    given).  Non-headline artifacts (traces, logs-as-json, probe records)
    are skipped by shape; the round-agnostic watcher copy
    ``bench_tpu_done.json`` is skipped by name (it duplicates whichever
    round artifact it mirrors — counting it twice would halve the
    apparent spread)."""
    series: Dict[str, List[dict]] = {}
    try:
        names = sorted(os.listdir(result_dir))
    except OSError:
        return series
    for name in names:
        if not name.endswith(".json") or name == "bench_tpu_done.json":
            continue
        path = os.path.join(result_dir, name)
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(rec, dict):
            continue
        metric, value = rec.get("metric"), rec.get("value")
        if not isinstance(metric, str) or \
                not isinstance(value, (int, float)) or value <= 0:
            continue
        if not _measured(rec, platform):
            continue
        series.setdefault(_series_key(rec), []).append({
            "file": name,
            "value": float(value),
            "metric": metric,
            "t": _parse_when(rec, path),
        })
    for samples in series.values():
        # Unstamped samples sort FIRST (filename-deterministic among
        # themselves) — see _parse_when for why they may contribute to
        # the baseline but never be the judged newest.
        samples.sort(key=lambda s: (
            s["t"] is not None, s["t"] or 0.0, s["file"]
        ))
    return series


def _median(vals: Sequence[float]) -> float:
    vs = sorted(vals)
    n = len(vs)
    return vs[n // 2] if n % 2 else 0.5 * (vs[n // 2 - 1] + vs[n // 2])


def judge_series(samples: List[dict],
                 noise_pct: Optional[float] = None) -> dict:
    """Verdict for one time-ordered series.

    Baseline = median of every sample but the newest; band =
    ``max(noise floor, spread of those baseline samples)``; the newest
    sample regresses when it leaves ``baseline ± band`` in the bad
    direction.  ``first_bad`` is the earliest sample of the trailing
    out-of-band run — the artifact where the slide began.
    """
    metric = samples[0]["metric"]
    higher = direction(metric) == "higher"
    out = {
        "metric": metric,
        "direction": "higher" if higher else "lower",
        "n_samples": len(samples),
    }
    if len(samples) < 2:
        out["status"] = "insufficient"
        return out
    floor = _noise_pct() if noise_pct is None else float(noise_pct)

    def bad(v: float, baseline: float, band: float) -> bool:
        d = 100.0 * (v - baseline) / baseline if baseline else 0.0
        return d < -band if higher else d > band

    # Pass 1 (noise floor only): find the trailing run of out-of-band
    # samples and EXCLUDE it from the baseline pool — a slide several
    # artifacts long would otherwise drag the baseline down with it and
    # inflate the "observed spread" until its own regression fit inside.
    prelim = _median([s["value"] for s in samples[:-1]])
    n_run = 0
    for s in reversed(samples):
        if not bad(s["value"], prelim, floor):
            break
        n_run += 1
    pool = samples[:len(samples) - max(n_run, 1)]
    if not pool:
        # Everything since sample 0 breaches: nothing clean to baseline
        # against — report against the full pre-newest pool.
        pool = samples[:-1]
    base_vals = [s["value"] for s in pool]
    baseline = _median(base_vals)
    spread = (
        100.0 * (max(base_vals) - min(base_vals)) / baseline
        if baseline else 0.0
    )
    band = max(floor, spread)
    newest = samples[-1]
    delta_pct = (
        100.0 * (newest["value"] - baseline) / baseline if baseline
        else 0.0
    )
    breached = bad(newest["value"], baseline, band)
    out.update({
        "baseline": round(baseline, 4),
        "newest": round(newest["value"], 4),
        "newest_file": newest["file"],
        "band_pct": round(band, 3),
        "delta_pct": round(delta_pct, 3),
        "status": "regressed" if breached else "green",
    })
    if breached:
        # Walk back through the trailing run still out-of-band at the
        # FINAL band: the earliest of it is where the regression landed.
        first_bad = newest
        for s in reversed(samples[:-1]):
            if not bad(s["value"], baseline, band):
                break
            first_bad = s
        out["first_bad"] = first_bad["file"]
        out["magnitude_pct"] = round(abs(delta_pct), 3)
    return out


def analyze(result_dir: str, live: Optional[dict] = None,
            noise_pct: Optional[float] = None,
            platform: Optional[str] = None) -> dict:
    """Full sentinel report over a result directory.

    ``live`` is an optional in-flight headline payload
    (``{"metric", "value", "platform", <discriminator fields>...}``): the
    value joins EXACTLY the series its :func:`_series_key` names, under
    the same gates as the history scan — its platform must be a bare
    measured one (a forced-CPU plumbing run or a ``"tpu (cached ...)"``
    re-emit is never judged) and ``cached`` must be falsy.  A config with
    no prior history forms a fresh singleton series (insufficient →
    green).
    """
    series = load_history(result_dir, platform)
    if live and isinstance(live.get("metric"), str) and \
            isinstance(live.get("value"), (int, float)) and \
            live["value"] > 0 and _measured(live, platform) and \
            not live.get("cached"):
        series.setdefault(_series_key(live), []).append({
            "file": "<live bench_summary>",
            "value": float(live["value"]),
            "metric": live["metric"],
            "t": float("inf"),  # the in-flight capture IS the newest
        })
    reports = [
        judge_series(samples, noise_pct=noise_pct)
        for samples in series.values()
    ]
    reports.sort(key=lambda r: (r["status"] != "regressed",
                                -r.get("magnitude_pct", 0.0),
                                r["metric"]))
    regressed = [r for r in reports if r["status"] == "regressed"]
    return {
        "verdict": "regressed" if regressed else "green",
        "result_dir": result_dir,
        "platform": platform,
        "series_total": len(reports),
        "series_judged": sum(
            1 for r in reports if r["status"] != "insufficient"
        ),
        "regressed": regressed,
        "series": reports,
    }


def sentinel(result_dir: Optional[str] = None,
             live: Optional[dict] = None,
             platform: Optional[str] = None) -> dict:
    """The compact verdict a bench folds into its summary line:
    ``{"verdict": "green", "series": N}`` or ``{"verdict": "regressed",
    "metric", "drop_pct", "first_bad"}`` (worst series only — the final
    line must stay inside the driver tail window)."""
    if result_dir is None:
        result_dir = default_result_dir()
    try:
        report = analyze(result_dir, live=live, platform=platform)
    except Exception as e:  # the sentinel must never sink the bench
        return {"verdict": "error", "error": f"{type(e).__name__}"[:40]}
    if report["verdict"] == "green":
        return {"verdict": "green", "series": report["series_judged"]}
    worst = report["regressed"][0]
    return {
        "verdict": "regressed",
        "metric": worst["metric"],
        "drop_pct": worst["magnitude_pct"],
        "first_bad": worst["first_bad"],
        "regressed_series": len(report["regressed"]),
    }


def default_result_dir() -> str:
    """``<repo>/result`` relative to this package."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)
        ))),
        "result",
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m chainermn_tpu_torch.observability.perf",
        description="Perf-regression sentinel over the result/*.json "
                    "artifact history.",
    )
    ap.add_argument("--result-dir", default=None,
                    help="artifact directory (default: the repo's "
                         "result/)")
    ap.add_argument("--noise-pct", type=float, default=None,
                    help="noise-band floor override "
                         "(default CMN_PERF_NOISE_PCT or "
                         f"{DEFAULT_NOISE_PCT})")
    ap.add_argument("--platform", default=None,
                    choices=MEASURED_PLATFORMS,
                    help="judge only this platform's series")
    ap.add_argument("--summary", default=None,
                    help="path to a live bench_summary JSON line to "
                         "fold in as the newest sample of its series")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report instead of "
                         "the table")
    args = ap.parse_args(argv)
    result_dir = args.result_dir or default_result_dir()
    live = None
    if args.summary:
        with open(args.summary) as f:
            live = json.load(f)
    report = analyze(result_dir, live=live, noise_pct=args.noise_pct,
                     platform=args.platform)
    if args.json:
        print(json.dumps(report))
        return 0
    print(f"{'status':<10} {'metric':<42} {'n':>3} {'baseline':>12} "
          f"{'newest':>12} {'band%':>7} {'delta%':>8}")
    for r in report["series"]:
        if r["status"] == "insufficient":
            print(f"{'—':<10} {r['metric']:<42} {r['n_samples']:>3} "
                  f"{'(single capture)':>12}")
            continue
        print(f"{r['status']:<10} {r['metric']:<42} {r['n_samples']:>3} "
              f"{r['baseline']:>12g} {r['newest']:>12g} "
              f"{r['band_pct']:>7g} {r['delta_pct']:>8g}")
    if report["verdict"] == "green":
        print(f"\nverdict: green ({report['series_judged']} series "
              f"judged, {report['series_total']} total)")
    else:
        worst = report["regressed"][0]
        print(f"\nverdict: REGRESSED — {worst['metric']} down "
              f"{worst['magnitude_pct']}% vs baseline "
              f"{worst['baseline']} (band {worst['band_pct']}%), "
              f"first bad artifact: {worst['first_bad']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
