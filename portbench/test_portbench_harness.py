"""CPU tests of the benchmark harness: that it finds what ``BENCHMARK.json``
names, that its traffic and its counts are what they say, that its result
line has the keys its readers take, and that no run loads JAX.

Run from the repo's root: ``python -m pytest portbench -q``.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import cell as cell_mod
from portbench import generate, judge, roofline, tiny
from portbench.families import gpt2, resnet
from portbench.run import FORBIDDEN, result_line
from portbench.trace import reduce_profile, spin_window

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
SERVE = [w for w in WORKLOADS if ".serve." in w]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_is_found_by_name(workload):
    c = cell_mod.find(workload)
    assert c.config["name"] == [w for w in BENCH["workloads"]
                                if w["name"] == workload][0]["config"]
    assert hasattr(c.driver, "run") and hasattr(c.family, "weight_specs")
    assert {m["name"] for m in c.per_layer} == set(c.readers)
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    # Every number the cell's comparison reads has a limit (or a
    # deliberate null) in the cell's limits file.
    assert c.limits, f"no limits/{workload}.json"


def test_every_file_the_benchmark_names_exists():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
    for m in BENCH["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for w in BENCH["workloads"]:
        assert (ROOT / "portbench" / "traffic" /
                f"{w['traffic']}.json").is_file()


@pytest.mark.parametrize("workload", SERVE)
def test_traffic_repeats_from_a_seed_and_differs_across_seeds(workload):
    t = cell_mod.find(workload).traffic
    a = generate.Requests(t, 2 ** 33 + 1, 50257)
    b = generate.Requests(t, 2 ** 33 + 1, 50257)
    c = generate.Requests(t, 7, 50257)
    n = len(a.order)
    assert a.order == b.order
    assert all(a.request(k) == b.request(k) for k in range(n))
    assert a.order != c.order
    assert all(a.request(k)[0] != c.request(k)[0] for k in range(8))
    # Every seed sends the same sizes, round by round, in another order.
    r = t["round"]
    for lo in range(0, len(a.order), r):
        assert sorted(a.order[lo:lo + r]) == sorted(c.order[lo:lo + r])


@pytest.mark.parametrize("workload", SERVE)
def test_prompt_and_output_fit_the_positions(workload):
    t = cell_mod.find(workload).traffic
    sizes = generate.sizes(t)
    assert max(p + o for p, o in sizes) <= t["max_total"]
    assert t["max_total"] <= t["engine"]["positions_per_slot"]
    assert min(o for _, o in sizes) >= 1
    # Both lengths are the published medians times one factor: the
    # ratio of prompt to output is the trace's.
    p = np.array([s[0] for s in sizes])
    o = np.array([s[1] for s in sizes])
    for got, spec in ((p, t["prompt"]), (o, t["output"])):
        want = spec["median"] * t["scale"]
        assert abs(np.median(got) - want) <= 0.02 * want


def test_flash_bounds_by_hand():
    # B=1, T=2, H=1, D=4: 3 admitted pairs; x = 2*1*4*2 = 16 bytes; one
    # fp32 row vector = 8 bytes.
    b = roofline.flash_bounds(1, 2, 1, 4)
    ops = {"fwd": 4 * 4 * 3, "bwd_dkv": 8 * 4 * 3, "bwd_dq": 6 * 4 * 3}
    nbytes = {"fwd": 4 * 16 + 8, "bwd_dkv": 6 * 16 + 16,
              "bwd_dq": 5 * 16 + 16}
    for k in ops:
        want = max(nbytes[k] / roofline.HBM_BYTES_PER_S,
                   ops[k] / roofline.PEAK_OPS["bfloat16"])
        assert b[k][0] == pytest.approx(want)


def test_paged_decode_bound_by_hand():
    # 2 slots, one live attending 20 positions; H = KH = 1, Dh 8, block 16.
    t, which = roofline.paged_decode_bound([20], 2, 1, 1, 8, 16)
    nbytes = 2 * 20 * 8 * 2 + 4 * 2 + 2 * 2 * 8 * 2 + 4 * 2
    assert which == "bytes"
    assert t == pytest.approx(nbytes / roofline.HBM_BYTES_PER_S)


def test_resnet_flops_by_hand():
    cfg = dict(stage_sizes=[1], width=2, expansion=4, num_classes=3,
               image_size=8, in_channels=1)
    # stem 7x7/2: 8 -> 4, pool -> 2; one block at 2x2: conv0 1x1 2->2,
    # conv1 3x3 2->2, conv2 1x1 2->8, proj 1x1 2->8; head 8 -> 3.
    fwd = 2 * (2 * 1 * 49 * 16 + 2 * 2 * 1 * 4 + 2 * 2 * 9 * 4
               + 8 * 2 * 1 * 4 + 8 * 2 * 1 * 4) + 2 * 8 * 3
    assert resnet.forward_flops_per_image(cfg) == fwd
    stem = 2 * 2 * 1 * 49 * 16
    assert resnet.train_flops_per_step(cfg, {"batch": 5}) == 5 * (3 * fwd
                                                                 - stem)


def test_resnet50_forward_is_its_published_size():
    cfg = cell_mod.find("resnet50.train.b256").config
    assert resnet.forward_flops_per_image(cfg) / 2 == pytest.approx(
        4.09e9, rel=0.01)
    n = sum(math.prod(s[1]) for s in resnet.weight_specs(cfg))
    assert n == pytest.approx(25.557e6, rel=1e-3)


def test_gpt2_flops_by_hand():
    cfg = dict(n_layer=2, n_embd=4, n_head=2, n_inner=None, vocab_size=10,
               n_positions=8, layer_norm_epsilon=1e-5)
    mm = 2 * (4 * 16 + 2 * 4 * 16) + 10 * 4
    assert gpt2.matmul_params(cfg) == mm
    pairs = 3 * 4 // 2
    attn = 3 * 4 * 2 * 2 * 5 * pairs * 2
    assert gpt2.train_flops_per_step(cfg, {"batch": 5, "seq_len": 3}) == \
        6 * mm * 5 * 3 + attn


def test_gpt2_xl_is_its_published_size():
    cfg = cell_mod.find("gpt2-xl.train.s1024-b16").config
    n = sum(math.prod(s[1]) for s in gpt2.weight_specs(cfg))
    # 1,557.6 M published (tied head) + the untied head and its bias.
    assert n == 1_557_611_200 + 50257 * 1600 + 50257


def test_serving_model_flops_by_hand():
    from portbench.drivers.serve_closed import model_flops

    cfg = dict(n_layer=1, n_embd=4, n_head=2, n_inner=None, vocab_size=10,
               n_positions=8, layer_norm_epsilon=1e-5)
    body, head = 2 * (4 * 16 + 2 * 4 * 16), 2 * 4 * 10
    attn = 4 * 2 * 2
    # A final prefill chunk of 3 tokens from 0; a decode step of two
    # slots attending 4 and 6 positions; one step outside the window.
    got = model_flops(cfg, gpt2, [(1.0, [4, 6]), (9.0, [5])],
                      [(0.5, 0, 0, 3, True)], 0.0, 2.0)
    assert got == (body * 3 + attn * 6 + head) + (2 * (body + head)
                                                  + attn * 10)


def test_profile_reduction_by_hand():
    dev = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("k1", 40.0, 50.0),
           ("spin_kernel", 60.0, 70.0)]
    host = [("tick", 0.0, 100.0), ("aten::copy_", 21.0, 30.0)]
    r = reduce_profile(dev, host, (0.0, 60.0))
    assert r["busy_s"] == pytest.approx(30e-6)
    assert r["window_s"] == pytest.approx(60e-6)
    assert r["kernels"]["k1"] == (pytest.approx(20e-6), 2)
    assert r["idle"]["aten::copy_"] == pytest.approx(20e-6)
    assert r["idle"]["tick"] == pytest.approx(10e-6)


def test_device_profile_stretch_lies_between_the_spins():
    # A profile of the device alone has no host span: the stretch runs
    # from the last lead spin kernel to the first trailing one.
    dev = [("spin_kernel", 0.0, 5.0), ("spin_kernel", 5.0, 10.0),
           ("k1", 12.0, 20.0), ("k2", 30.0, 40.0),
           ("spin_kernel", 45.0, 50.0), ("spin_kernel", 50.0, 55.0)]
    assert spin_window(dev) == (10.0, 45.0)
    r = reduce_profile(dev, [], spin_window(dev))
    assert r["busy_s"] == pytest.approx(18e-6)
    assert r["window_s"] == pytest.approx(35e-6)
    assert spin_window([("spin_kernel", 0.0, 5.0)]) is None
    assert spin_window(dev[2:]) is None


def test_train_numbers_take_the_worst_leaf_and_leave_out_nought():
    ref = {"losses": [2.0, 1.0], "grad": {"a": 1.0, "b": 2.0, "c": 1e-9},
           "delta": {"a": 1.0, "b": 1.0, "c": 0.0}}
    prog = {"losses": [2.0, 1.1], "grad": {"a": 1.1, "b": 2.0, "c": 0.0},
            "delta": {"a": 1.0, "b": 1.5, "c": 5.0}}
    n = judge.train_numbers(prog, ref)
    assert n["loss_gap"] == pytest.approx(0.1)
    assert n["grad_gap"] == pytest.approx(0.1)
    assert n["delta_gap"] == pytest.approx(0.5)
    assert n["where"]["left_out"] == ["c"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_its_keys_in_order(trace):
    c = cell_mod.find(WORKLOADS[0])
    rec = {"e2e": {m["name"]: 1.0 for m in c.end_to_end},
           "numbers": {k: 0.0 for k in c.limits}, "attempted": 3,
           "failed": 0, "kind": "none"}
    if trace:
        rec["trace"] = reduce_profile([("k", 0.0, 1.0)], [], (0.0, 2.0))
    out, _ = result_line(c, rec, trace, {"platform": "gpu"})
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}


def test_a_cell_without_limits_is_never_correct():
    ok, checks = judge.verdict({"loss_gap": 0.0}, {})
    assert not ok and checks["loss_gap"]["limit"] is None


def _modules_of_a_run(workload):
    code = (
        "import sys, json, os\n"
        "os.environ['CMN_OBS'] = '1'\n"
        "from portbench import run, calibrate, tiny\n"
        "from portbench.cell import find\n"
        f"c = find({workload!r})\n"
        "import chainermn_tpu_torch.models, chainermn_tpu_torch.serving\n"
        "import chainermn_tpu_torch.optimizers, chainermn_tpu_torch.comm\n"
        "import chainermn_tpu_torch.observability.tracing\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CMN_OBS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_no_run_loads_jax_or_the_jax_package(workload):
    tops = _modules_of_a_run(workload)
    assert "chainermn_tpu_torch" in tops and "portbench" in tops
    assert not tops & set(FORBIDDEN)


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", WORKLOADS[0],
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_run_beside_no_program_exits_nonzero(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", WORKLOADS[0],
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "chainermn_tpu_torch" in out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_tiny_run_on_the_cpu_is_correct(workload):
    cell, rec = tiny.cpu_run(workload)
    ok, checks = judge.verdict(rec["numbers"], cell.limits)
    assert ok, checks
    assert rec["attempted"] > 0 and rec["failed"] == 0
    for m in cell.end_to_end:
        assert rec["e2e"][m["name"]] > 0
