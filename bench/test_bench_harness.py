"""The harness's files, its generator, its arithmetic and its result
line."""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import pytest

from bench import common, counts, traffic
from bench.conftest import HERE, TINY_CENSUS, TINY_TRAIN, tiny_spec

ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_file_the_spec_names_parses():
    for c in SPEC["configs"]:
        cfg = common.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
    names = {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        wl, cfg, drv = common.load_cell(w["name"])
        assert (wl["config"], wl["traffic"], wl["chips"], wl["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert wl["config"] in names and drv.Cell
    for m in SPEC["per_layer"]:
        assert callable(common.metric_reader(m["name"]))
    assert set(common.workload_names()) == {w["name"]
                                            for w in SPEC["workloads"]}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    want = common.cell_metrics(SPEC, cell)
    e2e = {m["name"] for m in want["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert want["per_layer"]
    assert all(m["moves"] in e2e for m in want["per_layer"])


def test_a_cell_added_as_files_is_listed(tiny_root):
    names = common.workload_names(tiny_root)
    assert {TINY_CENSUS, TINY_TRAIN} <= set(names)
    wl = common.load_workload(TINY_CENSUS, tiny_root)
    assert common.load_config(wl["config"], tiny_root)["kind"] == "census"


def test_a_cell_of_another_traffic_on_a_config_is_added_as_files(
        tiny_root, tmp_path):
    """The tiny training configuration's step without the hook and under
    the compressing hook: two cells added as workload files alone, each
    run to a correct result; the hook's counter reads only where a hook
    runs."""
    import shutil
    from bench import run
    from bench.conftest import write_cell, tiny_train_config, \
        TINY_TRAIN_LIMITS
    root = tmp_path / "bench"
    shutil.copytree(tiny_root, root)
    more = {}
    for hook in ("none", "compress"):
        name = f"qwen3-tiny.train-{hook}"
        write_cell(root, name, tiny_train_config(),
                   "qwen3-1.7b.train-hooked", TINY_TRAIN_LIMITS, hook=hook)
        more[name] = "qwen3-1.7b.train-hooked"
    assert set(more) <= set(common.workload_names(root))
    spec = tiny_spec(**more)
    for name in more:
        res, checks = run.run_cell(name, 2**31 + 5, 0.0, True, device="cpu",
                                   spec=spec, root=root)
        assert res["correct"], checks
        assert ("hook.ops_per_step" in res["metrics"]) == (
            not name.endswith("none"))


@pytest.mark.parametrize("params", [
    {"loop": "closed"},          # a key no driver reads
    {"hook": "rsag"},            # a hook the driver does not run
    {"checked_steps": 0},
])
def test_a_cell_whose_params_the_driver_does_not_take_is_refused(
        tmp_path, params):
    from bench.conftest import write_cell, tiny_train_config
    write_cell(tmp_path, "bad.cell", tiny_train_config(),
               "qwen3-1.7b.train-hooked", **params)
    with pytest.raises(SystemExit, match="params"):
        common.load_cell("bad.cell", tmp_path)


def test_a_cell_missing_a_param_is_refused(tmp_path):
    from bench.conftest import write_cell, tiny_census_config
    write_cell(tmp_path, "bad.cell", tiny_census_config(),
               "asc-census.rate")
    wl = json.loads((tmp_path / "workloads" / "bad.cell.json").read_text())
    del wl["params"]["sample_per_cell"]
    (tmp_path / "workloads" / "bad.cell.json").write_text(json.dumps(wl))
    with pytest.raises(SystemExit, match="missing"):
        common.load_cell("bad.cell", tmp_path)


def test_census_traffic_is_the_same_for_a_seed_and_the_work_for_any():
    cfg = common.load_config("asc-census")
    seed = 2**31 + 12345
    a, b = traffic.census_lanes(cfg, seed), traffic.census_lanes(cfg, seed)
    assert a == b and len(a) == 4000
    c = traffic.census_lanes(cfg, seed + 1)
    assert a != c
    # another seed deals the same counts in another order
    assert sorted(a) == sorted(c)
    # each copy holds the census's own grid: 20 counts a cell
    grid = sorted(max(2, int(cfg["base_iters"][p][m]
                              * round(1.0 - 0.01 * i, 2)))
                  for m, _, p in traffic.census_cells(cfg)
                  for i in range(20))
    for k in range(8):
        assert sorted(ln.iters for ln in a[k * 500:(k + 1) * 500]) == grid
    s = traffic.census_sample(cfg, a, seed, 4)
    assert s == traffic.census_sample(cfg, a, seed, 4) and len(s) == 100
    per_cell = {}
    for i in s:
        per_cell.setdefault((a[i].mechanism, a[i].program), []).append(i)
    assert len(per_cell) == 25 and all(len(v) == 4 for v in per_cell.values())


def test_token_and_parameter_seeds_repeat():
    import torch
    from bench.drivers import train
    cfg = common.load_config("qwen3-1.7b")
    assert traffic.token_seed(7) == traffic.token_seed(7) != \
        traffic.token_seed(8)
    small = dict(cfg, num_hidden_layers=1, hidden_size=8,
                 intermediate_size=8, num_attention_heads=2,
                 num_key_value_heads=1, head_dim=4, vocab_size=30)
    t = dict(cfg["train"], vocab_pad_multiple=16)
    x = train.make_leaf(small, t, 2**32 + 5, "wq", "cpu")
    assert torch.equal(x, train.make_leaf(small, t, 2**32 + 5, "wq", "cpu"))
    assert not torch.equal(x, train.make_leaf(small, t, 2**32 + 6, "wq",
                                              "cpu"))


def test_census_bytes_at_a_small_size():
    # 2 lanes, 10 code words, 100 stream bytes, 7 payload bytes
    assert counts.census_bytes(lanes=2, code_words=10, stream_bytes=100,
                               emul_payload=7) == (
        2 * 8 * 2 * 173 + 2 * 4 + 160 + 100 + 14)


def test_train_flops_palm_convention():
    c = {"hidden_size": 4, "intermediate_size": 6, "head_dim": 2,
         "num_attention_heads": 2, "num_key_value_heads": 1,
         "num_hidden_layers": 3, "vocab_size": 10}
    # q, o: 4*2*2 each; k, v: 4*1*2 each; mlp 3*4*6; head 10*4
    n = 3 * (16 + 16 + 8 + 8 + 72) + 40
    assert counts.qwen3_matmul_params(c) == n
    assert counts.train_flops(params_in_matmuls=n, layers=3, heads=2,
                              head_dim=2, seq_len=5, tokens=10) == (
        6 * n * 10 + 12 * 3 * 2 * 2 * 5 * 10)
    full = common.load_config("qwen3-1.7b")
    p = counts.qwen3_matmul_params(full)
    assert 1.6e9 < p < 1.8e9   # Qwen3-1.7B: ~1.7 B parameters


def test_result_line_format():
    line = common.result_line(
        correct=True, attempted=3, failed=0,
        metrics={"setup_s": common.metric_entry(1.5, "s")},
        device={"platform": "gpu", "kind": "x", "count": 1,
                "memory_peak_bytes": 1},
        checks=[common.check("a", 0, 0)],
        breakdown={"device_ops": [["k", 0.1]], "idle_gaps": []})
    obj = json.loads(line)
    assert list(obj) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert obj["checks"] == [{"name": "a", "value": 0, "limit": 0,
                              "ok": True}]
    with pytest.raises(ValueError):
        common.metric_entry(math.nan, "s")


def test_forbidden_names_are_whole_top_level_names():
    assert common.forbidden_loaded({"repro_torch.core": 1, "reproduce": 1,
                                    "jaxtyping": 1, "benchmarks_x": 1}) == []
    assert common.forbidden_loaded({"repro.core": 1, "jax": 1,
                                    "scripts.x": 1}) == [
        "jax", "repro", "scripts"]


def test_a_run_loads_no_forbidden_module(tiny_root):
    """A whole run of the tiny census, and the import of everything the
    training driver loads, in a fresh process."""
    code = (
        "import sys, json\n"
        "from pathlib import Path\n"
        "from bench import run, common, calibrate, faults\n"
        "from bench.conftest import tiny_spec\n"
        "from bench.drivers import train\n"
        "import repro_torch.hooks, repro_torch.launch.mesh\n"
        "import repro_torch.train.step, repro_torch.optim.adamw\n"
        f"res, _ = run.run_cell({TINY_CENSUS!r}, 3, 0.0, False, "
        f"device='cpu', spec=tiny_spec(), root=Path({str(tiny_root)!r}))\n"
        "print(json.dumps([res['correct'], common.forbidden_loaded()]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]


def test_no_result_without_a_card(tmp_path):
    """Without CUDA the command prints no result and exits non-zero."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload", "asc-census.rate",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
