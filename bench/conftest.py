"""The harness's own tests: small copies of the cells, made as files in a
throwaway benchmark folder, as a later change would add a cell."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (HERE.parent, HERE.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY_CENSUS = "asc-tiny.rate"
TINY_TRAIN = "qwen3-tiny.train-hooked"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


def tiny_census_config() -> dict:
    cfg = json.loads((HERE / "configs" / "asc-census.json").read_text())
    cfg["name"] = "asc-tiny"
    cfg["mechanisms"] = [["asc", True], ["ptrace", True]]
    cfg["programs"] = {k: cfg["programs"][k] for k in ("getpid", "churn")}
    cfg["base_iters"] = {p: {"asc": 2, "ptrace": 3} for p in cfg["programs"]}
    cfg["copies"], cfg["scales"] = 2, [1.0, 0.99]
    return cfg


def tiny_train_config() -> dict:
    cfg = json.loads((HERE / "configs" / "qwen3-1.7b.json").read_text())
    cfg.update(name="qwen3-tiny", hidden_size=64, intermediate_size=128,
               num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               num_hidden_layers=2, vocab_size=250)
    cfg["train"].update(seq_len=48, vocab_pad_multiple=16, loss_chunk=16)
    return cfg


# the tiny training cell's limits, from its own readings on the CPU (seeds
# 101-112 sound, 101-103 control and half batch): loss 6.1e-4 / 2.9e-3,
# first gradient 4.7e-3 / 2.6e-2, change 5.1e-3 / 8.6e-3 (lower / upper)
TINY_TRAIN_LIMITS = {"train.loss_gap": 1.35e-3, "train.grad_gap": 1.1e-2,
                     "train.change_gap": 7e-3}


def write_cell(root: Path, name: str, config: dict, base: str,
               limits: dict | None = None, **params) -> None:
    """A cell as files: ``configs/<config>.json`` and
    ``workloads/<name>.json`` (the traffic of ``base``'s cell, with
    ``params`` set over it)."""
    for d in ("configs", "workloads"):
        (root / d).mkdir(exist_ok=True)
    (root / "configs" / f"{config['name']}.json").write_text(
        json.dumps(config))
    wl = json.loads((HERE / "workloads" / f"{base}.json").read_text())
    wl.update(name=name, config=config["name"])
    if "sample_per_cell" in wl["params"]:
        wl["params"]["sample_per_cell"] = 2
    if limits is not None:
        wl["params"]["limits"] = limits
    wl["params"].update(params)
    (root / "workloads" / f"{name}.json").write_text(json.dumps(wl))


def tiny_spec(**more) -> dict:
    """BENCHMARK.json with the tiny cells, and any ``more`` (a new cell's
    name for the cell whose metrics it reports), added to its metrics'
    ``workloads``."""
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    twin = {"asc-census.rate": [TINY_CENSUS],
            "qwen3-1.7b.train-hooked": [TINY_TRAIN]}
    for new, base in more.items():
        twin[base] = twin[base] + [new]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [
                t for w in m["workloads"] for t in twin[w]]
    return spec


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("bench_tiny")
    shutil.copytree(HERE / "metrics", root / "metrics")
    write_cell(root, TINY_CENSUS, tiny_census_config(), "asc-census.rate")
    write_cell(root, TINY_TRAIN, tiny_train_config(),
               "qwen3-1.7b.train-hooked", TINY_TRAIN_LIMITS)
    return root


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card through the "
                    "command in bench/README.md)")
    return torch.device("cuda")
