"""The PyTorch port's host side against the JAX package.

Image preparation (scan, hybrid rewrite, trampolines, decode), the op-spec
table, HookConfig and the census definition in ``chip_smoke.py`` must equal
the JAX package's exactly; and the port must never import JAX or
``repro``.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import HookConfig as JHookConfig
from repro.core import Mechanism as JMechanism
from repro.core import opspec as jopspec
from repro.core import prepare as jprepare
from repro.core import programs as jprograms

from repro_torch.core import HookConfig, Mechanism, opspec, prepare, programs

ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_never_imports_jax_or_repro():
    """A fresh interpreter imports every repro_torch module (and the chip
    smoke script); neither jax nor any repro module may load."""
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch")
                                  .with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import importlib, importlib.util, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 20, mods
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# the builders of tests/test_fleet_parity.py's PROGS and the five census
# *_param workloads, by name so each package builds its own
BUILDERS = {
    "getpid": lambda p: p.getpid_loop(20),
    "read": lambda p: p.read_loop(4, 256),
    "mixed": lambda p: p.mixed_ops(3, 128),
    "io_bw": lambda p: p.io_bandwidth(3, 4096),
    "retry": lambda p: p.retry_loop(2),
    "caller_x8": lambda p: p.caller_x8(3),
    "getpid_param": lambda p: p.getpid_loop_param(),
    "read_param": lambda p: p.read_loop_param(1024),
    "mixed_param": lambda p: p.mixed_ops_param(512),
    "io_bw_param": lambda p: p.io_bandwidth_param(4096),
    "churn_param": lambda p: p.file_churn_param(512),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_prepare_matches_jax(name):
    """Every mechanism x virtualize: identical code words, decode tables,
    rewrite report, entry and signal handler."""
    for mech in Mechanism:
        for virt in (False, True):
            cfg = HookConfig(emul_enabled=False)
            t = prepare(BUILDERS[name](programs), mech, virtualize=virt,
                        cfg=cfg)
            j = jprepare(BUILDERS[name](jprograms), JMechanism(mech.value),
                         virtualize=virt,
                         cfg=JHookConfig(emul_enabled=False))
            key = (name, mech.value, virt)
            assert np.array_equal(t.image.words, j.image.words), key
            assert [dataclasses.astuple(s) for s in t.image.sections] == \
                [dataclasses.astuple(s) for s in j.image.sections], key
            for f in t.decoded._fields:
                a = getattr(t.decoded, f).numpy()
                b = np.asarray(getattr(j.decoded, f))
                assert a.dtype == b.dtype and np.array_equal(a, b), (key, f)
            assert (t.entry, t.sig_handler) == (j.entry, j.sig_handler), key
            if j.report is None:
                assert t.report is None, key
            else:
                assert dataclasses.asdict(t.report) == \
                    dataclasses.asdict(j.report), key


def test_opspec_tables_match_jax():
    """The 13 spec columns (values and dtypes, numpy and on a device) and
    the syscall rows equal the JAX package's."""
    for f in opspec.SpecTables._fields:
        a = getattr(opspec.TABLES_NP, f)
        b = np.asarray(getattr(jopspec.TABLES, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f
        t = getattr(opspec.spec_tables("cpu"), f)
        assert np.array_equal(t.numpy(), b) and t.numpy().dtype == b.dtype
    assert [dataclasses.astuple(s) for s in opspec.SYSCALLS] == \
        [dataclasses.astuple(s) for s in jopspec.SYSCALLS]
    assert opspec.TRACE_SYS == jopspec.TRACE_SYS
    assert np.array_equal(opspec.SYS_NR_NP, [s.nr for s in jopspec.SYSCALLS])


def test_cond_holds_matches_jax():
    nzcv, cond = np.meshgrid(np.arange(-3, 20), np.arange(0, 16))
    want = np.asarray(jopspec.cond_holds(nzcv.ravel(), cond.ravel()))
    got = opspec.cond_holds(torch.from_numpy(nzcv.ravel()),
                            torch.from_numpy(cond.ravel()),
                            opspec.spec_tables("cpu").COND_MASK)
    assert np.array_equal(got.numpy(), want)


def test_hookconfig_json_round_trips_across_packages(tmp_path):
    """Same fields and defaults; a config saved by either package loads in
    the other unchanged."""
    assert [f.name for f in dataclasses.fields(HookConfig)] == \
        [f.name for f in dataclasses.fields(JHookConfig)]
    assert HookConfig().to_dict() == JHookConfig().to_dict()
    jc = JHookConfig(emul_enabled=False, fleet_engine="pallas",
                     fleet_chunk=128)
    jc.pin(lib="libc.so", offset=8)
    jc.save(tmp_path / "j.json")
    tc = HookConfig.load(tmp_path / "j.json")
    assert tc.to_dict() == jc.to_dict()
    tc.save(tmp_path / "t.json")
    assert JHookConfig.load(tmp_path / "t.json").to_dict() == jc.to_dict()


def test_census_grid_copy_matches_benchmark():
    """chip_smoke.py's copy of the census deployment equals the
    benchmark's."""
    bench = _load("_bench_census",
                  ROOT / "benchmarks" / "collective_hook_overhead.py")
    smoke = _load("_chip_smoke", ROOT / "chip_smoke.py")
    want = [(m, mech.value, v, w, n) for m, mech, v, w, n in
            bench.census_grid()]
    got = [(m, mech.value, v, w, n) for m, mech, v, w, n in
           smoke.census_grid()]
    assert got == want and len(got) == 500
    assert smoke._BASE_ITERS == bench._BASE_ITERS
    assert smoke.SCALES == bench.SCALES
    assert list(smoke.WORKLOADS) == list(bench.WORKLOADS)
    assert [(m, mech.value, v) for m, mech, v in smoke.MECHS] == \
        [(m, mech.value, v) for m, mech, v in bench.MECHS]
    assert smoke.FUEL == bench.FUEL
