"""The port's megastep wrapper against the JAX package's megastep, on the CPU.

On CPU tensors the wrapper runs the plain PyTorch version, which must equal
one chunk of the JAX package's Pallas kernel (interpret mode) and of its
XLA reference, bit for bit on all 34 leaves.  The CUDA kernel itself runs
only on the card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold
it against the plain version there.  Here the wrapper's checks, the launch
counter and the kernel's C interface are tested.
"""
import ctypes
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HookConfig as JHookConfig
from repro.core import Mechanism as JMechanism
from repro.core import pack_fleet as jpack_fleet
from repro.core import prepare as jprepare
from repro.core import programs as jprograms
from repro.core.machine import MachineState as JMachineState
from repro.kernels.megastep import ops as jmops

from repro_torch.core import (HookConfig, Mechanism, interop, pack_fleet,
                              prepare, programs, run_fleet_prepared,
                              run_prepared)
from repro_torch.core.machine import MachineState
from repro_torch.kernels.megastep import kernel as mkernel
from repro_torch.kernels.megastep import ops as mops

ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("_chip_smoke_megastep", ROOT / "chip_smoke.py")


@pytest.fixture(scope="module")
def fleet25():
    """One lane per census image, from a seeded random state."""
    jcells, tcells = [], []
    for _, mech, virt in SMOKE.MECHS:
        for build in SMOKE.WORKLOADS.values():
            tcells.append(prepare(build(), mech, virtualize=virt,
                                  cfg=HookConfig(emul_enabled=False)))
    jw = {"getpid": jprograms.getpid_loop_param,
          "read": lambda: jprograms.read_loop_param(1024),
          "mixed": lambda: jprograms.mixed_ops_param(512),
          "io_bw": lambda: jprograms.io_bandwidth_param(4096),
          "churn": lambda: jprograms.file_churn_param(512)}
    for _, mech, virt in SMOKE.MECHS:
        for build in jw.values():
            jcells.append(jprepare(build(), JMechanism(mech.value),
                                   virtualize=virt,
                                   cfg=JHookConfig(emul_enabled=False)))
    regs = [{19: 3}] * len(jcells)
    jimgs, jids, js = jpack_fleet(jcells, fuel=100_000, regs=regs)
    leaves = {f: np.asarray(getattr(js, f)) for f in JMachineState._fields}
    leaves = SMOKE.scramble(leaves, SMOKE.code_of(tcells),
                            np.random.default_rng(11))
    timgs, tids, _ = pack_fleet(tcells, fuel=100_000, regs=regs,
                                device="cpu")
    return dict(jimgs=jimgs, jids=jnp.asarray(jids), leaves=leaves,
                timgs=timgs, tids=tids, pps=tcells)


def _tstate(leaves):
    return interop.state_from_numpy(leaves, "cpu")


@pytest.mark.parametrize("chunk", [1, 8])
def test_wrapper_matches_jax_megastep(fleet25, chunk):
    """One chunk: the port's wrapper (plain version on the CPU) equals the
    JAX Pallas kernel in interpret mode and the JAX XLA reference."""
    js = JMachineState(*(jnp.asarray(fleet25["leaves"][f])
                         for f in JMachineState._fields))
    got = mops.megastep_chunk(fleet25["timgs"], fleet25["tids"],
                              _tstate(fleet25["leaves"]), chunk=chunk)
    for impl in ("pallas", "ref"):
        want = jmops.megastep(fleet25["jimgs"], fleet25["jids"], js,
                              chunk=chunk, impl=impl, interpret=True)
        for f in MachineState._fields:
            assert np.array_equal(np.asarray(getattr(want, f)),
                                  getattr(got, f).numpy()), (impl, f)


def test_wrapper_updates_in_place_and_counts_no_launch_on_cpu(fleet25):
    mops.megastep_chunk.launches = 0
    s = _tstate(fleet25["leaves"])
    ptrs = [x.data_ptr() for x in s]
    out = mops.megastep_chunk(fleet25["timgs"], fleet25["tids"], s, chunk=4)
    assert out is s and [x.data_ptr() for x in s] == ptrs
    assert int(s.icount.sum()) > 0
    assert mops.megastep_chunk.launches == 0


def test_wrapper_rejects_bad_operands(fleet25):
    imgs, ids = fleet25["timgs"], fleet25["tids"]

    def call(s=None, imgs=imgs, ids=ids, **kw):
        s = _tstate(fleet25["leaves"]) if s is None else s
        return mops.megastep_chunk(imgs, ids, s, **{"chunk": 2, **kw})

    s = _tstate(fleet25["leaves"])
    with pytest.raises(TypeError, match="pc"):
        call(s._replace(pc=s.pc.to(torch.int32)))
    with pytest.raises(ValueError, match="regs"):
        call(s._replace(regs=s.regs[:, :30].contiguous()))
    with pytest.raises(ValueError, match="contiguous"):
        call(s._replace(mem=s.mem.t().contiguous().t()))
    with pytest.raises(ValueError, match="ids"):
        call(ids=ids.to("meta"))
    with pytest.raises(TypeError, match="ids"):
        call(ids=ids.long())
    with pytest.raises(ValueError, match="image rows"):
        call(ids=torch.full_like(ids, 99))
    with pytest.raises(ValueError, match="packed"):
        call(imgs=imgs._replace(packed=imgs.packed[:, :100].contiguous()))
    with pytest.raises(ValueError, match="chunk"):
        call(chunk=0)
    with pytest.raises(ValueError, match="block"):
        call(block=0)
    with pytest.raises(ValueError, match="batched"):
        call(MachineState(*(x[0] for x in s)))
    with pytest.raises(NotImplementedError, match="emul_enabled=False"):
        call(s._replace(k_enabled=torch.ones_like(s.k_enabled)))


def test_no_device_and_no_card_raises(monkeypatch):
    """Entry points default to the card and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pp = prepare(programs.getpid_loop(2), Mechanism.ASC, virtualize=True,
                 cfg=HookConfig(emul_enabled=False))
    for call in (lambda: run_fleet_prepared([pp]),
                 lambda: pack_fleet([pp]),
                 lambda: run_prepared(pp),
                 lambda: run_fleet_prepared([pp], device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert int(run_prepared(pp, device="cpu").halted) == 1


def test_kernel_c_interface_matches_wrapper():
    """The C struct in megastep.cu and the ctypes mirror agree field for
    field, and the generated header defines every constant the source
    uses (the CUDA source compiles only on the card's machine)."""
    src = mkernel.SOURCE.read_text()
    body = re.search(r"struct MegastepArgs \{(.*?)\};", src, re.S).group(1)
    c_fields = re.findall(r"\*\s*(\w+)(?:\[N_LEAVES\])?;|int64_t (\w+);",
                          body)
    c_names = [a or b for a, b in c_fields]
    assert c_names == [f[0] for f in mkernel._Args._fields_]
    assert ctypes.sizeof(mkernel._Args) == 8 * (19 + 34 + 2)
    header = mkernel.consts_header()
    defined = set(re.findall(r"#define (\w+)", header))
    code = re.sub(r"//[^\n]*", "", src)
    used = set(re.findall(r"\b[A-Z][A-Z0-9_]{2,}\b", code))
    assert used <= defined, sorted(used - defined)
    for i, f in enumerate(MachineState._fields):
        assert f"#define LEAF_{f} {i}\n" in header
