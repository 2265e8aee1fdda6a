"""The CUDA kernels against their plain PyTorch versions, on the card:
megastep, flash attention, flash-decode, the RG-LRU scan and the mLSTM,
the LM serving paths (attention-only, hybrid, xLSTM, MoE, patch prefix
and encoder-decoder), the fleet server's durable and chaos paths, lane
sharding on the cards there are, and training (the train step on the
card against the CPU's, the remat policies, the kernels' refusal of
inputs that require grad).

These tests need a CUDA card and skip without one (a skip is not a pass).
They import no JAX, so they run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` holds the kernels to the same standard at the full
census size and at qwen3-1.7b's, recurrentgemma-2b's and xlstm-350m's
full width.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (HookConfig, fleet, interop, layout as L,
                              pack_fleet, run_fleet_prepared)
from repro_torch.core.machine import MachineState
from repro_torch.core.runtime import fleet_trace
from repro_torch.configs import RunConfig, get_smoke
from repro_torch.kernels import nvcc
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.megastep import ops as mops
from repro_torch.kernels.megastep.ref import megastep_chunk_ref
from repro_torch.kernels.mlstm_chunk import kernel as xkernel
from repro_torch.kernels.mlstm_chunk import ops as xops
from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunk_ref,
                                                mlstm_decode_ref, mlstm_seq)
from repro_torch.kernels.rglru_scan import ops as rops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref, rglru_scan_seq
from repro_torch.models import lm
from repro_torch.models import recurrent as rec
from repro_torch.sched import PolicyScheduler, TenantBudget
from repro_torch.serve import durability as D
from repro_torch.serve.chaos import ChaosMonkey
from repro_torch.serve.durability import DurabilityManager
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.fleet_server import FleetServer
from repro_torch.trace import policy as tpolicy

ROOT = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.cuda


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("_chip_smoke_cuda", ROOT / "chip_smoke.py")
CONFIGS = {"emul_off": HookConfig(emul_enabled=False),
           "default": HookConfig()}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the kernel on the "
                    "H100)")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=list(CONFIGS))
def census_every_tenth(card, request):
    pps, regs = SMOKE.census_processes(CONFIGS[request.param])
    pps, regs = pps[::10], regs[::10]  # 50 lanes, all 25 images
    imgs, ids, s = pack_fleet(pps, fuel=SMOKE.FUEL, regs=regs, device=card)
    return pps, regs, imgs, ids, s


def _clone(tree):
    return type(tree)(*(x.clone() for x in tree))


def _to_cpu(tree):
    return type(tree)(*(x.cpu() for x in tree))


def _assert_equal(a, b, what):
    bad = [f for f, x, y in zip(a._fields, a, b) if not torch.equal(x, y)]
    assert not bad, f"{what}: leaves {bad}"


@pytest.mark.parametrize("chunk", [1, 8, 128])
@pytest.mark.parametrize("seed", [None, 0, 1])
def test_kernel_matches_plain(census_every_tenth, chunk, seed):
    """One chunk from the initial state and from seeded random states
    (random guest-kernel tables too when emulation is on), at 1, 3 and 4
    lanes a block (50 lanes: 3 and 4 leave a ragged last block)."""
    pps, _, imgs, ids, s0 = census_every_tenth
    if seed is not None:
        rng = np.random.default_rng(seed)
        code = SMOKE.code_of(pps)
        leaves = SMOKE.scramble(interop.state_to_numpy(s0), code, rng)
        if int(s0.k_enabled.sum()):
            leaves = SMOKE.scramble_kern(leaves, code, rng)
        s0 = interop.state_from_numpy(leaves, s0.pc.device)
    want = megastep_chunk_ref(imgs, ids, _clone(s0), chunk=chunk)
    for block in (1, 3, 4):
        got = mops.megastep_chunk(imgs, ids, _clone(s0), chunk=chunk,
                                  block=block)
        torch.cuda.synchronize()
        _assert_equal(want, got, f"chunk={chunk} seed={seed} block={block}")


@pytest.mark.parametrize("chunk", [1, 8, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_traced_kernel_matches_plain(census_every_tenth, chunk, seed):
    """Traced: random per-lane policies (DENY, EMULATE on emulated and other
    numbers, one KILL) on fresh rings, and a scrambled trace carry on a
    scrambled state; every MachineState and TraceState leaf."""
    pps, _, imgs, ids, s0 = census_every_tenth
    dev = s0.pc.device
    B = int(s0.pc.shape[0])
    rng = np.random.default_rng(seed)
    pols = SMOKE.random_policies(B, rng, kill_lane=3)
    tr0 = fleet_trace(pps, device=dev)
    if seed == 0:
        pa, pg = tpolicy.policy_rows(pols)
        tr0 = tr0._replace(pol_action=torch.from_numpy(pa).to(dev),
                           pol_arg=torch.from_numpy(pg).to(dev))
    else:
        code = SMOKE.code_of(pps)
        leaves = SMOKE.scramble(interop.state_to_numpy(s0), code, rng)
        if int(s0.k_enabled.sum()):
            leaves = SMOKE.scramble_kern(leaves, code, rng)
        s0 = interop.state_from_numpy(leaves, dev)
        tr0 = interop.trace_from_numpy(SMOKE.scramble_trace(
            B, int(tr0.buf.shape[2]), rng, pols), dev)
    want = megastep_chunk_ref(imgs, ids, _clone(s0), _clone(tr0), chunk=chunk)
    for block in (1, 3, 4):
        got = mops.megastep_chunk(imgs, ids, _clone(s0), _clone(tr0),
                                  chunk=chunk, block=block)
        torch.cuda.synchronize()
        for w, g in zip(want, got):
            _assert_equal(w, g, f"traced chunk={chunk} seed={seed} "
                                f"block={block}")


def test_kernel_on_more_lanes_than_schedulers(card):
    """1,000 lanes (the census twice, the second copy scrambled, random
    guest-kernel tables too): more warps than the card's 528 schedulers;
    one chunk of 128 steps at the default block, then 8 more at 3 lanes a
    block, equal to the plain version on every leaf."""
    pps, regs = SMOKE.census_processes()
    pps, regs = pps + pps, regs + regs
    imgs, ids, s0 = pack_fleet(pps, fuel=SMOKE.FUEL, regs=regs, device=card)
    leaves = interop.state_to_numpy(s0)
    rng = np.random.default_rng(7)
    code = SMOKE.code_of(pps)
    mixed = SMOKE.scramble_kern(SMOKE.scramble(leaves, code, rng), code, rng)
    half = len(pps) // 2
    for f in leaves:
        leaves[f] = np.concatenate([leaves[f][:half], mixed[f][half:]])
    s0 = interop.state_from_numpy(leaves, card)
    got = _clone(s0)
    for chunk, block in ((128, None), (8, 3)):
        want = megastep_chunk_ref(imgs, ids, _clone(got), chunk=chunk)
        got = mops.megastep_chunk(imgs, ids, got, chunk=chunk, block=block)
        torch.cuda.synchronize()
        _assert_equal(want, got, f"1000 lanes chunk={chunk} block={block}")


@pytest.mark.parametrize("traced", [False, True])
def test_two_kernel_calls_are_bit_equal(census_every_tenth, traced):
    """Two calls from one (scrambled) state give the same carry, bit for
    bit: no race between a lane's threads or between lanes."""
    pps, _, imgs, ids, s0 = census_every_tenth
    dev = s0.pc.device
    rng = np.random.default_rng(8)
    code = SMOKE.code_of(pps)
    leaves = SMOKE.scramble(interop.state_to_numpy(s0), code, rng)
    if int(s0.k_enabled.sum()):
        leaves = SMOKE.scramble_kern(leaves, code, rng)
    s0 = interop.state_from_numpy(leaves, dev)
    tr0 = None
    if traced:
        B = int(s0.pc.shape[0])
        tr0 = interop.trace_from_numpy(SMOKE.scramble_trace(
            B, 16, rng, SMOKE.random_policies(B, rng, kill_lane=2)), dev)
    outs = []
    for _ in range(2):
        out = mops.megastep_chunk(imgs, ids, _clone(s0),
                                  None if tr0 is None else _clone(tr0),
                                  chunk=128)
        torch.cuda.synchronize()
        outs.append(out if traced else (out,))
    for a, b in zip(*outs):
        _assert_equal(a, b, "two calls")


def test_run_on_card_matches_cpu(census_every_tenth, card):
    """The whole path to halt on the card equals the CPU path, and each
    chunk is one launch."""
    pps, regs = census_every_tenth[:2]
    pps, regs = pps[:10], [dict(r) for r in regs[:10]]
    for r in regs:
        r[19] = 3
    mops.megastep_chunk.launches = 0
    got = run_fleet_prepared(pps, fuel=SMOKE.FUEL, chunk=64, regs=regs,
                             device=card)
    launches = mops.megastep_chunk.launches
    want = run_fleet_prepared(pps, fuel=SMOKE.FUEL, chunk=64, regs=regs,
                              device="cpu")
    _assert_equal(want, MachineState(*(x.cpu() for x in got)), "run")
    assert launches == -(-int(want.icount.max()) // 64)


def test_traced_run_on_card_matches_cpu(census_every_tenth, card):
    """trace=True to halt on the card equals the CPU path, states and
    rings, with policy overrides on two lanes."""
    pps, regs = census_every_tenth[:2]
    pps, regs = pps[:10], [dict(r) for r in regs[:10]]
    for r in regs:
        r[19] = 3
    over = {1: [tpolicy.deny(-1, 13)], 4: [tpolicy.emulate(63, 8)]}
    got = run_fleet_prepared(pps, fuel=SMOKE.FUEL, chunk=32, regs=regs,
                             trace=True, policy_overrides=over, device=card)
    want = run_fleet_prepared(pps, fuel=SMOKE.FUEL, chunk=32, regs=regs,
                              trace=True, policy_overrides=over,
                              device="cpu")
    for w, g in zip(want, got):
        _assert_equal(w, type(g)(*(x.cpu() for x in g)), "traced run")
    assert int(want[1].deny_count[1]) > 0


# -- the census drivers: streamed harvest, compaction, admission -------------

def _small_census(census_every_tenth):
    pps, regs = census_every_tenth[:2]
    pps, regs = pps[:10], [dict(r) for r in regs[:10]]
    for r in regs:
        r[19] = 3
    return pps, regs


def _on_cpu(tree):
    return type(tree)(*(x.cpu() for x in tree))


def test_stream_on_card_matches_cpu(census_every_tenth, card):
    """run_fleet_stream on the card (cap 8, flips every 8 steps) equals the
    CPU path: states, carry, and every streamed record with its key,
    epoch and seq; each chunk one launch."""
    from repro_torch.trace import MemoryWriter, TraceStream, make_trace_state
    pps, regs = _small_census(census_every_tenth)
    outs = []
    for dev in (card, "cpu"):
        imgs, ids, s = pack_fleet(pps, fuel=SMOKE.FUEL, regs=regs,
                                  device=dev)
        sink = TraceStream([MemoryWriter()])
        mops.megastep_chunk.launches = 0
        got = fleet.run_fleet_stream(
            imgs, s, ids, chunk=8, stream=sink, device=dev,
            trace=make_trace_state(len(pps), 8, device=dev))
        outs.append((got, sink, mops.megastep_chunk.launches))
    (g, gsink, launches), (w, wsink, _) = outs
    _assert_equal(w[0], _on_cpu(g[0]), "streamed states")
    _assert_equal(w[1], _on_cpu(g[1]), "streamed carry")
    assert gsink.stats() == wsink.stats() and gsink.records_dropped == 0

    def recs(sink):
        return [(k, e, q, r.step, r.pc, r.nr, r.ret)
                for k, e, q, r in sink.writers[0].records]
    assert recs(gsink) == recs(wsink) and recs(gsink)
    assert launches == -(-int(w[0].icount.max()) // 8)


@pytest.mark.parametrize("traced", [False, True])
def test_compact_on_card_matches_cpu(census_every_tenth, card, traced):
    """run_fleet_compact on the card (min bucket 2) equals the CPU path,
    states, carry and occupancy ledger."""
    pps, regs = _small_census(census_every_tenth)
    outs = []
    for dev in (card, "cpu"):
        imgs, ids, s, tr = pack_fleet(pps, fuel=SMOKE.FUEL, regs=regs,
                                      trace=True, device=dev)
        stats = {}
        mops.megastep_chunk.launches = 0
        got = fleet.run_fleet_compact(imgs, s, ids, chunk=16, min_bucket=2,
                                      trace=tr if traced else None,
                                      stats=stats, device=dev)
        outs.append((got if traced else (got,), stats,
                     mops.megastep_chunk.launches))
    (g, gstats, launches), (w, wstats, _) = outs
    for a, b in zip(w, g):
        _assert_equal(a, _on_cpu(b), "compacted run")
    assert gstats == wstats and gstats["compactions"] and launches > 0


@pytest.mark.parametrize("traced", [False, True])
def test_admission_on_card_matches_cpu(census_every_tenth, card, traced):
    """chip_smoke.py's continuous-batching loop on the card (a 4-lane pool,
    a 6-row image table, preemption and restore) harvests every lane
    equal to the fixed-width CPU run's."""
    pps, regs = _small_census(census_every_tenth)
    mops.megastep_chunk.launches = 0
    out_s, out_t, stats = SMOKE.admission_run(
        pps, regs, pool=4, table_rows=6, steps=64, chunk=16, dev=card,
        traced=traced, preempt_every=2, preempt_n=2)
    assert mops.megastep_chunk.launches > 0
    want = run_fleet_prepared(pps, fuel=SMOKE.FUEL, chunk=16, regs=regs,
                              trace=traced, device="cpu")
    for a, b in zip(want, (out_s, out_t)) if traced else [(want, out_s)]:
        _assert_equal(a, _on_cpu(b), "admission")
    assert stats["preempted"] and stats["restored"] == stats["preempted"]


# -- attention kernels (tolerances: tests/test_kernels.py:26-27, by dtype) ----

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def _full_f32_products():
    """f32 matmuls in f32 (the plain versions), not TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SMOKE.FLASH_CASES, ids=str)
def test_flash_kernel_matches_plain(card, case, dtype):
    """bf16 through the tensor-core kernel, f32 through the SIMT kernel;
    ragged lengths, windows with dead rows, GQA/MQA, head dims 16-256; one
    counted launch per call."""
    q, k, v = SMOKE.flash_inputs(case, dtype, 0, card)
    want = fops.flash_attention_plain(q, k, v, causal=case[6],
                                      window=case[7])
    n0 = fops.flash_attention.launches
    got = fops.flash_attention(q, k, v, causal=case[6], window=case[7])
    torch.cuda.synchronize()
    assert fops.flash_attention.launches == n0 + 1
    err, n_over = SMOKE.over_bound(got, want, dtype)
    assert n_over == 0, f"max err {err}"


@pytest.mark.parametrize("hd", [128, 256])
def test_flash_bf16_instances_are_tensor_core_code(card, hd):
    """The main paths' bf16 instances (head dim 128: qwen3-1.7b; 256:
    recurrentgemma-2b) hold HGMMA (wgmma) in their SASS, without spills."""
    lib, report = fkernel.build()
    name = fkernel.TC_INSTANCE.format(hd=hd)
    hgmma = {k: n for k, n in nvcc.sass_counts(lib, "HGMMA").items()
             if name in k}
    assert len(hgmma) == 1 and all(hgmma.values()), hgmma
    if report:  # built in this process: ptxas's report is at hand
        rows = [v for k, v in nvcc.ptxas_table(report).items() if name in k]
        assert rows and rows[0]["spill_stores"] == rows[0]["spill_loads"] == 0


def test_flash_kernel_raises_on_a_misaligned_view(card):
    """TMA reads 16-byte aligned rows: a view off by one element raises."""
    case = (1, 64, 64, 2, 1, 64, True, 0)
    q, k, v = SMOKE.flash_inputs(case, torch.bfloat16, 3, card)
    buf = torch.empty(q.numel() + 8, dtype=q.dtype, device=card)
    qm = buf[1:1 + q.numel()].view(q.shape)
    qm.copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        fops.flash_attention(qm, k, v)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SMOKE.DECODE_CASES, ids=str)
def test_decode_kernel_matches_plain(card, case, dtype):
    """kv_len on and off the tile, 0 and past Skv; G up to 10."""
    q, k, v = SMOKE.decode_inputs(case, dtype, 1, card)
    want = dops.decode_attention_plain(q, k, v, case[5])
    n0 = dops.decode_attention.launches
    got = dops.decode_attention(q, k, v, case[5])
    torch.cuda.synchronize()
    assert dops.decode_attention.launches == n0 + 1
    err, n_over = SMOKE.over_bound(got, want, dtype)
    assert n_over == 0, f"max err {err}"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SMOKE.DECODE_SPLIT_CASES, ids=str)
def test_decode_kernel_splits(card, case, dtype):
    """One split and many, kv_len 0 and past Skv among the many; the split
    count is the wrapper's chooser's; two calls equal bit for bit."""
    B, Skv, Hq, Hkv, hd, kv_len = case
    q, k, v = SMOKE.decode_inputs(case, dtype, 4, card)
    want = dops.decode_attention_plain(q, k, v, kv_len)
    got = dops.decode_attention(q, k, v, kv_len)
    again = dops.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    err, n_over = SMOKE.over_bound(got, want, dtype)
    assert n_over == 0, f"max err {err}"
    assert torch.equal(got, again)


def test_decode_kernel_is_deterministic(card):
    """qwen3-1.7b's decode shape (5 splits, merged in split order, no
    atomics): two calls give the same bits."""
    case = SMOKE.QWEN_DECODE
    q, k, v = SMOKE.decode_inputs(case, torch.bfloat16, 5, card)
    assert dops.split_count(case[1], case[5], case[0] * case[3]) > 1
    outs = [dops.decode_attention(q, k, v, case[5]) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*outs)


def test_decode_kernel_reads_a_strided_cache(card):
    """The model's cache is one layer of a stacked tensor: the kernel reads
    it in place; a view whose rows are not 16-byte aligned raises."""
    case = (2, 96, 8, 2, 64, 70)
    q, k, v = SMOKE.decode_inputs(case, torch.bfloat16, 2, card)
    kk = torch.stack([v, k])[1]
    vv = torch.stack([k, v])[1]
    got = dops.decode_attention(q, kk, vv, case[5])
    want = dops.decode_attention_plain(q, k, v, case[5])
    assert SMOKE.over_bound(got, want, torch.bfloat16)[1] == 0
    buf = torch.empty(k.numel() + 8, dtype=k.dtype, device=card)
    km = buf[1:1 + k.numel()].view(k.shape)
    km.copy_(k)
    with pytest.raises(ValueError, match="aligned"):
        dops.decode_attention(q, km, v, case[5])


def test_attention_kernels_raise_on_what_they_do_not_take(card):
    q = torch.zeros((1, 8, 2, 32), device=card)
    with pytest.raises(ValueError, match="head dim"):
        fops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        dops.decode_attention(q[:, :1], q, q, 4)


def test_serve_engine_runs_the_kernels(card):
    """qwen3-1.7b SMOKE on the card: every prefill layer one flash launch,
    every decode step one flash-decode launch a layer; the engine's tokens
    are the argmax of its teacher-forced kernel-route logits, and every
    attention call of that run is within the bf16 bound of the kernels'
    plain versions on the same inputs."""
    cfg = get_smoke("qwen3-1.7b")
    run = RunConfig(attn_chunk=8, remat_policy="none", decode_budget=8)
    params = lm.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    eng = ServeEngine(cfg, run, params, max_batch=2)
    prompts = [np.arange(8, dtype=np.int32), np.arange(5, dtype=np.int32) + 3]
    fops.flash_attention.launches = dops.decode_attention.launches = 0
    outs = eng.generate([Request(p, max_new_tokens=4) for p in prompts])
    assert fops.flash_attention.launches == cfg.n_layers
    assert dops.decode_attention.launches == cfg.n_layers * 4
    tokens = np.stack([o.tokens for o in outs])
    toks, plen = eng._pad_batch([Request(p) for p in prompts])
    fed = torch.from_numpy(tokens.astype(np.int64)).to(card)
    check = SMOKE.AttentionCheck()
    logits, _, _ = SMOKE.teacher_forced(cfg, run, params, toks, plen, fed,
                                        attention=check)
    assert check.calls == cfg.n_layers * 5 and check.over == 0
    picks = np.stack([x[:, :cfg.vocab].argmax(-1).cpu().numpy()
                      for x in logits[:-1]], 1)
    np.testing.assert_array_equal(picks, tokens)


# -- the RG-LRU scan (tests/test_kernels.py:131's bound) ---------------------

@pytest.mark.parametrize("zero_h0", [False, True])
@pytest.mark.parametrize("case", SMOKE.RGLRU_CASES, ids=str)
def test_rglru_kernel_matches_plain(card, case, zero_h0):
    """Bit for bit against the sequential version (one fused multiply-add
    a step, as the kernel), within the bound of the associative scan; one
    counted launch per call; any S and width."""
    a, b, h0 = SMOKE.scan_inputs(case, 3, card, zero_h0=zero_h0)
    n0 = rops.rglru_scan.launches
    got = rops.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert rops.rglru_scan.launches == n0 + 1
    assert torch.equal(got, rglru_scan_seq(a, b, h0))
    err, n_over = SMOKE.over_bound(got, rglru_scan_ref(a, b, h0),
                                   torch.float32, SMOKE.SCAN_TOL)
    assert n_over == 0, f"max err {err}"


def test_rglru_kernel_raises_on_what_it_does_not_take(card):
    a, b, h0 = SMOKE.scan_inputs((2, 8, 64), 4, card)
    with pytest.raises(ValueError, match="contiguous"):
        rops.rglru_scan(a.transpose(0, 1).contiguous().transpose(0, 1), b,
                        h0)
    with pytest.raises(ValueError, match="on cpu"):
        rops.rglru_scan(a, b, h0.cpu())
    with pytest.raises(TypeError, match="float32"):
        rops.rglru_scan(a.bfloat16(), b.bfloat16(), h0.bfloat16())


def test_serve_engine_runs_the_rglru_kernel(card):
    """recurrentgemma-2b SMOKE with a tail (5 layers: R R A R R) on the
    card: every RG-LRU layer one scan launch a prefill and a token, every
    local-attention prefill one flash launch; the engine's tokens are the
    argmax of its teacher-forced kernel-route logits; every attention and
    scan call of that run within its plain versions' bound (the scan bit
    for bit to the sequential one, and so the whole route's logits); the
    kernel route within the bf16 bound of the plain route in norm (five
    layers keep it there)."""
    from dataclasses import replace
    cfg = replace(get_smoke("recurrentgemma-2b"), n_layers=5)
    run = RunConfig(attn_chunk=8, remat_policy="none", decode_budget=6)
    params = lm.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    eng = ServeEngine(cfg, run, params, max_batch=2)
    prompts = [np.arange(20, dtype=np.int32), np.arange(5, dtype=np.int32)]
    fops.flash_attention.launches = dops.decode_attention.launches = 0
    rops.rglru_scan.launches = 0
    outs = eng.generate([Request(p, max_new_tokens=6) for p in prompts])
    assert fops.flash_attention.launches == 1
    assert dops.decode_attention.launches == 0
    assert rops.rglru_scan.launches == 4 * 7
    tokens = np.stack([o.tokens for o in outs])
    toks, plen = eng._pad_batch([Request(p) for p in prompts])
    fed = torch.from_numpy(tokens.astype(np.int64)).to(card)
    acheck, scheck = SMOKE.AttentionCheck(), SMOKE.ScanCheck()
    lk, _, _ = SMOKE.teacher_forced(cfg, run, params, toks, plen, fed,
                                    attention=acheck, scan=scheck)
    assert acheck.calls == 1 and acheck.over == 0
    assert scheck.calls == 4 * 7 and scheck.over == 0
    assert scheck.unequal == 0
    ls, _, _ = SMOKE.teacher_forced(cfg, run, params, toks, plen, fed,
                                    scan=rglru_scan_seq)
    assert all(map(torch.equal, lk, ls))  # the scan's route, bit for bit
    lp, _, _ = SMOKE.teacher_forced(cfg, run, params, toks, plen, fed,
                                    attention=SMOKE.plain_attention,
                                    scan=rglru_scan_seq)
    SMOKE.compare_routes(lk, lp, tokens, cfg.vocab)


# -- the mLSTM (tests/test_kernels.py:165-166's bound) -----------------------

@pytest.mark.parametrize("case", SMOKE.MLSTM_CASES, ids=str)
def test_mlstm_kernel_matches_plain(card, case):
    """h, C and n within the bound of the chunked plain version at the
    kernel's chunk and of the sequential recurrence; one counted launch a
    call; any S, a nonzero state, S = 1."""
    args = SMOKE.mlstm_inputs(case, 5, card)
    n0 = xops.mlstm_chunk.launches
    got = xops.mlstm_chunk(*args)
    torch.cuda.synchronize()
    assert xops.mlstm_chunk.launches == n0 + 1
    for want in (mlstm_chunk_ref(*args, xkernel.CHUNK), mlstm_seq(*args)):
        for g, w in zip(got, want):
            err, n_over = SMOKE.over_bound(g, w, torch.float32,
                                           SMOKE.MLSTM_TOL)
            assert n_over == 0, f"max err {err}"


def test_mlstm_kernel_reads_strided_qkv(card):
    """q, k, v as head slices of wider tensors: the kernel reads them
    through their strides, with the same result as contiguous copies."""
    B, S, H, dh = 2, 70, 2, 64
    q, k, v, lf, li, C0, n0 = SMOKE.mlstm_inputs((B, S, 2 * H, dh, True), 6,
                                                 card)
    lf, li = lf[:, :, :H].contiguous(), li[:, :, :H].contiguous()
    C0, n0 = C0[:, :H].contiguous(), n0[:, :H].contiguous()
    strided = xops.mlstm_chunk(q[:, :, H:], k[:, :, :H], v[:, :, H:], lf, li,
                               C0, n0)
    dense = xops.mlstm_chunk(q[:, :, H:].contiguous(),
                             k[:, :, :H].contiguous(),
                             v[:, :, H:].contiguous(), lf, li, C0, n0)
    torch.cuda.synchronize()
    for a, b in zip(strided, dense):
        assert torch.equal(a, b)


def test_mlstm_kernel_raises_on_what_it_does_not_take(card):
    q, k, v, lf, li, C0, n0 = SMOKE.mlstm_inputs((2, 8, 2, 64, True), 7,
                                                 card)
    with pytest.raises(TypeError, match="bfloat16"):
        xops.mlstm_chunk(q.float(), k.float(), v.float(), lf, li, C0, n0)
    with pytest.raises(ValueError, match="on cpu"):
        xops.mlstm_chunk(q, k, v, lf, li, C0.cpu(), n0)
    with pytest.raises(ValueError, match="contiguous"):
        xops.mlstm_chunk(q, k, v, lf.transpose(0, 1).contiguous().transpose(
            0, 1), li, C0, n0)
    with pytest.raises(ValueError, match="aligned"):
        xops.mlstm_chunk(q[..., 4:36], k[..., 4:36], v[..., 4:36], lf, li,
                         C0[..., :32, :32].contiguous(),
                         n0[..., :32].contiguous())
    with pytest.raises(ValueError, match="multiples of 32"):
        xops.mlstm_chunk(q[..., :48], k[..., :48], v[..., :48], lf, li,
                         C0[..., :48, :48].contiguous(),
                         n0[..., :48].contiguous())


def _hold_mlstm(got, want):
    for g, w in zip(got, want):
        err, n_over = SMOKE.over_bound(g, w, torch.float32, SMOKE.MLSTM_TOL)
        assert n_over == 0, f"max err {err}"


@pytest.mark.parametrize("dh", [32, 96, 128, 512])
def test_mlstm_decode_in_place_matches_plain(card, dh):
    """The decode step written into the state passed in: the same tensors
    come back, bit-equal to the call that writes new tensors, within the
    bound of the plain decode step and of the sequential recurrence; one
    counted launch a call."""
    args = SMOKE.mlstm_inputs((3, 1, 2, dh, True), 11, card)
    fresh = xops.mlstm_chunk(*args)
    C, n = args[5].clone(), args[6].clone()
    n0 = xops.mlstm_chunk.launches
    got = xops.mlstm_chunk(*args[:5], C, n, out=(C, n))
    torch.cuda.synchronize()
    assert xops.mlstm_chunk.launches == n0 + 1
    assert got[1] is C and got[2] is n
    assert all(map(torch.equal, got, fresh))
    Cw, nw = args[5].clone(), args[6].clone()
    hw = mlstm_decode_ref(*args[:5], Cw, nw)
    _hold_mlstm(got, (hw, Cw, nw))
    _hold_mlstm(got, mlstm_seq(*args))


@pytest.mark.parametrize("case", [(2, 200, 2, 128, True), (3, 1, 4, 512, True)],
                         ids=str)
def test_mlstm_two_calls_are_bit_equal(card, case):
    """No atomics, fixed sums: the prefill's passes and the decode step give
    the same bits twice."""
    args = SMOKE.mlstm_inputs(case, 12, card)
    a, b = xops.mlstm_chunk(*args), xops.mlstm_chunk(*args)
    torch.cuda.synchronize()
    assert all(map(torch.equal, a, b))


# head dims at the state pass's 64-column blocks: under one block (32), one
# block (64), one and a half (96, 160: the last block half empty, an odd
# count of 64-wide slices between the two warpgroups) and eight (512)
@pytest.mark.parametrize("dh", [32, 64, 96, 160, 512])
def test_mlstm_kernel_at_the_column_block_edges(card, dh):
    args = SMOKE.mlstm_inputs((2, 77, 2, dh, True), 13, card)
    got = xops.mlstm_chunk(*args)
    torch.cuda.synchronize()
    _hold_mlstm(got, mlstm_chunk_ref(*args, xkernel.CHUNK))
    _hold_mlstm(got, mlstm_seq(*args))


def test_mlstm_out_in_place_only_at_decode(card):
    args = SMOKE.mlstm_inputs((2, 8, 2, 64, True), 14, card)
    with pytest.raises(ValueError, match="in place"):
        xops.mlstm_chunk(*args, out=(args[5], args[6]))
    C, n = torch.empty_like(args[5]), torch.empty_like(args[6])
    got = xops.mlstm_chunk(*args, out=(C, n))
    assert got[1] is C and got[2] is n


def test_decode_writes_the_mlstm_state_into_the_cache(card, monkeypatch):
    """xlstm-350m SMOKE on the card: a decode step's mLSTM blocks return
    the cache's own C and n (written in place), so the stack copies no
    mLSTM leaf back; the first layer's new state (the same inputs on both
    routes) within the bound of the plain route's."""
    cfg = get_smoke("xlstm-350m")
    run = RunConfig(remat_policy="none", decode_budget=6)
    params = lm.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    toks = torch.arange(16, device=card).reshape(2, 8) % cfg.vocab
    _, cache = lm.prefill(cfg, run, params, {"tokens": toks})
    plain = lm.tree_map(torch.clone, cache)
    copied = {}  # the leaves of each block's state, those copied back
    write_back = lm._write_back

    def recording(bc, new):
        kind = "mlstm" if set(new) == {"C", "n"} else "other"
        copied.setdefault(kind, []).append(
            [leaf for leaf, t in new.items() if t is not bc[leaf]])
        write_back(bc, new)

    monkeypatch.setattr(lm, "_write_back", recording)
    lm.decode_step(cfg, run, params, cache, toks[:, :1], 8)
    assert copied["mlstm"] == [[], [], []]  # three mLSTM blocks, no copy
    assert copied["other"] == [["c", "n", "m", "h"]]  # the sLSTM's state
    monkeypatch.setattr(rec, "mlstm_chunk", SMOKE.plain_mlstm)
    lm.decode_step(cfg, run, params, plain, toks[:, :1], 8)
    for leaf in ("C", "n"):
        got = cache["tiles"]["b0"][leaf][0]
        want = plain["tiles"]["b0"][leaf][0]
        _hold_mlstm((got,), (want,))


def test_serve_engine_runs_the_mlstm_kernel(card):
    """xlstm-350m SMOKE on the card (4 layers: mLSTM x 3, sLSTM; 4 heads of
    32): every mLSTM layer one launch a prefill and a token; the engine's
    tokens are the argmax of its teacher-forced kernel-route logits; every
    mLSTM call of that run within its plain version's bound; the kernel
    route within the bf16 bound of the plain route in norm."""
    cfg = get_smoke("xlstm-350m")
    run = RunConfig(remat_policy="none", decode_budget=6)
    params = lm.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    eng = ServeEngine(cfg, run, params, max_batch=2)
    prompts = [np.arange(20, dtype=np.int32), np.arange(5, dtype=np.int32)]
    xops.mlstm_chunk.launches = rops.rglru_scan.launches = 0
    fops.flash_attention.launches = dops.decode_attention.launches = 0
    outs = eng.generate([Request(p, max_new_tokens=6) for p in prompts])
    assert xops.mlstm_chunk.launches == 3 * 7
    assert fops.flash_attention.launches == dops.decode_attention.launches \
        == rops.rglru_scan.launches == 0
    tokens = np.stack([o.tokens for o in outs])
    toks, plen = eng._pad_batch([Request(p) for p in prompts])
    fed = torch.from_numpy(tokens.astype(np.int64)).to(card)
    check = SMOKE.MlstmCheck()
    lk, _, _ = SMOKE.teacher_forced(cfg, run, params, toks, plen, fed,
                                    mlstm=check)
    assert check.calls == 3 * 7 and check.over == 0
    lp, _, _ = SMOKE.teacher_forced(cfg, run, params, toks, plen, fed,
                                    mlstm=SMOKE.plain_mlstm)
    SMOKE.compare_routes(lk, lp, tokens, cfg.vocab)


# -- the fleet server on the card --------------------------------------------

def _fs_serve(device, *, stream=False, obs=False):
    """A small traced, compacted and scheduled server: three storms of a
    noisy tenant under a svc budget, then a deadline-carrying victim
    (preemption, budget evictions and restores), a denied storm and a C3
    request.  Returns (server, results in publication order)."""
    pkg = SMOKE.PORT
    srv = FleetServer(pool=3, gen_steps=40, chunk=8, fuel=SMOKE.FUEL,
                      trace=True, stream=stream, compact=True, obs=obs,
                      cfg=HookConfig(compact_min_bucket=1),
                      scheduler=PolicyScheduler(
                          budgets={"noisy": TenantBudget(max_svc=12)}),
                      device=device)
    storm = pkg.prepare(pkg.programs.syscall_storm_param(),
                        pkg.Mechanism.NONE)
    victim = pkg.prepare(pkg.programs.getpid_loop_param(), pkg.Mechanism.ASC,
                         virtualize=True)
    for n in (6, 5, 4):
        srv.submit(storm, regs={19: n, 20: 2, 21: 3}, tenant="noisy")
    out = srv.step()
    srv.submit(victim, regs={19: 2}, tenant="victim", priority=10,
               deadline_steps=40)
    srv.submit(storm, regs={19: 3, 20: 2, 21: 1}, tenant="d",
               policy=[tpolicy.deny(L.SYS_GETPID, errno=13)])
    srv.submit(lambda: pkg.programs.indirect_svc(3), virtualize=True,
               tenant="c3")
    return srv, out + srv.run(max_generations=20000)


@pytest.mark.parametrize("stream", [False, True])
def test_fleet_server_on_card_equals_cpu(card, stream):
    """The same server on the card (every generation through the megastep
    kernel) and on CPU tensors (its plain version): every published
    result and the stats equal, state for state."""
    mops.megastep_chunk.launches = 0
    gsrv, gres = _fs_serve(card, stream=stream)
    assert mops.megastep_chunk.launches > 0
    csrv, cres = _fs_serve("cpu", stream=stream)
    assert [r.rid for r in gres] == [r.rid for r in cres]
    for g, c in zip(gres, cres):
        assert g.state.pc.device.type == "cuda"
        _assert_equal(c.state, _to_cpu(g.state), f"rid {g.rid}")
        for f in ("events", "attempts", "admitted_gen", "completed_gen",
                  "trace", "trace_dropped", "histogram", "preemptions"):
            assert getattr(g, f) == getattr(c, f), (g.rid, f)
    gst, cst = gsrv.stats(), csrv.stats()
    clock = {k for k in gst if k.endswith("_ms_mean") or k.endswith("_ms_max")}
    assert {k: v for k, v in gst.items() if k not in clock} == \
        {k: v for k, v in cst.items() if k not in clock}
    assert gst["evictions"] + gst["preemptions"] >= 1
    assert gst["c3_readmissions"] == 1 and gst["scalar_reexecutions"] == 0


def test_fleet_server_published_states_survive_on_card(card):
    """Published states are copies on the card: no later generation or
    admission writes them."""
    srv = FleetServer(pool=1, gen_steps=40, chunk=8, fuel=SMOKE.FUEL,
                      device=card)
    pp = SMOKE.PORT.prepare(SMOKE.PORT.programs.getpid_loop_param(),
                            SMOKE.PORT.Mechanism.ASC, virtualize=True)
    for n in (2, 5, 3):
        srv.submit(pp, regs={19: n})
    first = []
    while not first:
        first = srv.step()
    kept = _clone(first[0].state)
    ptrs = {x.untyped_storage().data_ptr() for x in srv._states}
    assert not ptrs & {x.untyped_storage().data_ptr()
                       for x in first[0].state}
    rest = srv.run()
    assert len(rest) == 2
    _assert_equal(kept, first[0].state, "published state")
    assert not torch.equal(srv._states.icount[0], kept.icount)


def test_fleet_server_device_sync_is_a_synchronize(card, monkeypatch):
    """Observed, each dispatched generation's device_sync phase is one
    torch.cuda.synchronize on the server's card; the published states
    equal an unobserved server's."""
    calls = []
    real = torch.cuda.synchronize

    def counted(device=None):
        calls.append(device)
        real(device)

    plain_srv, plain = _fs_serve(card)
    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    srv, res = _fs_serve(card, obs=True)
    monkeypatch.undo()
    phases = srv.metrics()["phases"]
    assert phases["device_sync"]["count"] == srv.dispatches
    assert calls.count(srv.device) >= srv.dispatches
    for a, b in zip(plain, res):
        _assert_equal(a.state, b.state, f"rid {a.rid} observed")


# -- durable serving and chaos on the card -----------------------------------

def _durable_server(device, directory, **kw):
    """tests/test_durability.py's ``_mk_server`` settings on ``device``."""
    cfg = HookConfig(trace_enabled=True, compact_enabled=True,
                     snapshot_interval=3, journal_fsync=False)
    return FleetServer(4, cfg=cfg, gen_steps=48, fuel=25_000,
                       scheduler=PolicyScheduler(
                           budgets={"b": TenantBudget(max_svc=12)}),
                       durability=DurabilityManager(directory), device=device,
                       **kw)


def _durable_feed(srv):
    P, M = SMOKE.PORT.programs, SMOKE.PORT.Mechanism
    for _ in range(3):
        srv.submit(P.getpid_loop_param, mechanism=M.ASC, virtualize=True,
                   regs={19: 3}, tenant="a", priority=1)
        srv.submit(P.read_loop_param, mechanism=M.SIGNAL, virtualize=True,
                   regs={19: 2}, tenant="b")
        srv.submit(P.mixed_ops_param, mechanism=M.ASC, virtualize=True,
                   regs={19: 3}, tenant="c", deadline_steps=400)


def test_durable_kill_and_recover_on_card_equals_cpu(card, tmp_path):
    """A durable server on the card killed at generation 4 and recovered
    there (every generation, replayed ones included, through the megastep
    kernel) drains to the uninterrupted server's results on CPU tensors."""
    ref = _durable_server("cpu", tmp_path / "ref")
    _durable_feed(ref)
    want = {r.rid: r for r in ref.run(5000)}
    vic = _durable_server(card, tmp_path / "vic")
    _durable_feed(vic)
    pre = [r for _ in range(4) for r in vic.step()]
    del vic
    mops.megastep_chunk.launches = 0
    srv, replayed = FleetServer.recover(tmp_path / "vic", device=card)
    assert srv._states.pc.device.type == srv.device.type
    union = {r.rid: r for r in pre + replayed + srv.run(5000)}
    assert mops.megastep_chunk.launches > 0
    assert set(union) == set(want)
    for rid, r in want.items():
        _assert_equal(r.state, _to_cpu(union[rid].state), f"rid {rid}")
        assert [dataclasses.astuple(t) for t in r.trace] == \
            [dataclasses.astuple(t) for t in union[rid].trace]
    st_, rst = srv.stats(), ref.stats()
    for k in ("tenants", "completed", "evictions", "quarantine"):
        assert st_[k] == rst[k], k


# tests/test_durability.py's soak, its programs and settings, as the JAX
# package runs it (CPU): the injection ledger's summary and sha256 of
# json.dumps(ledger, sort_keys=True), and the server's counters.
SOAK_LEDGER = {
    "summary": {"injections": 206,
                "by_kind": {"corrupt": 38, "bitflip": 60, "hang": 25,
                            "dispatch": 83},
                "by_resolution": {"rewritten": 36, "rolled_back": 60,
                                  "retried": 108, "harmless": 2},
                "unresolved": 0},
    "sha256": "9029dc64b7551bb9eacf223bed2b3621ff168ca59cfce9cdf95c090e3088baf1",
    "stats": {"generations": 536, "rollbacks": 60, "retries": 108,
              "recovery_generations": 3458764513820540925,
              "watchdog_trips": 25, "snapshots": 178,
              "snapshot_rewrites": 36, "shed_requests": 0}}


def test_chaos_soak_on_card_matches_the_jax_ledger(card, tmp_path):
    """The reference soak on the card: every injection resolved, every
    non-shed result equal to the solo run, the ledger the JAX server's
    (bit-flips in place in the card's carry, rollbacks adopting a replica
    recovered on the card)."""
    import hashlib
    import json
    P = SMOKE.PORT.programs
    cfg = HookConfig(trace_enabled=True, snapshot_interval=3,
                     journal_fsync=False, chaos_max_retries=2,
                     chaos_backoff_base_ms=0, serve_watchdog_s=0.001,
                     chaos_seed=7, chaos_dispatch_fault_rate=0.12,
                     chaos_hang_rate=0.04, chaos_bitflip_rate=0.35,
                     chaos_snapshot_corrupt_rate=0.25)
    if "dur-getpid" not in D.BUILDERS:
        D.register_builder("dur-getpid", lambda: P.getpid_loop(300))
    srv = FleetServer(4, cfg=cfg, gen_steps=64, fuel=25_000,
                      durability=DurabilityManager(tmp_path / "d"),
                      chaos=ChaosMonkey(), device=card)
    rids = [srv.submit(D.BUILDERS["dur-getpid"], fuel=25_000)
            for _ in range(6)]
    out = {}
    for _ in range(600):
        if SMOKE.drained(srv):
            break
        for r in srv.step():
            out[r.rid] = r
    ledger = srv._chaos.injections
    assert srv._chaos.summary() == SOAK_LEDGER["summary"]
    assert hashlib.sha256(json.dumps(ledger, sort_keys=True).encode()
                          ).hexdigest() == SOAK_LEDGER["sha256"]
    st_ = srv.stats()
    assert {k: st_[k] for k in SOAK_LEDGER["stats"]} == SOAK_LEDGER["stats"]
    solo = SMOKE.run_prepared(SMOKE.PORT.prepare(
        P.getpid_loop(300), SMOKE.PORT.Mechanism.ASC), fuel=25_000,
        device=card)
    shed = {e["rid"] for e in srv.shed}
    for rid in rids:
        if rid not in shed:
            _assert_equal(_to_cpu(solo), _to_cpu(out[rid].state),
                          f"soak rid {rid}")
    assert shed | set(out) >= set(rids)


@pytest.mark.parametrize("traced", [False, True])
def test_carry_digest_on_card_equals_cpu_copy(census_every_tenth, traced):
    """carry_digest, lane_digests and pack_carry of a scrambled carry on the
    card equal those of its CPU copy; unpack_carry puts it back on the
    card; flip_bit flips the card's carry in place."""
    pps, _, _, _, s0 = census_every_tenth
    rng = np.random.default_rng(11)
    code = SMOKE.code_of(pps)
    s = interop.state_from_numpy(SMOKE.scramble_kern(SMOKE.scramble(
        interop.state_to_numpy(s0), code, rng), code, rng), s0.pc.device)
    B = int(s.pc.shape[0])
    tr = (interop.trace_from_numpy(SMOKE.scramble_trace(
        B, 16, rng, SMOKE.random_policies(B, rng)), s.pc.device)
        if traced else None)
    cs, ct = _clone(_to_cpu(s)), (_clone(_to_cpu(tr)) if traced else None)
    assert fleet.carry_digest(s, tr) == fleet.carry_digest(cs, ct)
    assert fleet.lane_digests(s, tr) == fleet.lane_digests(cs, ct)
    a, b = fleet.pack_carry(s, tr), fleet.pack_carry(cs, ct)
    assert list(a) == list(b)
    assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
               for k in a)
    us, ut = fleet.unpack_carry(a, device=s.pc.device)
    assert us.mem.device == s.mem.device
    _assert_equal(cs, _to_cpu(us), "unpacked")
    mem = s.mem
    fleet.flip_bit(s, 3, 4321, 63)
    assert s.mem is mem and fleet.lane_digests(s, tr)[3] != \
        fleet.lane_digests(cs, ct)[3]
    fleet.flip_bit(cs, 3, 4321, 63)
    assert fleet.carry_digest(s, tr) == fleet.carry_digest(cs, ct)


# -- the MoE, the frontend and the encoder-decoder; lane sharding ------------

@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "seamless-m4t-medium",
                                  "llava-next-34b"])
def test_serve_engine_runs_every_family_on_the_kernels(card, arch):
    """SMOKE on the card: flash attention for every self-attention
    prefill, encoder layer and cross-attention prefill; flash-decode for
    every self- and cross-attention decode step; the engine's tokens the
    argmax of its teacher-forced kernel-route logits; every attention
    call within the bf16 bound of the kernels' plain versions."""
    cfg = get_smoke(arch)
    run = RunConfig(attn_chunk=8, remat_policy="none", decode_budget=8)
    params = lm.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    eng = ServeEngine(cfg, run, params, max_batch=2)
    prompts = [np.arange(8, dtype=np.int32), np.arange(5, dtype=np.int32) + 3]
    fops.flash_attention.launches = dops.decode_attention.launches = 0
    outs = eng.generate([Request(p, max_new_tokens=4) for p in prompts])
    cross = cfg.n_layers if cfg.kind == "encdec" else 0
    launches = fops.flash_attention.launches + dops.decode_attention.launches
    assert fops.flash_attention.launches == cfg.n_layers + cross + (
        cfg.enc_layers if cross else 0)
    assert dops.decode_attention.launches == (cfg.n_layers + cross) * 4
    tokens = np.stack([o.tokens for o in outs])
    toks, plen = eng._pad_batch([Request(p) for p in prompts])
    fed = torch.from_numpy(tokens.astype(np.int64)).to(card)
    check = SMOKE.AttentionCheck()
    logits, _, _ = SMOKE.teacher_forced(cfg, run, params, toks, plen, fed,
                                        attention=check)
    assert check.over == 0 and check.calls == launches
    picks = np.stack([x[:, :cfg.vocab].argmax(-1).cpu().numpy()
                      for x in logits[:-1]], 1)
    np.testing.assert_array_equal(picks, tokens)


def test_cross_attention_decode_takes_flash_decode_over_the_whole_cache(
        card):
    """One non-causal query against a cache with no kv_len: flash-decode
    with kv_len = Skv, equal to flash attention's plain version."""
    from repro_torch.models import layers
    q, k, v = SMOKE.decode_inputs((3, 64, 16, 16, 64, 0), torch.bfloat16, 5,
                                  card)
    dops.decode_attention.launches = fops.flash_attention.launches = 0
    got = layers.attention(q, k, v, causal=False)
    assert dops.decode_attention.launches == 1
    assert fops.flash_attention.launches == 0
    want = fops.flash_attention_plain(q, k, v, causal=False)
    assert SMOKE.over_bound(got, want, torch.bfloat16)[1] == 0


def test_moe_on_the_card_is_deterministic_and_near_the_cpu(card):
    """qwen2-moe-a2.7b SMOKE's MoE layer: two calls on the card equal bit
    for bit (the combine is a gather and a fixed-order sum, no atomics);
    the output within the bf16 bound of the CPU's where no token's
    routing is at a near-tie (uncapped, so no token's drop depends on
    another's routing)."""
    from repro_torch.models import moe
    cfg = get_smoke("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    p = moe.init_moe(cfg, torch.Generator(device=card).manual_seed(3))
    x = SMOKE.randn((4, 64, cfg.d_model), torch.bfloat16,
                    np.random.default_rng(6), card)
    y1, a1 = moe.apply_moe(cfg, p, x)
    y2, a2 = moe.apply_moe(cfg, p, x)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    yc, _ = moe.apply_moe(cfg, lm.tree_map(lambda t: t.cpu(), p), x.cpu())
    r = moe.route(cfg, lm.tree_map(lambda t: t.cpu(), p), x.cpu())
    k = cfg.moe.top_k
    lg = torch.sort(r.logits, -1, descending=True).values
    clear = (lg[..., k - 1] - lg[..., k] > 2 * (2e-2 + 2e-2 * lg[
        ..., k - 1].abs()))
    assert clear.any()
    got, want = y1.cpu()[clear], yc[clear]
    assert SMOKE.over_bound(got, want, torch.bfloat16)[1] == 0


def test_shard_on_one_card_is_the_unsharded_run(census_every_tenth, card):
    """run_fleet_prepared(shard=True) over every visible card: with one
    card the no-op path, every leaf the unsharded run's."""
    from repro_torch.parallel import sharding
    pps, regs = census_every_tenth[:2]
    want = run_fleet_prepared(pps, fuel=SMOKE.FUEL, chunk=128, regs=regs,
                              device=card)
    got = run_fleet_prepared(pps, fuel=SMOKE.FUEL, chunk=128, regs=regs,
                             shard=True)
    _assert_equal(want, got, "shard=True")
    assert sharding.fleet_mesh().size == torch.cuda.device_count()


# -- training: the plain route under autograd on the card -----------------------

TRAIN_RUN = dict(attn_chunk=8, mlstm_chunk=8, z_loss=1e-4, loss_chunk=8)
TRAIN_RTOL = 2e-2   # bf16 bound, tests/test_kernels.py:26-27


def _train_inputs(arch, device):
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models.interop import params_from_numpy
    cfg = get_smoke(arch)
    params = params_from_numpy(SMOKE.numpy_params(arch, 0), device=device)
    batch = TokenStream(cfg, ShapeConfig("t", 32, 4, "train")).batch_at(0)
    return cfg, params, {k: torch.from_numpy(v).to(device)
                         for k, v in batch.items()}


def test_model_kernels_raise_under_grad(card):
    """Each kernel's wrapper refuses inputs that require grad (no kernel
    has a backward) and launches nothing."""
    assert SMOKE.refuse_grad_check(card) == list(SMOKE.MODEL_KERNELS)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-2b",
                                  "xlstm-350m", "qwen2-moe-a2.7b",
                                  "seamless-m4t-medium"])
def test_train_step_on_card_near_cpu(card, arch):
    """The train step's loss and every leaf's gradient on the card within
    2e-2 of the same step on the CPU (same numpy-seeded weights and
    batch); no model kernel launched on the card; a whole step runs.

    A leaf is held to 2e-2 of its own gradient's norm, but the xLSTM
    cells' input-gate biases (``mlstm/bi``, ``slstm/bi``): the cells'
    normalisers absorb a shift of log i wherever they exceed 1, so those
    gradients are residuals of cancelling terms (their relative change
    under a 1e-3 perturbation of the weights is 2-3x the other leaves'),
    and each is held to 2e-2 of its block's gradient norm."""
    from repro_torch.optim.adamw import init_opt_state, tree_leaves
    from repro_torch.train.step import grads_and_metrics, make_train_step
    run = RunConfig(**TRAIN_RUN, remat_policy="nothing")
    cfg, pc, bc = _train_inputs(arch, "cpu")
    _, pg, bg = _train_inputs(arch, card)
    gc_, mc = grads_and_metrics(cfg, run, pc, bc)
    SMOKE.reset_kernel_launches()
    gg, mg = grads_and_metrics(cfg, run, pg, bg)
    assert not any(SMOKE.kernel_launches().values())
    assert float(mg["loss"]) == pytest.approx(float(mc["loss"]),
                                              rel=TRAIN_RTOL)
    total = float(torch.sqrt(sum((w * w).sum() for w in tree_leaves(gc_))))

    def check(want, got, block):
        for k, w in want.items():
            if isinstance(w, dict):
                check(w, got[k], w)
                continue
            g, norm = got[k].cpu(), float(w.norm())
            if norm <= 1e-6 * total:
                assert float(g.norm()) <= 1e-6 * total, k
                continue
            if k == "bi" and ("w_up" in block or "rz" in block):
                norm = float(torch.sqrt(sum((x * x).sum()
                                            for x in tree_leaves(block))))
            assert float((g - w).norm()) <= TRAIN_RTOL * norm, k

    check(gc_, gg, gc_)
    state = {"params": pg, "opt": init_opt_state(pg)}
    state, m = make_train_step(cfg, run)(state, bg)
    assert float(m["loss"]) == float(mg["loss"])
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(pg))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-2b"])
def test_remat_policies_equal_on_card(card, arch):
    """The remat policies change memory, never a bit, on the card too."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import grads_and_metrics
    cfg, params, batch = _train_inputs(arch, card)
    out = {}
    for policy in ("none", "nothing", "dots", "full"):
        g, m = grads_and_metrics(cfg, RunConfig(**TRAIN_RUN,
                                                remat_policy=policy),
                                 params, batch)
        out[policy] = (float(m["loss"]), tree_leaves(g))
    for policy, (loss, grads) in out.items():
        assert loss == out["none"][0], policy
        assert all(torch.equal(a, b) for a, b in zip(grads, out["none"][1])), \
            policy
