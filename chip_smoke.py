#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--parent OLD_MEGASTEP_CU]

(``--parent``: an earlier design of the megastep kernel, one thread a
lane, built from that source and timed in turns with this one on each
census at PARENT_BLOCK lanes a block; optional.)

The main paths, each driven through the entry points a user calls, with
every kernel launch counted from 0 just before and read just after:

* The census: 500 simulated AArch64 processes (5 interception mechanisms
  x 5 workloads x 20 iteration counts, 25 decode images, ~8k instructions
  a lane) prepared with ASC-Hook at the default ``HookConfig``
  (guest-kernel emulation on) and run to halt as one fleet through
  ``repro_torch.core.run_fleet_prepared`` — every chunk of steps one
  launch of the CUDA megastep kernel.  The same kernel carries three
  variants of the TPU kernel, each driven by a path of its own: K1 (the
  census with emulation off), K3 (the default census) and K2 (the default
  census traced, with the policy gate).
* The census's other drivers, around the same kernel: the traced census
  streamed (``fleet.run_fleet_stream`` into a ``TraceStream``), the
  census through a 128-lane pool (``admit_lanes``, ``restore_lanes``, a
  ``FleetImageTable``, ``run_fleet_span``) and the census compacted
  (``run_fleet_prepared(compact=True)``), untraced (K3) and traced (K2).
* The fleet server (``repro_torch.serve.fleet_server.FleetServer``): the
  census served through a 128-lane pool, untraced, then traced, streamed,
  compacted and observed; the noisy-neighbor mix under the policy
  scheduler; a C3 request re-admitted in the fleet — every generation the
  same megastep kernel (K3 untraced, K2 traced).
* LM serving: ``repro_torch.serve.engine.ServeEngine`` over qwen3-1.7b at
  full width (28 layers, d_model 2048, random weights from a seeded
  ``torch.Generator``): 8 prompts of 64..512 tokens, 32 new tokens each —
  every layer's prefill attention one launch of the CUDA flash-attention
  kernel, every decode step's attention one launch a layer of the CUDA
  flash-decode kernel.
* Hybrid serving: the same engine over recurrentgemma-2b at full width
  and depth (26 layers on the pattern RG-LRU, RG-LRU, local attention:
  18 RG-LRU and 8 local-attention layers, d_model 2560, 10 query heads to
  1 KV head of 256, window 2048), the same requests — every RG-LRU
  layer's scan one launch of the CUDA rglru_scan kernel (prefill and each
  decode step), every local-attention prefill one flash-attention launch
  with the window; the ring decode is the model's plain masked attention.
* xLSTM serving: the same engine over xlstm-350m at full width and depth
  (24 layers on the pattern mLSTM x 3, sLSTM: 18 mLSTM and 6 sLSTM
  layers, d_model 1024, 4 heads of 512 after the mLSTM's up-projection),
  the same requests — every mLSTM layer's prefill one call of the CUDA
  mLSTM kernels (the scores pass and the state pass on the tensor cores,
  the state C, n carried in and out) and every decode step one call of
  the decode step, which writes C and n into the cache in place; the
  sLSTM is plain PyTorch, a loop over time.
* The other model families, through the same engine and requests, each
  freed before the next: qwen2-moe-a2.7b at full width and depth (24
  layers of 60 routed experts, top 4, and 4 shared; 14.32 B parameters),
  its router, experts and combine PyTorch operations; seamless-m4t-medium
  at full size (12 encoder and 12 decoder layers, head dim 64; the
  encoder's zero input of 64 frames) — flash attention for the encoder
  (non-causal), the decoder's self-attention and its cross-attention
  prefill (512 queries over 64 frames), flash-decode for the decode
  step's self- and cross-attention; llava-next-34b at full width and 16
  of its 60 layers (56 query heads to 8 KV heads; a zero prefix of 64
  positions before the tokens), flash attention over 576 positions and
  flash-decode at group 7.
* Lane sharding: the census through ``run_fleet_prepared(shard=True)``
  and through sharded and durable sharded fleet servers on every visible
  card; with one card, the no-op path.
* Training: ``repro_torch.train.loop.run_training`` over qwen3-1.7b and
  recurrentgemma-2b SMOKE (a crash, then the auto-resume), and three
  steps of ``repro_torch.train.step.make_train_step`` over qwen3-1.7b at
  full width and depth (28 layers, 1.72 B parameters, f32 parameters and
  AdamW moments on the card, batch 4 x 512) — the models' plain forms
  under autograd: no kernel has a backward, so the four model kernels
  must launch 0 times there, and each refuses inputs that require grad.
* Collective hooks: ``repro_torch.train.step.make_ddp_train_step`` (the
  explicit gradient all-reduce, one site a leaf) over the same full-width
  qwen3-1.7b on a one-rank NCCL world (``repro_torch.launch.mesh``),
  unhooked and under ``repro_torch.hooks``' handlers (the
  ``torch.distributed`` interceptor, a dispatch mode), with its site
  census and the completeness check against the backend's own record.
* The examples: the JAX package's ``examples/`` as the port's
  ``repro_torch.examples`` on the card — the quickstart (Table 3, the
  rewrite report, Figure 4's C3) through the megastep kernel, serve_demo
  over SMOKE qwen3-1.7b, recurrentgemma-2b and xlstm-350m through the
  model kernels, hooked_training's DDP step on a one-rank NCCL world —
  and ``core.fleet_step_traced``, the one-step API.

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. ``build``: the five kernel libraries from ``src/`` (one nvcc each,
   sm_90a, all started together), megastep's and rglru_scan's ptxas
   reports; ``attn_build``: the attention libraries' ptxas summary, and
   for the instances both serving paths launch (flash attention's bf16
   tensor-core kernel at head dims 128 and 256, flash-decode's bf16 split
   kernel at head dim 128) their registers, spills, shared memory and the
   count of ``HGMMA`` instructions in their SASS (``cuobjdump -sass``);
   ``mlstm_build``: the mLSTM kernels' registers, spills, shared memory
   and threads, and the ``HGMMA`` count of each (the scores and state
   passes must have them; no kernel may spill); ``megastep_build``: the
   megastep kernel's registers, spills and stack frame (of the kernel
   and of every function it calls), its local memory and the most lanes
   a block its registers allow (a spill or any local memory fails);
2. ``kernel_vs_plain``: megastep vs its plain PyTorch version on the card,
   one chunk at chunk 1, 8 and 128 and 3 and 4 lanes a block (one warp a
   lane; 500 lanes leave a ragged block at 3), every leaf bit for bit — from the emulation-off census and seeded random states, from
   the default census and seeded random states with random guest-kernel
   tables, and from traced carries with random per-lane policies;
3. ``main_path``: the default census to halt through the kernel, held leaf
   for leaf against the plain version to halt and against the JAX
   package's pinned counts and digest; kernel, driver and plain times,
   lane-steps a second, the host's gap a chunk; with ``--parent`` the
   earlier design's kernel time in turns with this one's (also in 4 and
   6);
4. ``census_emul_off``: the emulation-off census (K1) through the kernel,
   against its pinned counts, and through the plain version;
5. ``churn``: the 400-lane file-churn census with emulation on and with
   the stubs, through the kernel, against pinned counts; both times;
6. ``traced``: the default census traced under all-ALLOW policies (K2),
   against the untraced states, the plain version and the JAX package's
   pinned trace digest; traced and untraced kernel times;
7. ``table3``: the Table-3 per-call cycles (simulated, deterministic);
8. ``flash_vs_plain``: flash attention vs its plain version, every case of
   ``tests/test_kernels.py`` plus ragged lengths, dead window rows, head
   dims 16-256, a 2048 window that binds (S 4096, 10:1 heads of 256),
   both serving paths' prefill shapes and the other families' new shapes
   (``FAMILY_FLASH``): bf16 through the tensor-core kernel (2e-2), f32
   through the SIMT kernel (2e-5);
9. ``decode_vs_plain``: flash-decode likewise, kv_len on and off the tile,
   0 and past the cache, the qwen3-1.7b decode shape, cases that force
   one split and many (kv_len 0 and past Skv among them) and the other
   families' new shapes (``FAMILY_DECODE``); every case called twice, the
   two outputs equal bit for bit;
10. ``serve``: the serving path; its tokens; teacher-forced logits of the
    kernel route against the kernels' plain versions on the card (relative
    L2 within 2e-2, tokens equal outside near-ties) and every attention
    call of that run against its plain version on the same inputs
    (elementwise bf16 bound); prefill ms, decode ms per token, per-kernel
    ms beside bound, plain and ``scaled_dot_product_attention`` times (the
    attention kernels' and SDPA's as device time, from a CUDA graph of the
    calls: eager calls of these small kernels time the host's launch
    path; the eager times are in the phase line too);
11. ``rglru_vs_plain``: the RG-LRU scan kernel vs its plain versions,
    ``tests/test_kernels.py``'s cases, odd lengths and widths, h0 zero and
    not, recurrentgemma-2b's prefill and decode shapes: bit for bit
    against the sequential version, within atol 1e-5 / rtol 1e-4 of the
    associative scan; the prefill and decode device times beside an empty
    kernel's in the same CUDA-graph harness (the launch floor, decode's
    bound with its bytes);
12. ``serve_recurrentgemma``: the hybrid serving path, checked as
    ``serve`` is, every scan call also against both plain versions; the
    kernel route bit for bit equal to the route with the scan's
    sequential plain version; the relative L2 against the plain route held
    to the larger of 2e-2 and the distance between the two plain routes
    (the kernels' plain versions; the JAX model's own functions), which
    26 random-weight layers put above 2e-2;
13. ``mlstm_vs_plain``: the mLSTM kernels vs their plain versions,
    ``tests/test_kernels.py``'s cases, odd lengths, head dims 32 to 512
    (on and off the state pass's 64 columns), a nonzero state, decode
    steps, xlstm-350m's prefill and decode shapes: h, C and n within atol
    3e-4 / rtol 3e-3 of the chunked plain version at the kernels' chunk,
    of the sequential recurrence and of the kernels' own arithmetic in
    plain PyTorch; every case called twice, bit-equal; every decode step
    also in place from a cloned state; device and eager times at both
    serving shapes beside the bound (bf16 tensor-core peak);
14. ``serve_xlstm``: the xLSTM serving path, checked as
    ``serve_recurrentgemma`` is, every mLSTM call also against its plain
    version; the relative L2 against the plain route held to the larger
    of 2e-2 and the largest distance among three plain routes (the
    kernel's chunk of 64; the JAX model's 256 at prefill and 1 at decode;
    the sequential recurrence), which 24 random-weight layers put at
    4-11 %;
15-17. ``serve_moe``, ``serve_encdec``, ``serve_vlm``: the other families,
    each checked as ``serve`` is — launch counts as the model's code
    implies (flash: every self-attention prefill, encoder layer and
    cross-attention prefill; flash-decode: every self- and
    cross-attention decode step), the relative L2 against the plain route
    held to the larger of 2e-2 and the plain routes' own distance, every
    attention call within the bf16 bound of its plain version — and, for
    the MoE, the reference routes taking the kernel route's experts and
    every token whose own choice would differ at a near-tie of its router
    logits (a routing flip at a near-tie counts as a token flip at one
    does); the prefill's dropped slots; each family's prefill and
    decode ms, peak memory, and the attention kernels at every shape it
    launched them at (device time, plain, bound, SDPA);
18. ``streamed``: the default census traced through ``run_fleet_stream``
    into a retaining ``TraceStream`` (cap 64, chunk 128: one chunk a
    span), against the census pin, the JAX package's streamed-record
    count, drops (0) and digest, and phase 6's carry (lifetime counts,
    histograms, each lane's last min(count, 64) records); the driver's ms
    and the host's ms in flips and ``push_block``, beside the traced
    fixed-width driver, in turns;
19. ``admission``: the default census through a 128-lane pool and a
    32-row ``FleetImageTable`` (``admit_lanes``, spans of 512 steps
    through ``run_fleet_span``, harvest with ``finish_halt_codes``; every
    fourth span 8 running lanes checkpointed, their slots given to queued
    processes, the checkpoints put back later with ``restore_lanes``),
    untraced (K3) and traced (K2): every harvested lane equal to phase 3's
    and phase 6's lanes, every admitted ring empty;
20. ``compact``: ``run_fleet_prepared(compact=True)`` on the default
    census, untraced and traced, against the census pins and the JAX
    package's occupancy ledgers; kernel and driver ms, compacted against
    fixed width, in turns;
21. ``fleet_server``: ``repro_torch.serve.fleet_server.FleetServer`` on
    the card — the census through a 128-lane pool, generations of 512
    steps, untraced (K3; every published state equal to phase 3's lane,
    sha256 by rid the census pin) and traced, streamed, compacted and
    observed (K2; 0 records dropped, the records by rid the streamed
    census's, the profiler's phase breakdown on a line of its own); the
    noisy-neighbor mix of benchmarks/policy_scheduler.py at 128 lanes,
    unscheduled and scheduled (every state equal to its solo run,
    evicted lanes restored bit for bit); one C3 request (0 scalar
    re-executions, events equal to ``run_with_c3``'s) — each against the
    JAX server's pins;
22. ``durable_server``: ``repro_torch.serve.durability`` and ``.chaos``
    on the card, one line an arm, each against the JAX server's pins —
    ``durable`` (benchmarks/durability_overhead.py's census at 400
    lanes, plain then durable at snapshot interval 8: every state the
    census pin's by rid, the publication ledgers equal, both wall times
    and the overhead beside the reference's 10 % bar, the snapshots and
    journal records, the profiler's journal and snapshot phases),
    ``kill_recover`` (killed after 11 generations, recovered, drained:
    the union by rid the census), ``traced_recover`` (the
    ``served_traced`` server durable, killed at generation 11: the
    records by rid the census stream's, 0 dropped, the obs counters
    monotone) and ``chaos_soak`` (tests/test_durability.py's soak
    settings on the census at 128 lanes: the injection ledger, every
    published state the census lane's but those a bit-flip reached
    before a boundary verified it, which differ by that bit alone);
23. ``shard``: the census (K3) through ``run_fleet_prepared(shard=True)``,
    a ``FleetServer(shard=True)`` and a durable one, on every visible
    card: the census pins, the JAX server's and durable server's pins, the
    journal's ``open`` record ``shard: true``; ``engine="pallas"`` with
    ``shard=True`` raises ``ValueError``;
24. ``train_pins``: for qwen3-1.7b and recurrentgemma-2b SMOKE,
    numpy-seeded parameters saved as a step-0 checkpoint, 10 steps of
    ``run_training`` straight and again with an ``InjectedFailure`` at
    step 5 and the auto-resume: every loss within 2e-2 relative of the
    JAX package's (``TRAIN_PINS``), the resumed run equal to the straight
    one bit for bit (losses and every leaf of the final state), no model
    kernel launched;
25. ``train_full``: qwen3-1.7b at full width and depth, every tile
    checkpointed, loss chunks of 128: every leaf's gradient finite and
    not all zero, step 0's CE within 2e-2 relative of the kernel route's
    logits on the same batch (28 flash launches there), three steps with
    no model kernel launched, each kernel wrapper raising on inputs that
    require grad; step ms, tokens/s and peak GiB;
26. ``collective_hooks``: qwen3-1.7b at full width and depth, the
    ``train_full`` run and batch, on a one-rank NCCL world; each arm from
    the same seeded state, two steps, freed before the next: the census
    of ``make_ddp_train_step`` (sites, primitives, payload bytes) equal to
    the JAX package's census of its own (``HOOK_CENSUS``); the DDP step
    unhooked, under a ``TraceHandler`` and under ``RSAGHandler(1)`` equal
    to ``make_train_step`` bit for bit (every parameter and moment; a
    second ``make_train_step`` run shows the step reproduces itself), the
    trace's count and bytes each step the census's, RSAG rewriting every
    non-scalar site; ``CastCompressHandler`` compressing every f32
    gradient leaf of 64 KiB or more, its loss after step 2 and its
    ``grad_norm`` at each step within 2e-2 relative of the unhooked
    step's, and after step 1 each leaf's gradient (``m / ((1 - b1) c)``,
    c the clip factor) within relative L2 2e-2 of the unhooked step's;
    one profiled hooked step whose backend
    all-reduces equal the census's executions (``fully_hooked``); step ms
    of every arm; then 5 steps each, unhooked and traced, in turns from
    one state: the hook's µs an intercepted call and an operator
    dispatched through it, from the medians;
27. ``examples``: the quickstart's text equal to the JAX example's
    (``QUICKSTART_TEXT``), the megastep kernel launched; serve_demo for
    each arch of ``EXAMPLE_SERVE``, each kernel on its path launched and
    the others not, its run teacher-forced through the kernels (every
    call held to its plain version) and through their plain versions
    (relative L2 within 2e-2, tokens equal outside near-ties);
    hooked_training's census equal to the JAX package's
    (``HOOKED_CENSUS``: 17 sites), no model kernel launched, and against
    the same run on the CPU its learning rates equal, its three losses
    within 2e-3 relative, the norm of its parameters' change within 2e-4
    and its final parameters within 0.2 of that change; then
    ``fleet_step_traced`` 100 steps on 3 lanes on the card and on the
    CPU, every leaf equal at every step, ``fleet_step`` equal to it;
28. ``dryrun``: first, here with no process group, the ``train_full``
    cell's step on real tensors under ``opanalysis.analyze``, then three
    steps timed alone (nothing else running on the host) with
    ``max_memory_allocated``; then ``python -m repro_torch.launch.dryrun``
    at full width on fake ``cuda`` tensors (no card memory), each cell in
    a process of its own, all started together: qwen3-1.7b ``train_4k``
    and recurrentgemma-2b ``long_500k`` on 16x16 and 2x16x16 fake worlds,
    then on 16x16 one cell a repair of the layouts DTensor refused —
    dbrx-132b ``decode_32k`` (the MoE's routing), gemma-7b ``train_4k``
    (attention over whole heads), recurrentgemma-2b ``prefill_32k`` (the
    ring's prefill writes) and xlstm-350m ``train_4k`` (the xLSTM's
    products on each rank's shards, its loops counted from one step,
    ``while_trips``): every cell ``OK`` with a dominant term, dot FLOPs
    and bytes above zero, one line a cell with ``fits_hbm``, the roofline
    terms and ``while_trips``; meanwhile, here, the same step
    under ``opanalysis.analyze`` on fake tensors: dot FLOPs equal to the
    JAX package's one-device HLO count (``DRYRUN_DOT_FLOPS``) fake and
    real, no collective, the predicted peak bytes beside
    ``max_memory_allocated`` and the median step beside the roofline
    bound (H100 datasheet figures);
29. the kernel table line (the megastep's launches on every path, the
    attention kernels at every family's shapes, each kernel's launches in
    the examples), the card line, then the device line (last).

Needs one card; with none it exits with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import (  # noqa: E402
    FleetImageTable, HookConfig, Mechanism, fleet, fleet_step,
    fleet_step_traced, initial_state, interop, pack_fleet,
    precompile_compact, prepare, programs, run_fleet_prepared,
    run_fleet_span, run_prepared, run_with_c3)
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core import costmodel as cm  # noqa: E402
from repro_torch.core import layout as L  # noqa: E402
from repro_torch.core.hookcfg import PolicyRule  # noqa: E402
from repro_torch.core.machine import HALT_EXIT, MachineState  # noqa: E402
from repro_torch.core.runtime import fleet_trace  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    RunConfig, ShapeConfig, get_config, get_smoke)
from repro_torch.data.pipeline import TokenStream  # noqa: E402
from repro_torch.emul import state as emul_state  # noqa: E402
from repro_torch.examples import hooked_training as ex_hooked  # noqa: E402
from repro_torch.examples import quickstart as ex_quickstart  # noqa: E402
from repro_torch.examples import serve_demo as ex_serve  # noqa: E402
from repro_torch.hooks import (  # noqa: E402
    CastCompressHandler, RSAGHandler, TraceHandler,
    backend_collective_census, census_fn, completeness_report, hooking)
from repro_torch.kernels import nvcc  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dkernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.megastep import kernel as mkernel  # noqa: E402
from repro_torch.kernels.megastep import ops as mops  # noqa: E402
from repro_torch.kernels.megastep.ref import megastep_chunk_ref  # noqa: E402
from repro_torch.kernels.mlstm_chunk import kernel as xkernel  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ops as xops  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ref import (  # noqa: E402
    mlstm_chunk_ref, mlstm_decode_ref, mlstm_seq, mlstm_tc_ref)
from repro_torch.kernels.rglru_scan import kernel as rkernel  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    rglru_scan_ref, rglru_scan_seq)
from repro_torch.launch import dryrun, opanalysis  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import recurrent as rec  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.sched import PolicyScheduler, TenantBudget  # noqa: E402
from repro_torch.serve.chaos import ChaosMonkey  # noqa: E402
from repro_torch.serve.durability import (  # noqa: E402
    DurabilityManager, Journal)
from repro_torch.serve.engine import (  # noqa: E402
    Request, ServeEngine, model_input)
from repro_torch.serve.fleet_server import FleetServer  # noqa: E402
from repro_torch.trace import policy as tpolicy  # noqa: E402
from repro_torch.trace import recorder  # noqa: E402
from repro_torch.trace.stream import TraceStream  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    grads_and_metrics, init_train_state, make_ddp_train_step,
    make_train_step)

# -- the census deployment (a copy of benchmarks/collective_hook_overhead.py)
FUEL = 10_000_000
CHUNK = 128

MECHS = [
    ("none", Mechanism.NONE, False),
    ("ld_preload", Mechanism.LD_PRELOAD, True),
    ("asc", Mechanism.ASC, True),
    ("signal", Mechanism.SIGNAL, True),
    ("ptrace", Mechanism.PTRACE, True),
]

CHURN_NBYTES = 512
WORKLOADS = {
    "getpid": programs.getpid_loop_param,
    "read": lambda: programs.read_loop_param(1024),
    "mixed": lambda: programs.mixed_ops_param(512),
    "io_bw": lambda: programs.io_bandwidth_param(4096),
    "churn": lambda: programs.file_churn_param(CHURN_NBYTES),
}

_BASE_ITERS = {  # ~8000 steps / measured steps-per-iter, rounded
    "getpid": {"none": 1140, "ld_preload": 530, "asc": 140,
               "signal": 260, "ptrace": 1140},
    "read": {"none": 730, "ld_preload": 730, "asc": 130,
             "signal": 230, "ptrace": 730},
    "mixed": {"none": 220, "ld_preload": 220, "asc": 30,
              "signal": 60, "ptrace": 220},
    "io_bw": {"none": 350, "ld_preload": 350, "asc": 60,
              "signal": 110, "ptrace": 350},
    "churn": {"none": 174, "ld_preload": 174, "asc": 32,
              "signal": 48, "ptrace": 174},
}
SCALES = tuple(round(1.0 - 0.01 * i, 2) for i in range(20))
# the churn census of benchmarks/emul_overhead.py: every mechanism x 80
# iteration counts of file_churn_param(512)
CHURN_SCALES = tuple(round(1.0 - 0.005 * i, 3) for i in range(80))

# What the JAX package gives for these runs (CPU, chunk 128, fuel 10M).
# Deterministic counts and digests, not timings; tests/test_torch_*.py pin
# the same numbers.
# The census with emulation off (slice 1's path):
CENSUS_EXPECTED = {"lanes": 500, "total_steps": 3_603_972,
                   "longest_lane_steps": 8_306, "enosys_total": 10_850}
# The census at the default HookConfig, and the sha256 of its 34 final
# leaves (each leaf's int64 bytes, in field order):
CENSUS_DEFAULT_EXPECTED = {"lanes": 500, "total_steps": 3_603_972,
                           "longest_lane_steps": 8_306, "enosys_total": 0,
                           "emul_served_total": 198_696}
CENSUS_DEFAULT_SHA256 = (
    "bf093bebe619e2036172469be1f2764435d3ca56cb2e1eeed607dd558a9c743a")
# The default census traced (cap 64, all-ALLOW): records and the sha256 of
# the 10 TraceState leaves:
TRACED_EXPECTED = {"records_total": 263_036, "deny": 0, "emul": 0, "kill": 0}
TRACED_SHA256 = (
    "f1897933d161359b5aa5aec31df4ff583e529837bfdceb76a9d78997b159a51b")
# The default census traced and streamed (cap 64, chunk 128: one chunk a
# span) into a retaining TraceStream: the records it received, its drops
# and flips, and the sha256 of every streamed record (stream_digest):
STREAMED_EXPECTED = {"records_seen": 263_036, "records_dropped": 0,
                     "flips": 65}
STREAMED_SHA256 = (
    "f9fbf1382a101793696a5e5794353fd6e07aff48318df9b8fc44a2ecea67d5b1")
# The default census compacted (HookConfig's ladder: 500, then 256 down to
# 8 lanes, hysteresis 0.125, spans of 8 chunks): its occupancy ledger,
# untraced and traced:
COMPACT_STATS = {"ladder": [500, 256, 128, 64, 32, 16, 8], "interval": 1024,
                 "dispatches": 9,
                 "compactions": [{"from": 500, "to": 8, "live": 2}],
                 "final_bucket": 8, "dispatched_lane_steps": 4_097_024,
                 "useful_steps": 3_603_972, "occupancy": 0.8797,
                 "wasted_lane_steps": 493_052}
COMPACT_STATS_TRACED = COMPACT_STATS  # tracing changes no lane's steps
# The churn census (benchmarks/results/BENCH_emul.json):
CHURN_EXPECTED = {
    "emul": {"lanes": 400, "total_steps": 2_557_520, "emul_served_total":
             192_280, "enosys_total": 0},
    "stub": {"lanes": 400, "total_steps": 2_557_520, "emul_served_total": 0,
             "enosys_total": 38_456},
}
# Table 3 of the paper as the cost model reproduces it (simulated cycles).
TABLE3_CYCLES = {"ld_preload": 18.0, "asc": 105.0, "signal": 2812.0,
                 "ptrace": 5940.0}
N_HI, N_LO = 400, 200  # benchmarks/hook_overhead.py's differential
# examples/quickstart.py's text (the JAX package's, run on the CPU): the
# port's example prints it on the card
QUICKSTART_TEXT = "\n".join([
    '=== Table 3: hooking a virtualised getpid ===',
    '  ld_preload       11.0 ns/call  pid=7777 hooks=100',
    '  asc              42.4 ns/call  pid=7777 hooks=101',
    '  signal         1017.6 ns/call  pid=7777 hooks=101',
    '  ptrace         2145.9 ns/call  pid=7777 hooks=101',
    '',
    "=== ASC-Hook rewrite report (the paper's §3.1) ===",
    "  {'svc_total': 8, 'r1': 6, 'r2': 0, 'r3': 2, 'l1_slots': 6, 'trampoline_bytes': 440}",
    '  svc@0x18004 libc.so+0x4 nr=172 -> pair',
    '  svc@0x18018 libc.so+0x18 nr=63 -> pair',
    '  svc@0x18028 libc.so+0x28 nr=64 -> pair',
    '  svc@0x18034 libc.so+0x34 nr=56 -> pair',
    '  svc@0x18040 libc.so+0x40 nr=57 -> pair',
    '  svc@0x1804c libc.so+0x4c nr=93 -> pair',
    '  svc@0x18054 libc.so+0x54 nr=-1 -> no_x8',
    '  svc@0x18060 libc.so+0x60 nr=172 -> jump_between',
    '',
    '=== Figure 4: indirect jump onto an svc (strategy C3) ===',
    '  executions: 2 (fault -> config -> re-exec)',
    '  pinned: libc.so+0x4 syscall=172',
    '  final pid: 7777 (virtualised: 7777)',
])

# -- the fleet server (serve/fleet_server.py) --------------------------------
# The census served through a 128-lane pool (the admission phase's width),
# generations of 512 steps in chunks of 128; then the noisy-neighbor mix of
# benchmarks/policy_scheduler.py (its full-size arguments) scaled from a
# pool of 8 to 128: 16x the storms and victims, the same iterations,
# budget, deadline, generation and chunk.
FS_POOL = 128
FS_GEN_STEPS = 4 * CHUNK
SCHED_MIX = {"pool": 128, "gen_steps": 256, "chunk": 64, "n_noisy": 192,
             "n_victim": 128, "storm_iters": 200, "victim_iters": 12,
             "budget_svc": 1500, "deadline_steps": 512}
# What the JAX package's FleetServer gives for these runs (CPU;
# scripts/torch_port_pins.py): the census served untraced, then traced,
# streamed, compacted and observed (its publication ledger and stats; the
# streamed records by rid must also give STREAMED_SHA256), the mix
# unscheduled and scheduled (scheduler counters, victims' latency in
# generations), and one C3 request served after the scheduled mix.
FS_SERVED_EXPECTED = {
    "generations": 61, "dispatches": 61, "completed": 500,
    "harvested_steps": 3_603_972, "discarded_steps": 0, "c3_readmissions": 0,
    "scalar_reexecutions": 0, "image_admissions": 20, "image_dedup_hits": 480,
    "enosys_total": 0, "emul_served_total": 198_696, "trace_records": 0,
    "trace_dropped": 0, "trace_histogram": {}, "dispatched_steps": 3_981_312,
    "executed_steps": 3_603_972, "occupancy": 0.9052, "pool_grows": 0,
    "pool_shrinks": 0, "min_bucket_seen": 128, "admission_waits": 500,
    "admission_wait_gens_mean": 21.302, "admission_wait_gens_max": 46,
    "resume_waits": 0, "stream": {},
    "ledger_sha256":
        "0f879bf83896f6350b970a2dcaa05c8c1e9f6bc98eb1a8185aca3cda9589b6d4"}
FS_TRACED_EXPECTED = {
    **FS_SERVED_EXPECTED, "trace_records": 263_036,
    "trace_histogram": {
        "read": {"ALLOW": 92_544}, "write": {"ALLOW": 46_534},
        "getpid": {"ALLOW": 41_252}, "exit": {"ALLOW": 500},
        "rt_sigreturn": {"ALLOW": 22_588}, "openat": {"ALLOW": 24_384},
        "close": {"ALLOW": 24_384}, "lseek": {"ALLOW": 10_850}},
    "dispatched_steps": 3_853_312, "occupancy": 0.9353, "pool_shrinks": 3,
    "min_bucket_seen": 8,
    "stream": {"records_seen": 263_036, "records_emitted": 263_036,
               "records_dropped": 0, "flips": 244, "buffered_records": 0}}


def _tenant(submitted, svc, evictions=0, budget_exhaustions=0) -> dict:
    return {"submitted": submitted, "completed": submitted, "svc": svc,
            "deny": 0, "emul": 0, "kill": 0, "enosys": 0, "killed": 0,
            "preemptions": 0, "evictions": evictions,
            "budget_exhaustions": budget_exhaustions, "policy_updates": 0,
            "shed": 0}


FS_SCHED_EXPECTED = {
    "unscheduled": {
        "generations": 110, "idle_generations": 0, "preemptions": 0,
        "evictions": 0, "budget_exhaustions": 0, "quarantine_blocks": 0,
        "trace_records": 12_416, "trace_dropped": 141_504,
        "quarantine_events": 0,
        "tenants": {"noisy": _tenant(192, 153_792),
                    "victim": _tenant(128, 128)},
        "victim_latency_gens": {"p50": 58.5, "p95": 60.0, "max": 60},
        "noisy_latency_gens": {"p50": 55.0, "p95": 110.0},
        "preempted_results": 0,
        "ledger_sha256":
            "fb90111b4c5173eb37fd2cc107fa6fcdc9f3af04c604212f52b6fd59a7f43dac"},
    "scheduled": {
        "generations": 5010, "idle_generations": 4924, "preemptions": 0,
        "evictions": 10_368, "budget_exhaustions": 81,
        "quarantine_blocks": 4926, "trace_records": 12_416,
        "trace_dropped": 141_504, "quarantine_events": 81,
        "tenants": {"noisy": _tenant(192, 153_792, 10_368, 81),
                    "victim": _tenant(128, 128)},
        "victim_latency_gens": {"p50": 3.0, "p95": 3.0, "max": 3},
        "noisy_latency_gens": {"p50": 5009.0, "p95": 5010.0},
        "preempted_results": 192,
        "ledger_sha256":
            "fae8b1c67f60058a38c87bc2be1205ab79902559bf04124cd813c2a877508408"}}
FS_C3_EXPECTED = {
    "events": [{"syscall_nr": 172, "svc_addr": 98_308, "lib": "libc.so",
                "offset": 4}],
    "attempts": 2, "halted": 1, "c3_readmissions": 1,
    "scalar_reexecutions": 0,
    "state_sha256":
        "0a7f1e8cf0e41e4d2014c506667d472c513694b62b199f70ed46d963d25ed5a4"}

# -- durable serving and chaos (serve/durability.py, serve/chaos.py) ---------
# The durable arm is benchmarks/durability_overhead.py's run_bench: the
# census through a 400-lane pool, generations of 512 steps in chunks of
# 128, a snapshot every 8 generations, the journal fsync'd at its commit
# points (HookConfig's default), untraced; both runs observed, for the
# profiler's journal and snapshot phases.  kill_recover is its
# run_kill_recover (killed after DUR_INTERVAL + 3 generations);
# traced_recover kills fleet_server's served_traced server, durable at
# interval 8, at generation 11; the soak is tests/test_durability.py's
# chaos settings on the census at FS_POOL lanes, untraced.
DUR_POOL = 400
DUR_INTERVAL = 8
DUR_KILL = DUR_INTERVAL + 3
TRACED_KILL = 11
SOAK_CFG = {"snapshot_interval": 3, "journal_fsync": False,
            "serve_watchdog_s": 0.001, "chaos_seed": 7,
            "chaos_dispatch_fault_rate": 0.12, "chaos_hang_rate": 0.04,
            "chaos_bitflip_rate": 0.35, "chaos_snapshot_corrupt_rate": 0.25,
            "chaos_max_retries": 2, "chaos_backoff_base_ms": 0}
OVERHEAD_BAR_PCT = 10.0    # the reference benchmark's bar, printed only
# What the JAX package's FleetServer gives for these arms (CPU;
# scripts/torch_port_pins.py --only durable).  The soak's two escaped
# flips and its unresolved one are the reference's (ROADMAP Queue 3
# item 4), and so is its recovery_generations (item 5).
DURABLE_EXPECTED = {
    "generations": 30, "snapshots": 3, "journal_records": 534,
    "ledger_sha256":
        "1a8ac7600a4a9b9b7e4072d4b4ba3d5ec166327b83a010a754ec56be0bfeba2f"}
KILL_RECOVER_EXPECTED = {"killed_at_generation": 11,
                         "replayed_generations": 3, "replayed_results": 0}
TRACED_RECOVER_EXPECTED = {**KILL_RECOVER_EXPECTED, "records": 263_036}
CHAOS_SOAK_EXPECTED = {
    "injections": 26,
    "by_kind": {"corrupt": 8, "bitflip": 8, "hang": 4, "dispatch": 6},
    "by_resolution": {"rewritten": 8, "rolled_back": 7, "retried": 10,
                      "UNRESOLVED": 1},
    "unresolved": 1, "generations": 61, "rollbacks": 6, "retries": 10,
    "recovery_generations": 189, "watchdog_trips": 4, "snapshots": 20,
    "snapshot_rewrites": 8, "shed_rids": [],
    "ledger_sha256":
        "1640ac03331280519981aa59cd2567f354c2813a562ccd1241259a2f7a99801a",
    "escaped_flip_rids": [222, 480]}

# -- the bound's counting rules (PERF.md section 6) ---------------------------
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT_OPS_PER_S = 67e12      # the card's float32 rate; its int64 rate is lower
OPS_PER_STEP = 128         # integer operations in one step's common path
SMALL_WORDS = 173          # carry words of a lane but mem and k_ino_data
CHECK_BLOCKS = (3, 4)      # lanes a block in kernel_vs_plain
PARENT_BLOCK = 32          # the one-thread-a-lane design's lanes a block
SPIN_CYCLES = 20_000_000   # ~10 ms of spin: the host queues launches behind it
REC_BYTES = 8 * fleet.REC_WORDS  # one trace ring row
HIST_BUMP_BYTES = 16       # one histogram word read and written
# a traced lane's policy rows (int32 action + int64 arg a slot), read once,
# and its 6 trace scalars, read and written once
TRACE_LANE_BYTES = fleet.N_POLICY_SLOTS * 12 + 6 * 8 * 2

# -- the LM serving path (qwen3-1.7b) and its attention kernels --------------
BF16_OPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12     # H100 SXM float32 peak outside the tensor cores
# tests/test_kernels.py:26-27: the kernels' bounds, by input dtype
TOLS = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2)}
# (B, Sq, Skv, Hq, Hkv, hd, causal, window): tests/test_kernels.py:35-42,
# then ragged lengths, a window whose rows past Skv - 1 + window have no
# live key (Sq > Skv), the other head dims, and the qwen3-1.7b prefill
FLASH_CASES = (
    (2, 128, 128, 4, 4, 64, True, 0),      # MHA causal
    (1, 256, 256, 8, 2, 64, True, 0),      # GQA 4:1
    (2, 128, 128, 4, 1, 128, True, 0),     # MQA
    (1, 256, 256, 4, 4, 64, False, 0),     # bidirectional
    (1, 256, 256, 4, 2, 64, True, 64),     # local window
    (1, 512, 512, 2, 2, 128, True, 128),   # longer + window
    (2, 100, 100, 4, 2, 128, True, 0),     # ragged
    (1, 77, 200, 4, 2, 64, False, 0),      # ragged, Sq != Skv
    (1, 300, 300, 2, 1, 128, True, 96),    # ragged window
    (1, 200, 130, 2, 2, 64, True, 16),     # dead rows past the keys
    (1, 64, 64, 4, 2, 16, True, 0),        # head dim 16
    (1, 128, 128, 2, 1, 256, True, 0),     # head dim 256
    (1, 4096, 4096, 10, 1, 256, True, 2048),  # recurrentgemma's window binds
)
QWEN_PREFILL = (8, 512, 512, 16, 8, 128, True, 0)
RG_PREFILL = (8, 512, 512, 10, 1, 256, True, 2048)
# (B, Skv, Hq, Hkv, hd, kv_len): tests/test_kernels.py:80-85, then kv_len
# off the tile, kv_len 0 (every position masked) and past Skv, the other
# head dims and group sizes, and the qwen3-1.7b decode shape
DECODE_CASES = (
    (2, 512, 8, 2, 64, 512),
    (2, 512, 8, 2, 64, 300),
    (1, 1024, 4, 1, 128, 1000),
    (4, 256, 4, 4, 64, 256),
    (3, 200, 8, 2, 128, 77),
    (1, 64, 4, 2, 64, 0),
    (1, 64, 4, 2, 64, 100),
    (1, 300, 4, 4, 16, 300),
    (2, 256, 10, 1, 256, 129),
)
QWEN_DECODE = (8, 576, 16, 8, 128, 529)
SERVE_ARCH = "qwen3-1.7b"
SERVE_BATCH, SERVE_NEW, SERVE_BUDGET = 8, 32, 64
SERVE_PROMPT_LENS = (64, 512)  # shortest and longest prompt
RG_ARCH = "recurrentgemma-2b"
# (B, Skv, Hq, Hkv, hd, kv_len) that force the decode split: one split
# (B * Hkv covers the card twice; kv_len under 2 * 64), many splits (a long
# cache over few rows), kv_len 0 and past Skv under many splits
DECODE_SPLIT_CASES = (
    (33, 512, 16, 8, 128, 500),     # B * Hkv 264: one split
    (2, 256, 8, 2, 64, 100),        # 100 positions: one split
    (1, 4096, 8, 2, 128, 4000),     # 62 splits
    (1, 2048, 4, 1, 256, 0),        # every position masked, 32 splits
    (2, 1024, 8, 4, 64, 5000),      # past Skv, 16 splits
    (1, 999, 16, 1, 16, 998),       # G 16, 15 splits
)
# the kernel instance each main path launches (bf16; head dim 128 for
# qwen3-1.7b, 256 for recurrentgemma-2b), by its mangled name
MAIN_INSTANCE = {"flash_attention": "flash_tc_kernelILi128ELi2EE",
                 "decode_attention": "decode_split_kernelI13__nv_bfloat16"
                                     "Li128ELi2EE"}
RG_INSTANCE = "flash_tc_kernelILi256ELi1EE"
# the RG-LRU scan: tests/test_kernels.py:131's bound, its cases
# (tests/test_kernels.py:118-122), odd lengths and widths, and the
# recurrentgemma-2b serving shapes (B, S, d_rnn): prefill and decode
SCAN_TOL = (1e-5, 1e-4)
RGLRU_CASES = ((2, 256, 256), (1, 512, 512), (3, 128, 1024),
               (2, 1, 300), (2, 5, 130), (2, 100, 333), (1, 777, 64))
RG_SCAN_PREFILL, RG_SCAN_DECODE = (8, 512, 2560), (8, 1, 2560)
# the mLSTM: tests/test_kernels.py:165-166's bound; (B, S, H, dh, a
# nonzero state?): tests/test_kernels.py:149-154's (BH, S, dh) cases as
# (BH, S, 1, dh), odd lengths (100, 513), a nonzero state, decode steps
# from one, and head dims on both sides of the state pass's 64 columns
# (32: one block, half empty; 96 and 160: a last block half empty, an odd
# count of 64-wide slices); the xlstm-350m serving shapes come after
# (mlstm_phase)
MLSTM_TOL = (3e-4, 3e-3)
MLSTM_CASES = ((2, 128, 1, 64, False), (4, 256, 1, 128, False),
               (1, 256, 1, 64, False), (1, 128, 1, 64, False),
               (2, 100, 2, 64, False), (1, 513, 2, 128, False),
               (2, 150, 4, 64, True), (3, 1, 4, 128, True),
               (2, 70, 4, 512, True), (2, 100, 2, 32, True),
               (1, 130, 2, 96, True), (2, 65, 2, 160, True),
               (3, 1, 2, 96, True), (2, 1, 2, 32, True))
XL_ARCH = "xlstm-350m"
XL_PREFILL, XL_DECODE = (8, 512, 4, 512), (8, 1, 4, 512)
# the other model families, served as qwen3-1.7b is: the MoE at full
# width and depth (14.32 B parameters, 57.3 GB in f32), the
# encoder-decoder at full size (its encoder input 512 // 8 = 64 frames),
# the patch-prefix decoder at full width and VLM_LAYERS of its 60 layers
# (39.4 GB in f32; all 60 would be 137.6 GB), its prefix 512 // 8 = 64
# positions before the tokens
MOE_ARCH = "qwen2-moe-a2.7b"
ENCDEC_ARCH = "seamless-m4t-medium"
VLM_ARCH, VLM_LAYERS = "llava-next-34b", 16
# their attention shapes that no earlier path runs: the encoder
# (non-causal, 64 x 64, hd 64), the cross-attention prefill (512 x 64) and
# decode (the whole 64-frame cache), the prefix-extended prefill (576,
# GQA 7) and its decode (group 7)
FAMILY_FLASH = ((8, 64, 64, 16, 16, 64, False, 0),
                (8, 512, 64, 16, 16, 64, False, 0),
                (8, 576, 576, 56, 8, 128, True, 0))
FAMILY_DECODE = ((8, 64, 16, 16, 64, 64), (8, 640, 56, 8, 128, 577))


def randn(shape, dtype, rng, device):
    """Seeded N(0, 1) values (numpy), as ``dtype`` on ``device``."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(device=device, dtype=dtype)


def flash_inputs(case, dtype, seed, device):
    B, Sq, Skv, Hq, Hkv, hd, _, _ = case
    rng = np.random.default_rng(seed)
    return (randn((B, Sq, Hq, hd), dtype, rng, device),
            randn((B, Skv, Hkv, hd), dtype, rng, device),
            randn((B, Skv, Hkv, hd), dtype, rng, device))


def decode_inputs(case, dtype, seed, device):
    B, Skv, Hq, Hkv, hd, _ = case
    rng = np.random.default_rng(seed)
    return (randn((B, 1, Hq, hd), dtype, rng, device),
            randn((B, Skv, Hkv, hd), dtype, rng, device),
            randn((B, Skv, Hkv, hd), dtype, rng, device))


def over_bound(got, want, dtype, tol=None) -> tuple:
    """(max |got - want|, elements over atol + rtol * |want|); (atol,
    rtol) is ``tol``, else the bound of the inputs' dtype."""
    atol, rtol = tol or TOLS[dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    return float(err.max()), int((err > atol + rtol * w.abs()).sum())


def flash_work(case, dtype) -> tuple:
    """(bytes, operations) the flash function needs: q, k, v read once and
    the output written once; 4 * hd operations per live (query, key) pair
    (2 for q.k, 2 for p.v)."""
    B, Sq, Skv, Hq, Hkv, hd, causal, window = case
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Skv)[None, :]
    live = np.ones((Sq, Skv), bool)
    if causal:
        live &= kp <= qp
    if window:
        live &= kp > qp - window
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * hd * (2 * B * Sq * Hq + 2 * B * Skv * Hkv)
    return nbytes, 4 * hd * int(live.sum()) * B * Hq


def decode_work(case, dtype) -> tuple:
    """(bytes, operations) one decode launch needs: q read and the output
    written once, the live cache positions (min(kv_len, Skv)) of K and V
    read once; 4 * hd operations per (query row, live position)."""
    B, Skv, Hq, Hkv, hd, kv_len = case
    live = min(kv_len, Skv) if kv_len >= 1 else Skv
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * hd * (2 * B * Hq + 2 * B * Hkv * live)
    return nbytes, 4 * hd * live * B * Hq


def scan_inputs(case, seed, device, *, zero_h0=False):
    """tests/test_kernels.py's RG-LRU inputs from a numpy seed: a decay in
    (0, 1), b at scale 0.5, h0 standard normal (or zero)."""
    B, S, dr = case
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.standard_normal((B, S, dr), np.float32)))
    b = 0.5 * rng.standard_normal((B, S, dr), np.float32)
    h0 = rng.standard_normal((B, dr), np.float32)
    if zero_h0:
        h0[:] = 0
    return tuple(torch.from_numpy(x).to(device) for x in (a, b, h0))


def scan_work(case) -> tuple:
    """(bytes, operations) of one scan: a and b read once, h0 read once,
    h written once; one multiply and one add a step and channel."""
    B, S, dr = case
    return 4 * (3 * B * S * dr + B * dr), 2 * B * S * dr


def mlstm_inputs(case, seed, device, *, state=None):
    """tests/test_kernels.py's mLSTM inputs from a numpy seed, q/k/v
    rounded to bf16: N(0, 1) q, k, v and log i, log f = log sigmoid of
    N(0, 2^2); the state zero, N(0, 0.1^2), or ``state`` (C, n)."""
    B, S, H, dh = case[:4]
    rng = np.random.default_rng(seed)
    q, k, v = (randn((B, S, H, dh), torch.bfloat16, rng, device)
               for _ in range(3))
    log_f = -torch.nn.functional.softplus(-2 * randn((B, S, H), torch.float32,
                                                     rng, device))
    log_i = randn((B, S, H), torch.float32, rng, device)
    if state is not None:
        C0, n0 = state
    else:
        scale = 0.1 if len(case) > 4 and case[4] else 0.0
        C0 = scale * randn((B, H, dh, dh), torch.float32, rng, device)
        n0 = scale * randn((B, H, dh), torch.float32, rng, device)
    return q, k, v, log_f.contiguous(), log_i, C0, n0


def mlstm_work(case, K: int = xkernel.CHUNK) -> tuple:
    """(bytes, operations) of one mLSTM call in chunks of K: q, k, v (bf16)
    and the gates read once, (C0, n0) read and (C, n) written once, h (f32)
    written once; per chunk of kc live rows, 4 dh operations per causal
    pair (the gated score and its use against v) and 4 dh^2 + 4 dh per row
    (the read of C and n, the update of C and n)."""
    B, S, H, dh = case[:4]
    nbytes = (3 * 2 + 4) * B * S * H * dh + 2 * 4 * B * S * H \
        + 2 * 4 * B * H * (dh * dh + dh)
    ops = 0
    for t0 in range(0, S, K):
        kc = min(K, S - t0)
        ops += 4 * dh * kc * (kc + 1) // 2 + kc * (4 * dh * dh + 4 * dh)
    return nbytes, ops * B * H


def bound_ms(nbytes: int, ops: int, dtype) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the peak rate for the type."""
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Mean device ms of ``fn()``: ``reps`` calls captured in a CUDA graph,
    the graph replayed ``rounds`` times between CUDA events (no host
    launch path in the time)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(rounds):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (rounds * reps)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean ms of ``fn()`` on the card: CUDA events around ``reps`` calls
    after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def serve_requests(vocab: int, seed: int = 0) -> list:
    """SERVE_BATCH seeded prompts, lengths in SERVE_PROMPT_LENS (both ends
    taken), SERVE_NEW new tokens each."""
    rng = np.random.default_rng(seed)
    lo, hi = SERVE_PROMPT_LENS
    lens = rng.integers(lo, hi + 1, SERVE_BATCH)
    lens[0], lens[-1] = lo, hi
    return [Request(rng.integers(0, vocab, int(n)).astype(np.int32),
                    max_new_tokens=SERVE_NEW) for n in lens]


# the model's attention, RG-LRU scan and mLSTM: on the card, the routes to
# the kernels; and the MoE's router
ATTENTION = lm.attention
SCAN = rec.rglru_scan
MLSTM = rec.mlstm_chunk
ROUTE = moe_lib.route
# the model's own plain attention (the JAX package's form, bf16
# probabilities before P V)
MODEL_ATTENTION = layers.attention_plain


def plain_attention(q, k, v, *, causal, window=0, kv_len=None, chunk=0,
                    chunk_remat=False):
    """The kernels' plain versions in the model's attention's place: the
    reference the kernel route is held to on the card.  Prefill (no
    ``kv_len``) takes flash attention's, decode flash-decode's (``chunk``
    and ``chunk_remat``, the model's plain form's, do not apply)."""
    if kv_len is None:
        return fops.flash_attention_plain(q, k, v, causal=causal,
                                          window=window)
    return dops.decode_attention_plain(q, k, v, kv_len)


def plain_mlstm(q, k, v, log_f, log_i, C0, n0, *, chunk, out=None):
    """The mLSTM kernels' plain version at the kernels' own chunk, in the
    model's mLSTM's place: the reference the kernel route is held to on
    the card.  The plain routes return the new state as new tensors
    (``out`` is not used; the model copies the state into its cache)."""
    return mlstm_chunk_ref(q, k, v, log_f, log_i, C0, n0, xkernel.CHUNK)


def model_mlstm(q, k, v, log_f, log_i, C0, n0, *, chunk, out=None):
    """The JAX model's own form: the plain version at the model's chunk
    (``run.mlstm_chunk`` at prefill, 1 at decode)."""
    return mlstm_chunk_ref(q, k, v, log_f, log_i, C0, n0, chunk)


def seq_mlstm(q, k, v, log_f, log_i, C0, n0, *, chunk, out=None):
    """The definitional recurrence, one step at a time."""
    return mlstm_seq(q, k, v, log_f, log_i, C0, n0)


def teacher_forced(cfg, run, params, toks, plen, tokens, *,
                   attention=ATTENTION, scan=SCAN, mlstm=MLSTM, route=ROUTE):
    """Prefill logits, then one decode step per new token fed with
    ``tokens`` (B, n) at positions past the prompt (and the prefix of a
    frontend model), the model's input as the engine builds it, with
    ``attention``, ``scan``, ``mlstm`` and ``route`` in the places of the
    model's attention, RG-LRU scan, mLSTM and MoE router: [(B, V) logits]
    * (n + 1), with the prefill and per-token decode ms (host clock,
    synchronised)."""
    lm.attention, rec.rglru_scan, rec.mlstm_chunk = attention, scan, mlstm
    moe_lib.route = route
    try:
        batch, npfx = model_input(cfg, toks, plen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(cfg, run, params, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        out = [logits]
        t0 = time.perf_counter()
        for t in range(tokens.shape[1]):
            logits, cache = lm.decode_step(cfg, run, params, cache,
                                           tokens[:, t:t + 1],
                                           plen + npfx + t)
            out.append(logits)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / tokens.shape[1]
    finally:
        lm.attention, rec.rglru_scan, rec.mlstm_chunk = (ATTENTION, SCAN,
                                                          MLSTM)
        moe_lib.route = ROUTE
    return out, prefill_ms, decode_ms


def census_grid():
    """[(mech_name, mech, virt, workload, n)] — the full census."""
    grid = []
    for mname, mech, virt in MECHS:
        for wname in WORKLOADS:
            base = _BASE_ITERS[wname][mname]
            for sc in SCALES:
                grid.append((mname, mech, virt, wname, max(2, int(base * sc))))
    return grid


def census_processes(cfg=None):
    """The census's prepared processes (25 images shared by 500 lanes)
    and per-lane entry registers; ``cfg`` defaults to ``HookConfig()``."""
    cfg = cfg or HookConfig()
    cells = {(m, w): prepare(WORKLOADS[w](), mech, virtualize=virt, cfg=cfg)
             for m, mech, virt in MECHS for w in WORKLOADS}
    grid = census_grid()
    return [cells[(g[0], g[3])] for g in grid], [{19: g[4]} for g in grid]


def churn_grid():
    """[(mech_name, mech, virt, n)] — benchmarks/emul_overhead.py's grid."""
    return [(m, mech, virt, max(2, int(_BASE_ITERS["churn"][m] * sc)))
            for m, mech, virt in MECHS for sc in CHURN_SCALES]


def churn_processes(emul: bool):
    """The churn census's 400 processes (one image per mechanism), with
    emulation on or with the legacy stubs."""
    cfg = HookConfig(emul_enabled=emul)
    cells = {m: prepare(WORKLOADS["churn"](), mech, virtualize=virt, cfg=cfg)
             for m, mech, virt in MECHS}
    grid = churn_grid()
    return [cells[g[0]] for g in grid], [{19: g[3]} for g in grid]


def per_call_cycles(device=None, n_hi: int = N_HI, n_lo: int = N_LO) -> dict:
    """{mechanism: raw per-call cycles}: the 10 getpid lanes of
    ``benchmarks/hook_overhead.py`` (N = 400 and 200) as one fleet.  The
    cost model is deterministic and a loop iteration costs the same at any
    N, so smaller N give the same differential."""
    cfg = HookConfig(emul_enabled=False)
    pps, keys = [], []
    for name, mech, virt in MECHS:
        for n in (n_hi, n_lo):
            pps.append(prepare(programs.getpid_loop(n), mech,
                               virtualize=virt, cfg=cfg))
            keys.append((name, n))
    out = run_fleet_prepared(pps, fuel=FUEL, device=device)
    by_key = dict(zip(keys, out.cycles.cpu().tolist()))
    return {name: (by_key[(name, n_hi)] - by_key[(name, n_lo)]) / (n_hi - n_lo)
            for name, _, _ in MECHS}


def table3(raw: dict) -> dict:
    """Per-call cycles net of the loop skeleton (hook_overhead.run)."""
    skeleton = raw["none"] - cm.KERNEL_CROSS
    return {k: round(raw[k] - skeleton, 2) for k in TABLE3_CYCLES}


def scramble(leaves: dict, code, rng) -> dict:
    """A seeded random machine state from a packed one (numpy leaves).

    ``code[b]`` is lane b's ``(sections, svc_pcs)``: the ``(base, end)``
    ranges of its image's code sections and the addresses of its svc
    instructions.  Registers get small, huge, negative and data-address
    values, aligned and not; the link register a code address; memory,
    flags and signal state are random.  A third of the lanes start on an
    svc with a syscall number in x8 (read and write often, with a buffer
    in x1 and a byte count in x2 that may be negative or unaligned); the
    rest start anywhere in the code, a few at an unaligned or wild pc.
    The guest-kernel leaves and fuel stay as packed (see
    :func:`scramble_kern`)."""
    out = {k: np.array(v) for k, v in leaves.items()}
    B = out["pc"].shape[0]

    def pick(shape):
        kinds = rng.integers(0, 5, shape)
        small = rng.integers(-64, 4096, shape)
        huge = rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64,
                            endpoint=True)
        data = L.DATA_BASE + 8 * rng.integers(-4, L.MEM_WORDS + 4, shape)
        odd = data + rng.integers(1, 8, shape)
        return np.select([kinds == 0, kinds == 1, kinds == 2, kinds == 3],
                         [small, huge, data, odd], data - 8 * small)

    def code_addr(b):
        lo, hi = code[b][0][rng.integers(0, len(code[b][0]))]
        return lo + 4 * rng.integers(0, max(1, (hi - lo) // 4))

    regs = pick((B, 31))
    regs[:, 30] = [code_addr(b) for b in range(B)]
    pcs = np.asarray([code_addr(b) for b in range(B)], np.int64)
    r = rng.random(B)
    pcs = np.where(r < 0.04, pcs + 2, np.where(r < 0.07, pick(B), pcs))
    nrs = np.asarray([63, 63, 63, 64, 64, 64, 172, 93, 139, 56, 57, 62, 23,
                      80, 59, 278, 29, 181, 0], np.int64)
    sizes = np.asarray([0, 8, 64, 1024, 4096, 32768, 40000, -8, 7, 12],
                       np.int64)
    heap = L.HEAP_BASE + 8 * rng.integers(0, 2048, B)
    for b in np.nonzero(rng.random(B) < 1 / 3)[0]:
        if len(code[b][1]):
            pcs[b] = rng.choice(code[b][1])
            regs[b, 8] = rng.choice(nrs)
            regs[b, 1] = heap[b] if rng.random() < 0.8 else regs[b, 1]
            regs[b, 2] = rng.choice(sizes)
    out["regs"] = regs
    out["pc"] = pcs
    out["sp"] = np.where(rng.random(B) < 0.8,
                         L.STACK_TOP - 8 * rng.integers(0, 512, B), pick(B))
    out["nzcv"] = rng.integers(0, 16, B)
    out["mem"] = rng.integers(-2**63, 2**63 - 1, out["mem"].shape,
                              dtype=np.int64, endpoint=True)
    out["in_signal"] = rng.integers(0, 2, B)
    out["in_off"] = rng.integers(0, 1 << 20, B)
    return out


_NAMES = np.asarray([emul_state.PROC_KEY, emul_state.DEV_KEY,
                     emul_state.path_key(b"churn.da"),
                     emul_state.path_key(b"f0"), emul_state.path_key(b"f1"),
                     0, 12345], np.int64)


_EMUL_NRS = np.asarray([L.SYS_OPENAT, L.SYS_CLOSE, L.SYS_READ, L.SYS_READ,
                       L.SYS_WRITE, L.SYS_WRITE, L.SYS_LSEEK, L.SYS_DUP,
                       L.SYS_FSTAT, L.SYS_PIPE2, L.SYS_GETRANDOM,
                       L.SYS_IOCTL], np.int64)


def scramble_kern(leaves: dict, code, rng) -> dict:
    """Random guest-kernel tables on top of :func:`scramble` (numpy leaves).

    Emulation is on in most lanes.  Table entries that index other tables
    (fd -> OFD, OFD -> inode) are valid as often as not and otherwise
    garbage, as are the kinds, flags and refcounts; file offsets stay in
    ``[0, FILE_BYTES + 64]`` and inode sizes in ``[0, FILE_BYTES]``, the
    ranges under which every data move stays inside its lane (a guest can
    leave them with an lseek near INT64_MAX; the kernel is not exact
    there, see ROADMAP.md Queue 3).  Another third of
    the lanes start on an svc of an emulated family, with a small fd or a
    buffer in x0, a buffer or a number in x1 and a size or flags in x2;
    the word at x1 often names an existing inode, /proc or /dev/asc."""
    out = {k: np.array(v) for k, v in leaves.items()}
    B = out["pc"].shape[0]
    F, N = L.MAX_FDS, L.MAX_INODES

    def some(shape, p, val, other):
        return np.where(rng.random(shape) < p, val, other)

    out["k_enabled"] = (rng.random(B) < 0.85).astype(np.int64)
    out["k_rng"] = rng.integers(-2**63, 2**63 - 1, B, dtype=np.int64,
                                endpoint=True)
    out["k_fd_ofd"] = some((B, F), 0.3, -1, some(
        (B, F), 0.9, rng.integers(0, F, (B, F)),
        rng.integers(-3, F + 3, (B, F))))
    out["k_ofd_kind"] = some((B, F), 0.2, 0, some(
        (B, F), 0.9, rng.integers(1, 8, (B, F)), rng.integers(0, 12, (B, F))))
    out["k_ofd_ino"] = some((B, F), 0.9, rng.integers(0, N, (B, F)),
                            rng.integers(-2, N + 2, (B, F)))
    off = 8 * rng.integers(0, L.FILE_WORDS + 9, (B, F))
    off = some((B, F), 0.4, 0, off)
    out["k_ofd_off"] = some((B, F), 0.1, off + rng.integers(1, 8, (B, F)), off)
    out["k_ofd_flags"] = rng.choice(
        np.asarray([0, 0, L.O_APPEND, L.O_CREAT, L.O_TRUNC | L.O_APPEND, 7]),
        (B, F))
    out["k_ofd_ref"] = rng.integers(-1, 4, (B, F))
    out["k_ino_kind"] = some((B, N), 0.3, 0, rng.integers(0, 4, (B, N)))
    out["k_ino_name"] = rng.choice(_NAMES, (B, N))
    size = 8 * rng.integers(0, L.FILE_WORDS + 1, (B, N))
    out["k_ino_size"] = some((B, N), 0.1,
                             np.minimum(size + rng.integers(1, 8, (B, N)),
                                        L.FILE_BYTES), size)
    out["k_ino_data"] = rng.integers(-2**63, 2**63 - 1, (B, N * L.FILE_WORDS),
                                     dtype=np.int64, endpoint=True)
    regs, pcs = out["regs"], out["pc"]
    heap = L.HEAP_BASE + 8 * rng.integers(0, 2048, B)
    for b in np.nonzero(rng.random(B) < 1 / 3)[0]:
        if len(code[b][1]):
            pcs[b] = rng.choice(code[b][1])
            regs[b, 8] = rng.choice(_EMUL_NRS)
            regs[b, 0] = (rng.integers(-1, F + 1) if rng.random() < 0.7
                          else heap[b])
            regs[b, 1] = heap[b] if rng.random() < 0.8 else rng.choice(
                [0, 1, 2, 8, 64, 4096, 4160, -8])
            regs[b, 2] = rng.choice([0, 8, 64, 512, 1024, 4096, 4160, -8, 12,
                                     L.O_CREAT, L.O_TRUNC, L.O_APPEND,
                                     L.O_CREAT | L.O_EXCL, 1, 2])
    regs[:, 0] = some(B, 0.3, rng.integers(-1, F + 2, B), regs[:, 0])
    mem = out["mem"]
    widx = np.clip((regs[:, 1] - L.DATA_BASE) >> 3, 0, L.MEM_WORDS - 1)
    mem[np.arange(B), widx] = some(B, 0.6, rng.choice(_NAMES, B),
                                   mem[np.arange(B), widx])
    return out


def random_policies(n: int, rng, *, kill_lane: int | None = None) -> list:
    """One seeded random rule list per lane: DENY, EMULATE on emulated
    (guest-kernel) and on other numbers, ALLOW; ``kill_lane`` gets a KILL
    on every number."""
    nrs = [L.SYS_READ, L.SYS_WRITE, L.SYS_GETPID, L.SYS_OPENAT, L.SYS_CLOSE,
           L.SYS_LSEEK, L.SYS_GETRANDOM, 181, -1]
    pols = []
    for b in range(n):
        rules = []
        for _ in range(int(rng.integers(0, 4))):
            nr = int(rng.choice(nrs))
            kind = int(rng.integers(0, 3))
            if kind == 0:
                rules.append(tpolicy.deny(nr, int(rng.integers(1, 40))))
            elif kind == 1 and nr >= 0:
                rules.append(tpolicy.emulate(nr, int(rng.integers(-5, 9000))))
            else:
                rules.append(tpolicy.allow(nr))
        if b == kill_lane:
            rules.append(PolicyRule(syscall_nr=-1, action="kill"))
        pols.append(rules or None)
    return pols


def scramble_trace(n: int, cap: int, rng, policies) -> dict:
    """A seeded random trace carry for ``n`` lanes as numpy leaves: rings,
    counters and histograms random (``count < base`` included, ``hot`` in
    {0, 1}), policy rows compiled from ``policies``."""
    pa, pg = tpolicy.policy_rows(policies)
    count = rng.integers(0, 4 * cap, n)
    base = np.where(rng.random(n) < 0.2, count + rng.integers(1, cap + 1, n),
                    np.minimum(rng.integers(0, 4 * cap, n), count))
    return dict(
        buf=rng.integers(-2**40, 2**40, (n, 2, cap, 8)),
        count=count, hot=rng.integers(0, 2, n), base=base,
        hist=rng.integers(0, 50, (n, fleet.N_POLICY_SLOTS, fleet.N_VERDICTS)),
        pol_action=pa.astype(np.int32), pol_arg=pg.astype(np.int64),
        deny_count=rng.integers(0, 9, n), emul_count=rng.integers(0, 9, n),
        kill_count=np.zeros(n, np.int64))


def code_of(pps) -> list:
    """Per lane, its image's code sections and svc addresses (for
    :func:`scramble`)."""
    from repro_torch.core.isa import Op
    out = []
    for pp in pps:
        ops = np.asarray(pp.decoded.op)
        out.append(([(s.base, s.end) for s in pp.image.sections],
                    4 * np.nonzero(ops == int(Op.SVC))[0]))
    return out


def digest(tree) -> str:
    """sha256 of every leaf's int64 bytes, in field order (how the pinned
    JAX digests were taken)."""
    h = hashlib.sha256()
    for leaf in tree:
        a = leaf.cpu().numpy() if isinstance(leaf, torch.Tensor) else leaf
        h.update(np.ascontiguousarray(np.asarray(a), np.int64).tobytes())
    return h.hexdigest()


def stream_digest(stream, n_keys: int) -> str:
    """sha256 of every record a trace stream holds, keys 0..n_keys-1 in
    order, each key's records in sequence order (8 int64 words each)."""
    h = hashlib.sha256()
    for key in range(n_keys):
        got = stream.export_key(key)
        if got is not None:
            h.update(np.ascontiguousarray(got["rows"], np.int64).tobytes())
    return h.hexdigest()


def counts(out: MachineState) -> dict:
    icount = out.icount.cpu().numpy()
    return {"lanes": int(icount.shape[0]), "total_steps": int(icount.sum()),
            "longest_lane_steps": int(icount.max()),
            "enosys_total": int(out.enosys_count.sum()),
            "emul_served_total": int(out.emul_served.sum())}


# -- helpers ------------------------------------------------------------------

def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def clone(tree):
    return type(tree)(*(x.clone() for x in tree))


def mismatched(a, b) -> list:
    return [f for f, x, y in zip(a._fields, a, b) if not torch.equal(x, y)]


def max_abs_err(a, b) -> int:
    return max(int((x.long() - y.long()).abs().max()) for x, y in zip(a, b))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def plain_run_to_halt(imgs, ids, s, chunk, tr=None):
    """The plain version's run to halt: the drivers' loop around
    megastep_chunk_ref (no kernel, no launch count)."""
    n = 0
    while bool(fleet._alive(s).any()):
        out = megastep_chunk_ref(imgs, ids, s, tr, chunk=chunk)
        s, tr = (out, None) if tr is None else out
        n += 1
    return fleet._patch_fuel(s), tr, n


def kernel_census_ms(pps, regs, chunks, *, dev, traced=False, reps=2,
                     lib=None, block=None):
    """The kernel's own time for a whole census: ``chunks`` launches back
    to back (CUDA events) from a fresh pack, after a warm-up pass; the
    arguments are built once and the host queues the launches behind a
    spin kernel, so no host gap is in the time; these launches are not
    counted.  ``lib``/``block``: another build of the kernel (an earlier
    design's) and its lanes a block.  Returns (best ms, all runs, final
    carry)."""
    times, last = [], None
    for rep in range(reps + 1):
        imgs, ids, sk = pack_fleet(pps, fuel=FUEL, regs=regs, device=dev)
        tk = fleet_trace(pps, device=dev) if traced else None
        launch = mkernel.Launch(imgs, ids, sk, tk, chunk=CHUNK, lib=lib)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        for _ in range(chunks):
            launch(block)
        e1.record()
        torch.cuda.synchronize()
        if rep:
            times.append(e0.elapsed_time(e1))
        last = (fleet._patch_fuel(sk), tk)
    return min(times), times, last


def census_in_turns(pps, regs, chunks, parent, *, dev, traced=False):
    """The census through an earlier design's build (``parent``: its
    library, at its lanes a block) and this one, in turns on one card:
    parent, this, this, parent.  Returns ({"parent": ms runs, "this": ...},
    the last carry of each)."""
    runs, outs = {"parent": [], "this": []}, {}
    for who in ("parent", "this", "this", "parent"):
        lib, block = parent if who == "parent" else (None, None)
        ms, _, out = kernel_census_ms(pps, regs, chunks, dev=dev,
                                      traced=traced, reps=1, lib=lib,
                                      block=block)
        runs[who].append(ms)
        outs[who] = out
    return runs, outs


def megastep_build_line(built, card, build_s) -> dict:
    """The megastep kernel's ptxas report (registers, spills, stack frame
    of the kernel and of each function it calls) and the runtime's view
    (registers, local memory, the most lanes a block); raises on any spill
    or any local memory (a register array indexed at run time lands
    there)."""
    lib, report = built
    if not report:  # built before: compile once more for the report
        with tempfile.TemporaryDirectory() as d:
            _, report = nvcc.build("megastep", mkernel.SOURCE, Path(d),
                                   {"megastep_consts.h":
                                    mkernel.consts_header()})
    funcs = nvcc.ptxas_functions(report)
    info = mkernel.kernel_info()
    bad = {k: v for k, v in funcs.items()
           if v.get("spill_stores") or v.get("spill_loads") or v.get("stack")}
    if bad or info["local_bytes"] or not funcs:
        raise AssertionError(f"megastep kernel: spills or local memory: "
                             f"{bad or funcs}, {info}")
    return {"phase": "megastep_build", "card": card, "seconds": build_s,
            "library": lib.name, "functions": funcs, "runtime": info,
            "spill_bytes": 0, "local_bytes": 0,
            "lanes_per_block_default": mkernel.DEFAULT_BLOCK}


def census_bound_ms(out: MachineState, code_words: int, *,
                    emul_payload: int = 0, records: int = 0,
                    traced_lanes: int = 0) -> tuple:
    """The least time the card could take for a census's work: the larger
    of its bytes over the memory rate and its integer operations over the
    peak rate (PERF.md section 6 has the rules).  ``code_words`` counts
    the code words of the distinct images (16 bytes of decode table
    each); ``emul_payload`` the bytes the emulation's data mover moves,
    each read from one plane and written to the other: the only bytes of
    ``mem`` and ``k_ino_data`` the work needs besides the stream I/O;
    ``records`` the trace records of a traced run over ``traced_lanes``."""
    lanes = int(out.pc.shape[0])
    steps = int(out.icount.sum())
    stream = int(out.in_off.sum() + out.out_count.sum())  # stream I/O bytes
    nbytes = (lanes * 8 * 2 * SMALL_WORDS + lanes * 4 + 16 * code_words
              + stream + 2 * emul_payload
              + records * (REC_BYTES + HIST_BUMP_BYTES)
              + traced_lanes * TRACE_LANE_BYTES)
    ops = steps * OPS_PER_STEP + 2 * (stream + emul_payload) // 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"),
            nbytes, ops)


def code_words_of(pps) -> int:
    distinct = {id(pp): pp for pp in pps}.values()
    digests = {}
    for pp in distinct:
        digests[hashlib.sha1(np.ascontiguousarray(pp.image.words)
                             .tobytes()).hexdigest()] = pp
    return sum(sec.size // 4 for pp in digests.values()
               for sec in pp.image.sections)


# -- phases -------------------------------------------------------------------

def flash_phase(dev, card) -> tuple:
    """Flash attention vs its plain version on the card: every case of
    FLASH_CASES, both serving paths' prefill shapes and FAMILY_FLASH, bf16
    (the tensor-core kernel) and f32 (the SIMT kernel).  Returns (the phase's
    line, the largest error)."""
    t0 = time.perf_counter()
    err, n_checks = 0.0, 0
    cases = FLASH_CASES + (QWEN_PREFILL, RG_PREFILL) + FAMILY_FLASH
    for i, case in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = flash_inputs(case, dtype, i, dev)
            want = fops.flash_attention_plain(q, k, v, causal=case[6],
                                              window=case[7])
            got = fops.flash_attention(q, k, v, causal=case[6],
                                       window=case[7])
            torch.cuda.synchronize()
            e, n_over = over_bound(got, want, dtype)
            if n_over or not torch.isfinite(got).all():
                raise AssertionError(
                    f"flash kernel != plain: {case} {dtype}: {n_over} "
                    f"elements over the bound, max err {e}")
            err = max(err, e)
            n_checks += 1
    return ({"phase": "flash_vs_plain", "card": card, "checks": n_checks,
             "cases": len(cases),
             "kernels": {"bfloat16": "flash_tc_kernel (wgmma, TMA)",
                         "float32": "flash_kernel (SIMT)"},
             "over_bound": 0, "max_abs_err": err,
             "seconds": time.perf_counter() - t0}, err)


def decode_phase(dev, card) -> tuple:
    """Flash-decode vs its plain version on the card: every case of
    DECODE_CASES, the qwen3-1.7b decode shape, DECODE_SPLIT_CASES and
    FAMILY_DECODE, f32 and bf16; each case called twice, the outputs
    equal bit for bit.  Returns (the phase's line, the largest error)."""
    t0 = time.perf_counter()
    err, n_checks, splits = 0.0, 0, {}
    cases = (DECODE_CASES + (QWEN_DECODE,) + DECODE_SPLIT_CASES
             + FAMILY_DECODE)
    for i, case in enumerate(cases):
        B, Skv, Hq, Hkv, hd, kv_len = case
        splits[str(case)] = dops.split_count(Skv, kv_len, B * Hkv,
                                             dops.sm_count(dev.index or 0))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = decode_inputs(case, dtype, 100 + i, dev)
            want = dops.decode_attention_plain(q, k, v, kv_len)
            got = dops.decode_attention(q, k, v, kv_len)
            again = dops.decode_attention(q, k, v, kv_len)
            torch.cuda.synchronize()
            e, n_over = over_bound(got, want, dtype)
            if n_over or not torch.isfinite(got).all():
                raise AssertionError(
                    f"decode kernel != plain: {case} {dtype}: {n_over} "
                    f"elements over the bound, max err {e}")
            if not torch.equal(got, again):
                raise AssertionError(f"decode kernel: two calls differ: "
                                     f"{case} {dtype}")
            err = max(err, e)
            n_checks += 1
    return ({"phase": "decode_vs_plain", "card": card, "checks": n_checks,
             "cases": len(cases), "splits": splits, "over_bound": 0,
             "two_calls_bit_equal": True, "max_abs_err": err,
             "seconds": time.perf_counter() - t0}, err)


class AttentionCheck:
    """Stands in for the model's attention during a run on the card: each
    call runs the kernel route, then the kernels' plain versions on the
    same inputs, and holds the kernel to the bf16 bound elementwise."""

    def __init__(self):
        self.calls, self.max_err, self.over = 0, 0.0, 0

    def __call__(self, q, k, v, **kw):
        got = ATTENTION(q, k, v, **kw)
        want = plain_attention(q, k, v, **kw)
        e, n = over_bound(got, want, q.dtype)
        self.calls += 1
        self.max_err, self.over = max(self.max_err, e), self.over + n
        return got


class ScanCheck:
    """Stands in for the model's RG-LRU scan during a run on the card: each
    call runs the kernel, then both plain versions on the same inputs, and
    holds the kernel bit for bit to the sequential one and within
    SCAN_TOL of the associative scan."""

    def __init__(self):
        self.calls, self.max_err, self.over, self.unequal = 0, 0.0, 0, 0

    def __call__(self, a, b, h0):
        got = SCAN(a, b, h0)
        e, n = over_bound(got, rglru_scan_ref(a, b, h0), torch.float32,
                          SCAN_TOL)
        self.calls += 1
        self.max_err, self.over = max(self.max_err, e), self.over + n
        self.unequal += not torch.equal(got, rglru_scan_seq(a, b, h0))
        return got


class MlstmCheck:
    """Stands in for the model's mLSTM during a run on the card: each call
    runs the plain version at the kernels' chunk, then the kernels on the
    same inputs (the decode step writes the state passed in, so the plain
    version reads it first), and holds h, C and n to MLSTM_TOL
    elementwise."""

    def __init__(self):
        self.calls, self.max_err, self.over = 0, 0.0, 0

    def __call__(self, *args, chunk, out=None):
        want = plain_mlstm(*args, chunk=chunk)
        got = MLSTM(*args, chunk=chunk, out=out)
        for g, w in zip(got, want):
            e, n = over_bound(g, w, torch.float32, MLSTM_TOL)
            self.max_err, self.over = max(self.max_err, e), self.over + n
        self.calls += 1
        return got


def route_stats(lk, lp, vocab) -> tuple:
    """Teacher-forced logits of one route (``lk``) against another
    (``lp``), step by step: (tokens agreeing, logits over the elementwise
    bf16 bound, largest logit difference, largest relative L2, tokens that
    differ although ``lp``'s top-2 margin exceeds twice that step's largest
    logit difference)."""
    agree, n_over, worst, rel, flips = 0, 0, 0.0, 0.0, 0
    for a, b in zip(lk[:-1], lp[:-1]):
        a, b = a[:, :vocab].float(), b[:, :vocab].float()
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError("non-finite logits")
        e, n = over_bound(a, b, torch.bfloat16)
        worst, n_over = max(worst, e), n_over + n
        rel = max(rel, float((a - b).norm() / b.norm()))
        top2 = b.topk(2, dim=-1).values
        same = a.argmax(-1) == b.argmax(-1)
        agree += int(same.sum())
        flips += int((~same & (top2[:, 0] - top2[:, 1] > 2 * e)).sum())
    return agree, n_over, worst, rel, flips


def compare_routes(lk, lp, tokens, vocab, rel_bound=None) -> tuple:
    """The kernel route (``lk``) against the plain route (``lp``): the
    kernel route's picks are the engine's ``tokens``; relative L2 per step
    within ``rel_bound`` (default the bf16 bound's 2e-2); tokens equal
    outside near-ties (:func:`route_stats`).  Returns (tokens agreeing,
    logits over the elementwise bf16 bound, largest logit difference,
    largest relative L2)."""
    picks_k = torch.stack([x[:, :vocab].argmax(-1) for x in lk[:-1]], 1)
    if not torch.equal(picks_k.cpu(), torch.from_numpy(tokens).long()):
        raise AssertionError("teacher-forced kernel run != the engine's "
                             "tokens")
    agree, n_over, worst, rel, flips = route_stats(lk, lp, vocab)
    if rel > (rel_bound or TOLS[torch.bfloat16][1]) or flips:
        raise AssertionError(f"kernel-route logits != plain-route logits: "
                             f"relative L2 {rel}, {flips} tokens differ "
                             f"outside a near-tie")
    return agree, n_over, worst, rel


class KernelShapes:
    """Counts the attention kernels' calls by shape while it is entered:
    flash attention by (B, Sq, Skv, Hq, Hkv, hd, causal, window),
    flash-decode by (B, Skv, Hq, Hkv, hd) with the least kv_len seen (the
    names the model calls are wrapped; the kernels count their own
    launches as before)."""

    def __init__(self):
        self.flash, self.decode, self.kv_len = {}, {}, {}

    def _flash(self, q, k, v, *, causal, window=0):
        key = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
               q.shape[3], bool(causal), int(window))
        self.flash[key] = self.flash.get(key, 0) + 1
        return fops.flash_attention(q, k, v, causal=causal, window=window)

    def _decode(self, q, k, v, kv_len):
        key = (q.shape[0], k.shape[1], q.shape[2], k.shape[2], q.shape[3])
        self.decode[key] = self.decode.get(key, 0) + 1
        self.kv_len[key] = min(self.kv_len.get(key, kv_len), kv_len)
        return dops.decode_attention(q, k, v, kv_len)

    def __enter__(self):
        layers.flash_attention, layers.decode_attention = (self._flash,
                                                           self._decode)
        return self

    def __exit__(self, *exc):
        layers.flash_attention = fops.flash_attention
        layers.decode_attention = dops.decode_attention

    def cases(self) -> dict:
        """{("flash", case) | ("decode", case with kv_len): calls}."""
        out = {("flash", k): n for k, n in self.flash.items()}
        out.update({("decode", k + (self.kv_len[k],)): n
                    for k, n in self.decode.items()})
        return out


def serve_main_path(arch, dev, want, cfg=None) -> dict:
    """One serving path through the entry points a user calls: ``arch``
    (or ``cfg``, a cut of it) at full width from seeded random weights,
    ServeEngine over the seeded requests (after a short warm-up), every
    kernel's launch count set to 0 just before ``generate`` and read just
    after, held to ``want``, the attention kernels' calls counted by shape
    too; the tokens checked for shape and range.  Returns what the phase
    needs."""
    cfg = cfg or get_config(arch)
    run = RunConfig(decode_budget=SERVE_BUDGET)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServeEngine(cfg, run, params, max_batch=SERVE_BATCH)
    reqs = serve_requests(cfg.vocab)
    eng.generate([Request(reqs[0].prompt[:16], max_new_tokens=2)])  # warm-up
    torch.cuda.synchronize()
    counted = {"flash": fops.flash_attention, "decode": dops.decode_attention,
               "rglru": rops.rglru_scan, "mlstm": xops.mlstm_chunk}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with KernelShapes() as shapes:
        outs = eng.generate(reqs)
        torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    if launches != want:
        raise AssertionError(f"{arch}: launches {launches}, expected {want}")
    by_shape = shapes.cases()
    for name in ("flash", "decode"):
        if sum(n for (k, _), n in by_shape.items() if k == name) != \
                launches[name]:
            raise AssertionError(f"{arch}: {name} calls by shape "
                                 f"{by_shape} != launches {launches}")
    tokens = np.stack([o.tokens for o in outs])
    if tokens.shape != (SERVE_BATCH, SERVE_NEW) or not (
            (tokens >= 0) & (tokens < cfg.vocab)).all():
        raise AssertionError(f"tokens {tokens.shape} out of range")
    toks, plen = eng._pad_batch(reqs)
    return {"cfg": cfg, "run": run, "params": params, "reqs": reqs,
            "tokens": tokens, "toks": toks, "plen": plen,
            "fed": torch.from_numpy(tokens.astype(np.int64)).to(dev),
            "launches": launches, "by_shape": by_shape, "init_s": init_s,
            "generate_s": generate_s,
            "n_params": sum(x.numel() for x in lm.tree_leaves(params))}


def serve_phase(dev, card) -> tuple:
    """The LM serving path at qwen3-1.7b's full width: ServeEngine over 8
    seeded prompts (64..512 tokens), 32 new tokens each, through the
    attention kernels; launch counts read around that run; the run
    teacher-forced through the kernels and through the plain attention on
    the card, logits held to the bf16 bound; per-kernel times at the
    run's shapes beside their bounds, plain versions and SDPA.  Returns
    (the phase's line, {"flash": row, "decode": row} for the kernel
    table)."""
    t_phase = time.perf_counter()
    n_layers = get_config(SERVE_ARCH).n_layers
    m = serve_main_path(SERVE_ARCH, dev, {
        "flash": n_layers, "decode": n_layers * SERVE_NEW, "rglru": 0,
        "mlstm": 0})
    cfg, run, params, reqs = m["cfg"], m["run"], m["params"], m["reqs"]
    tokens, toks, plen, fed = m["tokens"], m["toks"], m["plen"], m["fed"]
    launches = m["launches"]

    # teacher-forced: kernels, then the kernels' plain versions, same tokens
    lk, prefill_ms, decode_ms = teacher_forced(cfg, run, params, toks, plen,
                                               fed)
    lp, prefill_ms_plain, decode_ms_plain = teacher_forced(
        cfg, run, params, toks, plen, fed, attention=plain_attention)
    agree, n_over, worst, rel = compare_routes(lk, lp, tokens, cfg.vocab)
    # every attention call of the kernel run against the plain versions on
    # the same inputs, elementwise
    check = AttentionCheck()
    teacher_forced(cfg, run, params, toks, plen, fed, attention=check)
    if check.over or check.calls != cfg.n_layers * (SERVE_NEW + 1):
        raise AssertionError(f"attention calls {check.calls}: "
                             f"{check.over} elements over the bf16 bound")

    # per-kernel times at the run's shapes (random inputs of those shapes)
    rows = {}
    B, Hq, Hkv, hd = SERVE_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    case = (B, plen, plen, Hq, Hkv, hd, True, 0)
    q, k, v = flash_inputs(case, torch.bfloat16, 7, dev)
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes, ops = flash_work(case, torch.bfloat16)
    bnd, by = bound_ms(nbytes, ops, torch.bfloat16)
    flash = lambda: fops.flash_attention(q, k, v, causal=True)  # noqa: E731
    rows["flash"] = {
        "launches": launches["flash"], "ms": device_ms(flash),
        "plain_ms": cuda_ms(lambda: fops.flash_attention_plain(
            q, k, v, causal=True), reps=5),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": device_ms(lambda: sdpa(qs, ks, vs, is_causal=True,
                                             enable_gqa=True))}
    eager = {"flash": cuda_ms(flash), "decode": 0.0}
    Skv = plen + SERVE_BUDGET
    qd, kc, vc = decode_inputs((B, Skv, Hq, Hkv, hd, 0), torch.bfloat16, 8,
                               dev)
    qds = qd.transpose(1, 2).contiguous()
    ms = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    bys = set()
    for t in range(SERVE_NEW):  # the run's kv_len, one per decode step
        kv_len = plen + t + 1
        kl, vl = (x[:, :kv_len].transpose(1, 2).contiguous()
                  for x in (kc, vc))
        decode = lambda: dops.decode_attention(qd, kc, vc, kv_len)  # noqa
        ms["ms"] += device_ms(decode, reps=10)
        eager["decode"] += cuda_ms(decode, reps=10) / SERVE_NEW
        ms["plain_ms"] += cuda_ms(lambda: dops.decode_attention_plain(
            qd, kc, vc, kv_len), reps=3)
        ms["library_ms"] += device_ms(lambda: sdpa(qds, kl, vl,
                                                   enable_gqa=True), reps=10)
        nbytes, ops = decode_work((B, Skv, Hq, Hkv, hd, kv_len),
                                  torch.bfloat16)
        bnd, by = bound_ms(nbytes, ops, torch.bfloat16)
        ms["bound_ms"] += bnd
        bys.add(by)
    rows["decode"] = {"launches": launches["decode"],
                      **{key: val / SERVE_NEW for key, val in ms.items()},
                      "bound_by": "/".join(sorted(bys))}

    line = {"phase": "serve", "card": card, "arch": SERVE_ARCH,
            "n_params": m["n_params"], "layers": cfg.n_layers,
            "batch": SERVE_BATCH, "prompt_lens": [len(r.prompt) for r in reqs],
            "padded_len": plen, "new_tokens": SERVE_NEW,
            "decode_budget": SERVE_BUDGET, "launches": launches,
            "init_s": m["init_s"], "generate_s": m["generate_s"],
            "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
            "plain_prefill_ms": prefill_ms_plain,
            "plain_decode_ms_per_token": decode_ms_plain,
            "token_agreement_plain": agree / (SERVE_BATCH * SERVE_NEW),
            "logits_max_rel_l2": rel, "logits_max_abs_err": worst,
            "logits_elements_over_elementwise_bound": n_over,
            "attention_calls_checked": check.calls,
            "attention_max_abs_err": check.max_err,
            "attention_over_bound": check.over,
            "kernel_ms": {k_: r["ms"] for k_, r in rows.items()},
            "kernel_eager_ms": eager,
            "library_ms": {k_: r["library_ms"] for k_, r in rows.items()},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "seconds": time.perf_counter() - t_phase}
    return line, rows


def rglru_phase(dev, card) -> tuple:
    """The RG-LRU scan kernel vs its plain versions on the card: every case
    of RGLRU_CASES and the recurrentgemma-2b prefill (h0 random and zero)
    and decode shapes; kernel, plain and sequential times and the bound at
    the prefill shape.  Returns (the phase's line, the largest error)."""
    t0 = time.perf_counter()
    err, n_checks = 0.0, 0
    cases = [(c, False) for c in RGLRU_CASES + (RG_SCAN_PREFILL,
                                               RG_SCAN_DECODE)]
    cases.append((RG_SCAN_PREFILL, True))
    for i, (case, zero_h0) in enumerate(cases):
        a, b, h0 = scan_inputs(case, 200 + i, dev, zero_h0=zero_h0)
        got = rops.rglru_scan(a, b, h0)
        seq = rglru_scan_seq(a, b, h0)
        e, n_over = over_bound(got, rglru_scan_ref(a, b, h0), torch.float32,
                               SCAN_TOL)
        torch.cuda.synchronize()
        if not torch.equal(got, seq) or n_over or not torch.isfinite(
                got).all():
            raise AssertionError(
                f"rglru kernel != plain: {case} h0 zero {zero_h0}: equal to "
                f"the sequential version {torch.equal(got, seq)}, {n_over} "
                f"elements over the bound of the associative scan, max err "
                f"{e}")
        err = max(err, e)
        n_checks += 2
    a, b, h0 = scan_inputs(RG_SCAN_PREFILL, 7, dev)
    bnd, by = bound_ms(*scan_work(RG_SCAN_PREFILL), torch.float32)
    # the launch floor: an empty kernel (torch.cuda._sleep(0), one thread
    # that returns at once) in the same CUDA-graph harness as the scan's
    # prefill and decode device times; decode's bound is the larger of
    # its bytes and that floor
    a_d, b_d, h0_d = scan_inputs(RG_SCAN_DECODE, 8, dev)
    dec_bnd, dec_by = bound_ms(*scan_work(RG_SCAN_DECODE), torch.float32)
    floor = {"prefill_device_ms": device_ms(lambda: rops.rglru_scan(a, b,
                                                                    h0)),
             "decode_device_ms": device_ms(lambda: rops.rglru_scan(
                 a_d, b_d, h0_d)),
             "empty_kernel_device_ms": device_ms(
                 lambda: torch.cuda._sleep(0)),
             "decode_bytes_bound_ms": dec_bnd, "decode_bytes_bound_by": dec_by}
    floor["decode_bound_ms"] = max(dec_bnd, floor["empty_kernel_device_ms"])
    floor["prefill_bound_share"] = bnd / floor["prefill_device_ms"]
    floor["decode_bound_share"] = (floor["decode_bound_ms"]
                                   / floor["decode_device_ms"])
    return ({"phase": "rglru_vs_plain", "card": card, "checks": n_checks,
             "cases": [list(c) + [z] for c, z in cases],
             "unequal_to_sequential": 0, "over_bound": 0,
             "max_abs_err_vs_associative": err,
             "prefill_shape": RG_SCAN_PREFILL,
             "ms": cuda_ms(lambda: rops.rglru_scan(a, b, h0)),
             "plain_ms": cuda_ms(lambda: rglru_scan_ref(a, b, h0), reps=3),
             "sequential_ms": cuda_ms(lambda: rglru_scan_seq(a, b, h0),
                                      reps=1),
             "bound_ms": bnd, "bound_by": by, "decode_shape": RG_SCAN_DECODE,
             **floor, "seconds": time.perf_counter() - t0}, err)


def serve_rg_phase(dev, card) -> tuple:
    """The hybrid serving path at recurrentgemma-2b's full width and depth:
    ServeEngine over the same 8 requests as ``serve``; launch counts read
    around that run; the run teacher-forced through the kernels, through
    the kernels with the scan's sequential plain version (bit for bit the
    same logits), through the plain versions (attention and scan) and
    through the JAX model's own plain functions, on the card; every
    attention and scan call of the kernel run held to its plain versions;
    per-kernel times at the run's shapes.  Returns (the phase's line,
    {"flash": row, "rglru": row} for the kernel table)."""
    t_phase = time.perf_counter()
    kinds = get_config(RG_ARCH).layer_kinds()
    n_rglru, n_local = kinds.count("rglru"), kinds.count("local_attn")
    m = serve_main_path(RG_ARCH, dev, {
        "flash": n_local, "decode": 0, "rglru": n_rglru * (1 + SERVE_NEW),
        "mlstm": 0})
    cfg, run, params, reqs = m["cfg"], m["run"], m["params"], m["reqs"]
    tokens, toks, plen, fed = m["tokens"], m["toks"], m["plen"], m["fed"]
    launches = m["launches"]
    if plen > cfg.window:
        raise AssertionError("the prompts outgrow the window: causal SDPA "
                             "is no longer the library's form of it")

    # teacher-forced: kernels, then their plain versions, same tokens
    lk, prefill_ms, decode_ms = teacher_forced(cfg, run, params, toks, plen,
                                               fed)
    # the scan end to end: with only the scan swapped for its sequential
    # plain version, every logit is the kernel route's, bit for bit
    ls, _, _ = teacher_forced(cfg, run, params, toks, plen, fed,
                              scan=rglru_scan_seq)
    if not all(map(torch.equal, lk, ls)):
        raise AssertionError("the scan kernel's route != its sequential "
                             "plain version's")
    # the plain route: attention's plain version and the scan's sequential
    # one (the recurrence the TPU kernel and this one compute)
    lp, prefill_ms_plain, decode_ms_plain = teacher_forced(
        cfg, run, params, toks, plen, fed, attention=plain_attention,
        scan=rglru_scan_seq)
    # the noise floor of 26 random-weight layers: the JAX model's own plain
    # functions (its attention, bf16 probabilities; the associative scan)
    # against the plain route.  The kernel route is held to the larger of
    # the bf16 bound's 2e-2 and that floor.
    lf, _, _ = teacher_forced(cfg, run, params, toks, plen, fed,
                              attention=MODEL_ATTENTION, scan=rglru_scan_ref)
    _, _, _, floor, flips_floor = route_stats(lf, lp, cfg.vocab)
    if flips_floor:
        raise AssertionError(f"{flips_floor} tokens differ between the "
                             "plain routes outside a near-tie")
    agree, n_over, worst, rel = compare_routes(
        lk, lp, tokens, cfg.vocab,
        rel_bound=max(TOLS[torch.bfloat16][1], floor))
    acheck, scheck = AttentionCheck(), ScanCheck()
    teacher_forced(cfg, run, params, toks, plen, fed, attention=acheck,
                   scan=scheck)
    if acheck.over or acheck.calls != n_local:
        raise AssertionError(f"attention calls {acheck.calls}: "
                             f"{acheck.over} elements over the bf16 bound")
    if (scheck.over or scheck.unequal
            or scheck.calls != n_rglru * (1 + SERVE_NEW)):
        raise AssertionError(f"scan calls {scheck.calls}: {scheck.over} "
                             f"elements over the bound, {scheck.unequal} "
                             "calls not equal to the sequential version")

    # per-kernel times at the run's shapes (random inputs of those shapes)
    rows = {}
    B, Hq, Hkv, hd = SERVE_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    case = (B, plen, plen, Hq, Hkv, hd, True, cfg.window)
    q, k, v = flash_inputs(case, torch.bfloat16, 9, dev)
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bnd, by = bound_ms(*flash_work(case, torch.bfloat16), torch.bfloat16)
    flash = lambda: fops.flash_attention(  # noqa: E731
        q, k, v, causal=True, window=cfg.window)
    rows["flash"] = {
        "launches": launches["flash"], "ms": device_ms(flash),
        "plain_ms": cuda_ms(lambda: fops.flash_attention_plain(
            q, k, v, causal=True, window=cfg.window), reps=5),
        "bound_ms": bnd, "bound_by": by,
        # plen <= window: causal attention is the same function
        "library_ms": device_ms(lambda: sdpa(qs, ks, vs, is_causal=True,
                                             enable_gqa=True))}
    flash_eager_ms = cuda_ms(flash)
    # the scan: per launch, averaged over the run's launches (one prefill
    # shape and SERVE_NEW decode steps per RG-LRU layer)
    per_shape = {}
    for shape in ((B, plen, cfg.rnn_width), (B, 1, cfg.rnn_width)):
        a, b, h0 = scan_inputs(shape, 10, dev)
        bnd, by = bound_ms(*scan_work(shape), torch.float32)
        per_shape[shape[1]] = {
            "ms": device_ms(lambda: rops.rglru_scan(a, b, h0)),
            "eager_ms": cuda_ms(lambda: rops.rglru_scan(a, b, h0)),
            "plain_ms": cuda_ms(lambda: rglru_scan_ref(a, b, h0), reps=3),
            "bound_ms": bnd, "bound_by": by}
    mix = {plen: 1 / (1 + SERVE_NEW), 1: SERVE_NEW / (1 + SERVE_NEW)}
    rows["rglru"] = {
        "launches": launches["rglru"],
        **{key: sum(w * per_shape[s][key] for s, w in mix.items())
           for key in ("ms", "eager_ms", "plain_ms", "bound_ms")},
        "bound_by": "/".join(sorted({r["bound_by"]
                                     for r in per_shape.values()})),
        "library_ms": None}

    line = {"phase": "serve_recurrentgemma", "card": card, "arch": RG_ARCH,
            "n_params": m["n_params"], "layers": cfg.n_layers,
            "rglru_layers": n_rglru, "local_attn_layers": n_local,
            "batch": SERVE_BATCH, "prompt_lens": [len(r.prompt) for r in reqs],
            "padded_len": plen, "new_tokens": SERVE_NEW,
            "decode_budget": SERVE_BUDGET, "launches": launches,
            "init_s": m["init_s"], "generate_s": m["generate_s"],
            "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
            "plain_prefill_ms": prefill_ms_plain,
            "plain_decode_ms_per_token": decode_ms_plain,
            "token_agreement_plain": agree / (SERVE_BATCH * SERVE_NEW),
            "logits_max_rel_l2": rel, "logits_max_abs_err": worst,
            "logits_elements_over_elementwise_bound": n_over,
            "logits_within_2e-2": rel <= TOLS[torch.bfloat16][1],
            "plain_routes_max_rel_l2": floor,
            "logits_bit_equal_with_the_sequential_scan": True,
            "attention_calls_checked": acheck.calls,
            "attention_max_abs_err": acheck.max_err,
            "attention_over_bound": acheck.over,
            "scan_calls_checked": scheck.calls,
            "scan_max_abs_err_vs_associative": scheck.max_err,
            "scan_over_bound": scheck.over,
            "scan_unequal_to_sequential": scheck.unequal,
            "kernel_ms": {"flash": rows["flash"]["ms"],
                          "rglru_prefill": per_shape[plen]["ms"],
                          "rglru_decode": per_shape[1]["ms"]},
            "rglru_eager_ms": {"prefill": per_shape[plen]["eager_ms"],
                               "decode": per_shape[1]["eager_ms"]},
            "flash_eager_ms": flash_eager_ms,
            "flash_library_ms": rows["flash"]["library_ms"],
            "rglru_bound_ms": {"prefill": per_shape[plen]["bound_ms"],
                               "decode": per_shape[1]["bound_ms"]},
            "rglru_plain_ms": {"prefill": per_shape[plen]["plain_ms"],
                               "decode": per_shape[1]["plain_ms"]},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "seconds": time.perf_counter() - t_phase}
    return line, rows


def mlstm_build_line(built, card, build_s) -> dict:
    """The mLSTM library's kernels: ptxas's registers and spills, the
    runtime's shared memory, threads and local memory, and the count of
    ``HGMMA`` instructions in each kernel's SASS.  The scores and state
    passes must be tensor-core code; no kernel may spill."""
    lib, report = built
    table = nvcc.ptxas_table(report)  # empty when built before
    hgmma = nvcc.sass_counts(lib, "HGMMA")
    kinfo = xkernel.info()
    rows = {}
    for name in xkernel.KERNELS:
        sass = [n for k_, n in hgmma.items() if name in k_]
        ptxas = [v for k_, v in table.items() if name in k_]
        if len(sass) != 1:
            raise AssertionError(f"mlstm kernel {name}: {len(sass)} in the "
                                 "library's SASS")
        rows[name] = {"hgmma": sass[0], "ptxas": ptxas[0] if ptxas else None,
                      **kinfo[name]}
        spills = ptxas and (ptxas[0]["spill_stores"]
                            or ptxas[0]["spill_loads"])
        if rows[name]["local_bytes"] or spills or (
                "decode" not in name and not sass[0]):
            raise AssertionError(f"mlstm kernel {name}: {rows[name]}: "
                                 "spills, or no tensor-core code")
    return {"phase": "mlstm_build", "card": card, "seconds": build_s,
            "library": lib.name, "ptxas": nvcc.ptxas_lines(report),
            "kernels": rows, "chunk": xkernel.CHUNK, "bn": xkernel.BN}


def mlstm_kernel_form(q, k, v, log_f, log_i, C0, n0):
    """The kernels' own arithmetic in plain PyTorch: both prefill passes
    at S > 1, the decode step (on clones of the state) at S = 1."""
    if q.shape[1] > 1:
        return mlstm_tc_ref(q, k, v, log_f, log_i, C0, n0, xkernel.CHUNK)
    C, n = C0.clone(), n0.clone()
    return mlstm_decode_ref(q, k, v, log_f, log_i, C, n), C, n


def mlstm_timed(args, n_states: int = 4) -> dict:
    """The kernels' device time (CUDA graph) and eager time on ``args``.
    At S = 1 the decode step in place, over ``n_states`` clones of the
    state in turn: at xlstm-350m's decode shape 4 x 33.5 MB, past the
    50 MB L2, as a serving step finds a layer's state (17 other layers'
    states came between); a prefill call reads ~151 MB already."""
    if args[0].shape[1] > 1:
        call = lambda: xops.mlstm_chunk(*args)  # noqa: E731
    else:
        states = [(args[5].clone(), args[6].clone())
                  for _ in range(n_states)]
        turn = iter(range(1 << 30))

        def call():
            st = states[next(turn) % n_states]
            return xops.mlstm_chunk(*args[:5], *st, out=st)
    return {"ms": device_ms(call), "eager_ms": cuda_ms(call)}


def mlstm_bounds(case) -> dict:
    """The bound of one call (``mlstm_work``): its operations at the bf16
    tensor-core peak, where the kernels run them, and the f32 peak's
    figure beside it."""
    nbytes, ops = mlstm_work(case)
    bnd, by = bound_ms(nbytes, ops, torch.bfloat16)
    return {"bound_ms": bnd, "bound_by": by,
            "bound_ms_f32_peak": bound_ms(nbytes, ops, torch.float32)[0]}


def mlstm_phase(dev, card) -> tuple:
    """The mLSTM kernels vs their plain versions on the card: every case
    of MLSTM_CASES, then xlstm-350m's prefill shape (from the zero state)
    and a decode step from the state that prefill leaves; h, C and n
    against the chunked plain version at the kernels' chunk, the
    sequential recurrence and the kernels' own arithmetic in plain
    PyTorch, from the same state, each within MLSTM_TOL; every case called
    twice, the two results bit-equal; every decode step also in place
    (``out`` the state itself, cloned), bit-equal to the call that writes
    new tensors; device and eager times, the plain versions' times and
    the bound at both serving shapes.  Returns (the phase's line, the
    largest error)."""
    t0 = time.perf_counter()
    err = {"chunked": 0.0, "sequential": 0.0, "kernel_form": 0.0}
    cases, checks = [], 0

    def check(case, args):
        nonlocal checks
        got = xops.mlstm_chunk(*args)
        again = xops.mlstm_chunk(*args)
        runs = [("", got)]
        if args[0].shape[1] == 1:
            C, n = args[5].clone(), args[6].clone()
            inplace = xops.mlstm_chunk(*args[:5], C, n, out=(C, n))
            if inplace[1] is not C or inplace[2] is not n:
                raise AssertionError("mlstm decode: out not returned")
            runs.append((" in place", inplace))
        torch.cuda.synchronize()
        for what, res in runs[1:] + [(" again", again)]:
            if not all(map(torch.equal, res, got)):
                raise AssertionError(f"mlstm kernel: {case}{what} != the "
                                     "first call")
        for name, want in (("chunked", mlstm_chunk_ref(*args,
                                                       xkernel.CHUNK)),
                           ("sequential", mlstm_seq(*args)),
                           ("kernel_form", mlstm_kernel_form(*args))):
            for leaf, g, w in zip("hCn", got, want):
                e, n_over = over_bound(g, w, torch.float32, MLSTM_TOL)
                if n_over or not torch.isfinite(g).all():
                    raise AssertionError(
                        f"mlstm kernel != its {name} plain version: {case} "
                        f"{leaf}: {n_over} elements over the bound, max err "
                        f"{e}")
                err[name] = max(err[name], e)
                checks += 1
        cases.append(list(case))
        return got

    for i, case in enumerate(MLSTM_CASES):
        check(case, mlstm_inputs(case, 300 + i, dev))
    pre = mlstm_inputs(XL_PREFILL, 7, dev)
    _, C, n = check(XL_PREFILL, pre)
    dec = mlstm_inputs(XL_DECODE, 8, dev, state=(C, n))
    check(XL_DECODE, dec)
    times = {}
    for name, case, args in (("prefill", XL_PREFILL, pre),
                             ("decode", XL_DECODE, dec)):
        times[name] = {
            **mlstm_timed(args), **mlstm_bounds(case),
            "plain_ms": cuda_ms(lambda: mlstm_chunk_ref(*args,
                                                        xkernel.CHUNK),
                                reps=3),
            "sequential_ms": cuda_ms(lambda: mlstm_seq(*args), reps=1)}
    return ({"phase": "mlstm_vs_plain", "card": card, "chunk": xkernel.CHUNK,
             "checks": checks, "cases": cases, "over_bound": 0,
             "two_calls_bit_equal": True, "in_place_bit_equal": True,
             "tolerance": MLSTM_TOL,
             "max_abs_err_vs_chunked": err["chunked"],
             "max_abs_err_vs_sequential": err["sequential"],
             "max_abs_err_vs_kernel_form": err["kernel_form"],
             "prefill_shape": XL_PREFILL, "decode_shape": XL_DECODE,
             **{f"{k}_{shape}": v for shape, t in times.items()
                for k, v in t.items()},
             "seconds": time.perf_counter() - t0}, max(err.values()))


def serve_xlstm_phase(dev, card) -> tuple:
    """The xLSTM serving path at xlstm-350m's full width and depth:
    ServeEngine over the same 8 requests as ``serve``; launch counts read
    around that run; the run teacher-forced through the kernel, through
    its plain version at the kernel's chunk (the plain route), through
    the JAX model's own form (the plain version at ``run.mlstm_chunk``,
    1 at decode) and through the sequential recurrence, on the card; the
    kernel route held to the larger of the bf16 bound's 2e-2 and the
    plain routes' largest distance among themselves; every mLSTM
    call of the kernel run held to its plain version within MLSTM_TOL;
    the kernels' device and eager times at the run's shapes.  Returns (the
    phase's line, {"mlstm": row} for the kernel table)."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    kinds = get_config(XL_ARCH).layer_kinds()
    n_mlstm, n_slstm = kinds.count("mlstm"), kinds.count("slstm")
    calls = n_mlstm * (1 + SERVE_NEW)
    m = serve_main_path(XL_ARCH, dev, {"flash": 0, "decode": 0, "rglru": 0,
                                       "mlstm": calls})
    cfg, run, params, reqs = m["cfg"], m["run"], m["params"], m["reqs"]
    tokens, toks, plen, fed = m["tokens"], m["toks"], m["plen"], m["fed"]

    lk, prefill_ms, decode_ms = teacher_forced(cfg, run, params, toks, plen,
                                               fed)
    lp, prefill_ms_plain, decode_ms_plain = teacher_forced(
        cfg, run, params, toks, plen, fed, mlstm=plain_mlstm)
    # the noise floor of 24 random-weight layers: the largest distance
    # among the three plain forms of the recurrence — the kernel's chunk
    # of 64 (the plain route), the JAX model's own chunking (256 at
    # prefill, 1 at decode) and the sequential recurrence; any two f32
    # summation orders end 4-11 % apart after 24 such layers
    lf, _, _ = teacher_forced(cfg, run, params, toks, plen, fed,
                              mlstm=model_mlstm)
    ls, _, _ = teacher_forced(cfg, run, params, toks, plen, fed,
                              mlstm=seq_mlstm)
    plain_pairs = {}
    for name, a, b in (("model_vs_plain", lf, lp), ("seq_vs_plain", ls, lp),
                       ("model_vs_seq", lf, ls)):
        _, _, _, plain_pairs[name], flips_floor = route_stats(a, b,
                                                              cfg.vocab)
        if flips_floor:
            raise AssertionError(f"{flips_floor} tokens differ between the "
                                 f"plain routes ({name}) outside a near-tie")
    floor = max(plain_pairs.values())
    agree, n_over, worst, rel = compare_routes(
        lk, lp, tokens, cfg.vocab,
        rel_bound=max(TOLS[torch.bfloat16][1], floor))
    check = MlstmCheck()
    teacher_forced(cfg, run, params, toks, plen, fed, mlstm=check)
    if check.over or check.calls != calls:
        raise AssertionError(f"mlstm calls {check.calls}: {check.over} "
                             "elements over the bound")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    # the kernels' times at the run's shapes (device time from a CUDA
    # graph, and eager): prefill from the zero state, then the decode step
    # in place from the state it leaves (random inputs of those shapes)
    B, H = SERVE_BATCH, cfg.n_heads
    dh = 2 * cfg.d_model // H
    pre = mlstm_inputs((B, plen, H, dh), 10, dev)
    _, C, n = xops.mlstm_chunk(*pre)
    dec = mlstm_inputs((B, 1, H, dh), 11, dev, state=(C, n))
    per_shape = {}
    for S, args in ((plen, pre), (1, dec)):
        per_shape[S] = {
            **mlstm_timed(args), **mlstm_bounds((B, S, H, dh)),
            "plain_ms": cuda_ms(lambda: mlstm_chunk_ref(*args,
                                                        xkernel.CHUNK),
                                reps=3)}
    mix = {plen: 1 / (1 + SERVE_NEW), 1: SERVE_NEW / (1 + SERVE_NEW)}
    row = {"launches": m["launches"]["mlstm"],
           **{key: sum(w * per_shape[s][key] for s, w in mix.items())
              for key in ("ms", "plain_ms", "bound_ms")},
           "bound_by": "/".join(sorted({r["bound_by"]
                                        for r in per_shape.values()})),
           "library_ms": None}
    line = {"phase": "serve_xlstm", "card": card, "arch": XL_ARCH,
            "n_params": m["n_params"], "layers": cfg.n_layers,
            "mlstm_layers": n_mlstm, "slstm_layers": n_slstm,
            "heads": H, "head_dim": dh, "chunk": xkernel.CHUNK,
            "batch": SERVE_BATCH, "prompt_lens": [len(r.prompt) for r in reqs],
            "padded_len": plen, "new_tokens": SERVE_NEW,
            "decode_budget": SERVE_BUDGET, "launches": m["launches"],
            "init_s": m["init_s"], "generate_s": m["generate_s"],
            "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
            "plain_prefill_ms": prefill_ms_plain,
            "plain_decode_ms_per_token": decode_ms_plain,
            "token_agreement_plain": agree / (SERVE_BATCH * SERVE_NEW),
            "logits_max_rel_l2": rel, "logits_max_abs_err": worst,
            "logits_elements_over_elementwise_bound": n_over,
            "logits_within_2e-2": rel <= TOLS[torch.bfloat16][1],
            "plain_routes_max_rel_l2": floor,
            "plain_routes_rel_l2": plain_pairs,
            "mlstm_calls_checked": check.calls,
            "mlstm_max_abs_err": check.max_err,
            "mlstm_over_bound": check.over,
            "kernel_ms": {"prefill": per_shape[plen]["ms"],
                          "decode": per_shape[1]["ms"]},
            "kernel_eager_ms": {"prefill": per_shape[plen]["eager_ms"],
                                "decode": per_shape[1]["eager_ms"]},
            "mlstm_bound_ms": {"prefill": per_shape[plen]["bound_ms"],
                               "decode": per_shape[1]["bound_ms"]},
            "mlstm_bound_ms_f32_peak": {
                "prefill": per_shape[plen]["bound_ms_f32_peak"],
                "decode": per_shape[1]["bound_ms_f32_peak"]},
            "mlstm_plain_ms": {"prefill": per_shape[plen]["plain_ms"],
                               "decode": per_shape[1]["plain_ms"]},
            "peak_mem_gb": peak_gb,
            "seconds": time.perf_counter() - t_phase}
    return line, {"mlstm": row}


def near_tie(hi, lo):
    """Where two router logits are within twice the elementwise bf16
    bound: two routes each within the bound may order them either way."""
    atol, rtol = TOLS[torch.bfloat16]
    return (hi - lo).abs() <= 2 * (atol + rtol * hi.abs())


class RouteLog:
    """Stands in for the MoE's router during a run on the card: records
    every call's chosen experts (best first) and counts the slots dropped
    past capacity in prefill calls (S > 1)."""

    def __init__(self):
        self.calls, self.prefill_drops, self.prefill_slots = [], 0, 0

    def __call__(self, cfg, p, x):
        r = ROUTE(cfg, p, x)
        self.calls.append(r.top_e)
        if x.shape[1] > 1:
            self.prefill_drops += moe_lib.drops(r)
            self.prefill_slots += r.keep.numel()
        return r


class ForcedRoute:
    """Stands in for the MoE's router in a reference run on the card: the
    experts a recorded run (``log``) chose, call by call, with this run's
    own router weights for them, so that the two runs differ by their
    attention alone (an expert chosen otherwise at a near-tie would send
    that token, and its row after it, down another path).  Counts the
    tokens whose own choice differs from the recorded one: at a near-tie
    (``near``: the recorded k-th choice's logit and this run's own k-th
    within twice the bf16 bound) and outside one (``outside``: must stay
    0)."""

    def __init__(self, log: RouteLog):
        self.log, self.i, self.near, self.outside = log, 0, 0, 0

    def __call__(self, cfg, p, x):
        logits, probs = moe_lib.router(cfg, p, x)
        k = cfg.moe.top_k
        top_e = self.log.calls[self.i]
        self.i += 1
        lg = torch.sort(logits, -1, descending=True)
        own = lg.indices[..., :k].sort(-1).values
        differ = (own != top_e.sort(-1).values).any(-1)
        rec_kth = logits.gather(-1, top_e).amin(-1)
        tie = near_tie(lg.values[..., k - 1], rec_kth)
        self.near += int((differ & tie).sum())
        self.outside += int((differ & ~tie).sum())
        top_w = probs.gather(-1, top_e)
        return moe_lib.plan(cfg, logits, probs, top_e,
                            top_w / top_w.sum(-1, keepdim=True))


def family_rows(m, dev) -> dict:
    """The attention kernels at every shape the run launched them at, by
    name: launches from the run, device time (a CUDA graph), the plain
    version's time, the bound and SDPA's device time; decode at the least
    kv_len the run gave it (its first step)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for (kind, case), n in sorted(m["by_shape"].items()):
        dtype = torch.bfloat16
        if kind == "flash":
            q, k, v = flash_inputs(case, dtype, 20, dev)
            causal, window = case[6], case[7]
            qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            fn = lambda: fops.flash_attention(  # noqa: E731
                q, k, v, causal=causal, window=window)
            plain = lambda: fops.flash_attention_plain(  # noqa: E731
                q, k, v, causal=causal, window=window)
            lib = lambda: sdpa(qs, ks, vs, is_causal=causal,  # noqa: E731
                               enable_gqa=True)
            work = flash_work(case, dtype)
        else:
            q, k, v = decode_inputs(case, dtype, 21, dev)
            kv_len = case[5]
            live = min(kv_len, case[1])
            qs = q.transpose(1, 2).contiguous()
            kl, vl = (x[:, :live].transpose(1, 2).contiguous()
                      for x in (k, v))
            fn = lambda: dops.decode_attention(q, k, v, kv_len)  # noqa: E731
            plain = lambda: dops.decode_attention_plain(  # noqa: E731
                q, k, v, kv_len)
            lib = lambda: sdpa(qs, kl, vl, enable_gqa=True)  # noqa: E731
            work = decode_work(case, dtype)
        bnd, by = bound_ms(*work, dtype)
        rows[f"{kind} {case}"] = {
            "kernel": kind, "case": list(case), "launches": n,
            "ms": device_ms(fn), "eager_ms": cuda_ms(fn),
            "plain_ms": cuda_ms(plain, reps=3), "bound_ms": bnd,
            "bound_by": by, "library_ms": device_ms(lib)}
    return rows


def serve_family_phase(name, arch, dev, card, *, n_layers=None) -> tuple:
    """A model family the earlier paths do not run, served as ``serve``
    is: ``arch`` at full width (``n_layers`` of its layers when given)
    from seeded random weights, ServeEngine over the same 8 requests
    (the frontend's zero prefix, or the encoder's zero input, of 512 // 8
    positions); launch counts read around that run and held to what the
    model's code implies; the run teacher-forced through the kernels,
    through the kernels' plain versions (the plain route) and through the
    JAX model's own plain attention, on the card; the kernel route's
    logits held to the larger of the bf16 bound's 2e-2 and the plain
    routes' own distance; every attention call of the kernel run held to
    its plain version elementwise; with experts, the reference routes
    take the kernel route's experts (:class:`ForcedRoute`), and every
    token whose own choice would differ is at a near-tie; the prefill's
    dropped slots counted;
    the attention kernels at each shape the run launched them at.  The
    weights are freed at the end.  Returns (the phase's line, {row name:
    kernel row})."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    kinds = cfg.layer_kinds()
    n_attn = kinds.count("attn")
    enc = cfg.enc_layers if cfg.kind == "encdec" else 0
    # flash: every self-attention prefill, the encoder's layers and the
    # cross-attention prefill; flash-decode: every self-attention decode
    # step and every cross-attention decode step
    n_cross = n_attn if cfg.kind == "encdec" else 0
    want = {"flash": n_attn + enc + n_cross,
            "decode": (n_attn + n_cross) * SERVE_NEW, "rglru": 0,
            "mlstm": 0}
    m = serve_main_path(arch, dev, want, cfg=cfg)
    run, params, reqs = m["run"], m["params"], m["reqs"]
    tokens, toks, plen, fed = m["tokens"], m["toks"], m["plen"], m["fed"]
    # the kernel route records its routing; the reference routes take the
    # same experts (their own weights for them) and count where their own
    # choice would differ
    log = RouteLog()
    lk, prefill_ms, decode_ms = teacher_forced(cfg, run, params, toks, plen,
                                               fed, route=log)
    plain_route, model_route = ForcedRoute(log), ForcedRoute(log)
    lp, prefill_ms_plain, decode_ms_plain = teacher_forced(
        cfg, run, params, toks, plen, fed, attention=plain_attention,
        route=plain_route)
    lf, _, _ = teacher_forced(cfg, run, params, toks, plen, fed,
                              attention=MODEL_ATTENTION, route=model_route)
    moe_line = {}
    if cfg.moe is not None:
        if plain_route.outside or model_route.outside:
            raise AssertionError(
                f"{plain_route.outside} (plain) and {model_route.outside} "
                "(model) tokens would route otherwise outside a near-tie")
        if len(log.calls) != cfg.n_layers * (1 + SERVE_NEW):
            raise AssertionError(f"route calls {len(log.calls)}")
        moe_line = {"routing_differs_near_tie_plain": plain_route.near,
                    "routing_differs_near_tie_model": model_route.near,
                    "routed_tokens": sum(t.shape[0] * t.shape[1]
                                         for t in log.calls),
                    "prefill_dropped_slots": log.prefill_drops,
                    "prefill_slots": log.prefill_slots,
                    "capacity_prefill": moe_lib.capacity(cfg.moe, plen),
                    "route_calls": len(log.calls)}
    _, _, _, floor, flips_floor = route_stats(lf, lp, cfg.vocab)
    if flips_floor:
        raise AssertionError(f"{flips_floor} tokens differ between the "
                             "plain routes outside a near-tie")
    agree, n_over, worst, rel = compare_routes(
        lk, lp, tokens, cfg.vocab,
        rel_bound=max(TOLS[torch.bfloat16][1], floor))
    check = AttentionCheck()
    teacher_forced(cfg, run, params, toks, plen, fed, attention=check)
    if check.over or check.calls != want["flash"] + want["decode"]:
        raise AssertionError(f"attention calls {check.calls}: "
                             f"{check.over} elements over the bf16 bound")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    rows = family_rows(m, dev)
    line = {"phase": name, "card": card, "arch": arch,
            "n_params": m["n_params"], "layers": cfg.n_layers,
            "layers_of_config": get_config(arch).n_layers,
            "encoder_layers": enc, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.hd,
            "batch": SERVE_BATCH, "prompt_lens": [len(r.prompt) for r in reqs],
            "padded_len": plen,
            "prefix_or_encoder_len": max(plen // cfg.frontend_len_div, 1)
            if cfg.frontend else 0,
            "new_tokens": SERVE_NEW, "decode_budget": SERVE_BUDGET,
            "launches": m["launches"],
            "launches_by_shape": {k_: r["launches"] for k_, r in rows.items()},
            "init_s": m["init_s"], "generate_s": m["generate_s"],
            "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
            "plain_prefill_ms": prefill_ms_plain,
            "plain_decode_ms_per_token": decode_ms_plain,
            "token_agreement_plain": agree / (SERVE_BATCH * SERVE_NEW),
            "logits_max_rel_l2": rel, "logits_max_abs_err": worst,
            "logits_elements_over_elementwise_bound": n_over,
            "logits_within_2e-2": rel <= TOLS[torch.bfloat16][1],
            "plain_routes_max_rel_l2": floor, **moe_line,
            "attention_calls_checked": check.calls,
            "attention_max_abs_err": check.max_err,
            "attention_over_bound": check.over,
            "kernel_ms": {k_: r["ms"] for k_, r in rows.items()},
            "library_ms": {k_: r["library_ms"] for k_, r in rows.items()},
            "peak_mem_gb": peak_gb,
            "seconds": time.perf_counter() - t_phase}
    del m, params, lk, lp, lf, log, plain_route, model_route
    gc.collect()
    torch.cuda.empty_cache()
    return line, rows


class Timed:
    """Wraps a callable and sums the host seconds spent in it."""

    def __init__(self, fn):
        self.fn, self.seconds, self.calls = fn, 0.0, 0

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.seconds += time.perf_counter() - t0
            self.calls += 1


class LaunchTimer:
    """Inside the ``with``, every megastep launch gets a pair of CUDA events
    around it; ``ms()`` sums their device times (the kernel's own time in
    a run whose host syncs leave gaps between launches)."""

    def __enter__(self):
        self.pairs = []
        self._orig = orig = mkernel.Launch.__call__

        def timed(launch, block=None):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            orig(launch, block)
            e1.record()
            self.pairs.append((e0, e1))

        mkernel.Launch.__call__ = timed
        return self

    def __exit__(self, *exc):
        mkernel.Launch.__call__ = self._orig

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def admission_run(pps, regs, *, pool, table_rows, steps, dev, traced=False,
                  chunk=CHUNK, preempt_every=4, preempt_n=8):
    """Continuous batching over a pool of ``pool`` lanes: the processes
    ``pps`` queue for the pool, their images go into a
    ``FleetImageTable`` of ``table_rows`` rows, free slots take queued
    processes through ``admit_lanes`` (fresh) or ``restore_lanes``
    (checkpoints), each span is one ``run_fleet_span`` of ``steps`` steps,
    and halted lanes are harvested with ``finish_halt_codes`` into a
    carry in process order.  Every ``preempt_every``-th span, while new
    processes wait, ``preempt_n`` running lanes are checkpointed (copies
    of ``unstack_state``/``unstack_trace``), their slots given to the
    queue, and the checkpoints queued behind it.  Traced, every admitted
    lane's ring is checked empty before its first span.  Returns (the
    harvested states, the harvested trace carry or None, counters)."""
    n = len(pps)
    cap = max(pp.cfg.trace_cap for pp in pps)
    table = FleetImageTable(table_rows, device=dev)
    s = fleet.make_halted_states(pool, device=dev)
    tr = fleet.make_empty_trace(pool, cap, device=dev) if traced else None
    ids_host = np.zeros(pool, np.int32)
    ids = torch.from_numpy(ids_host).to(dev)
    out_s = fleet.make_halted_states(n, device=dev)
    out_t = fleet.make_empty_trace(n, cap, device=dev) if traced else None
    queue = collections.deque(("new", i, None) for i in range(n))
    new_left = n
    proc = [-1] * pool   # the process in each slot
    row = [-1] * pool    # its image row
    stats = {"spans": 0, "admitted": 0, "restored": 0, "preempted": 0,
             "harvested": 0, "rings_checked_empty": 0}
    while queue or max(proc) >= 0:
        admit, restore = [], []
        for b in range(pool):
            if proc[b] >= 0 or not queue:
                continue
            kind, i, ck = queue.popleft()
            proc[b], row[b] = i, table.admit(pps[i])
            ids_host[b] = row[b]
            (admit if kind == "new" else restore).append((b, i, ck))
            new_left -= kind == "new"
        if admit:
            slots = [b for b, _, _ in admit]
            fleet.admit_lanes(
                s, slots, [initial_state(pps[i], fuel=FUEL, regs=regs[i])
                           for _, i, _ in admit],
                trace=tr, policies=[None] * len(slots) if traced else None)
            if traced:
                idx = torch.tensor(slots, device=dev)
                if bool(tr.buf[idx].any() | tr.count[idx].any()
                        | tr.hist[idx].any()):
                    raise AssertionError("an admitted lane's ring is not "
                                         "empty")
                stats["rings_checked_empty"] += len(slots)
            stats["admitted"] += len(admit)
        if restore:
            fleet.restore_lanes(
                s, [b for b, _, _ in restore], [ck[0] for _, _, ck in restore],
                trace=tr, lane_traces=[ck[1] for _, _, ck in restore]
                if traced else None)
            stats["restored"] += len(restore)
        ids.copy_(torch.from_numpy(ids_host))
        run_fleet_span(table.images, s, ids, steps=steps, chunk=chunk,
                       trace=tr, device=dev)
        stats["spans"] += 1
        halted, icount, fuel = (x.cpu().numpy() for x in torch.stack(
            [s.halted, s.icount, s.fuel]))
        alive = (halted == fleet.RUNNING) & (icount < fuel)
        done = [b for b in range(pool) if proc[b] >= 0 and not alive[b]]
        if done:
            src = torch.tensor(done, device=dev)
            dst = torch.tensor([proc[b] for b in done], device=dev)
            for o, x in zip((*out_s, *(out_t or ())), (*s, *(tr or ()))):
                o.index_copy_(0, dst, x.index_select(0, src))
            codes = fleet.finish_halt_codes(halted[done], icount[done],
                                            fuel[done])
            out_s.halted.index_copy_(0, dst, torch.from_numpy(codes).to(dev))
            for b in done:
                table.release(row[b])
                proc[b] = -1
            stats["harvested"] += len(done)
        if stats["spans"] % preempt_every == 0 and new_left:
            for b in [b for b in range(pool) if proc[b] >= 0][:preempt_n]:
                ck = (clone(fleet.unstack_state(s, b)),
                      clone(fleet.unstack_trace(tr, b)) if traced else None)
                queue.append(("restore", proc[b], ck))
                table.release(row[b])
                proc[b] = -1
                stats["preempted"] += 1
    stats.update(admissions=table.admissions, dedup_hits=table.dedup_hits)
    return out_s, out_t, stats


def streamed_phase(pps, regs, tr_ref, dev, card) -> dict:
    """The default census traced (cap 64, all-ALLOW) through
    ``run_fleet_stream`` (one chunk a span: chunk 128 > cap) into a
    retaining ``TraceStream``; held against the pins, against the traced
    fixed-width carry ``tr_ref`` (lifetime counts, histograms, each
    lane's last min(count, 64) records) and timed against the traced
    fixed-width driver, in turns."""
    imgs, ids, s, tr = pack_fleet(pps, fuel=FUEL, regs=regs, trace=True,
                                  device=dev)
    sink = TraceStream()
    sink.push_block = pushes = Timed(sink.push_block)
    flips = Timed(fleet.flip_trace)
    fleet.flip_trace, orig_flip = flips, fleet.flip_trace
    try:
        torch.cuda.synchronize()
        mops.megastep_chunk.launches = 0
        t0 = time.perf_counter()
        s_out, t_out = fleet.run_fleet_stream(imgs, s, ids, chunk=CHUNK,
                                              trace=tr, stream=sink,
                                              device=dev)
        torch.cuda.synchronize()
        driver_ms = (time.perf_counter() - t0) * 1e3
        launches = mops.megastep_chunk.launches
    finally:
        fleet.flip_trace = orig_flip
    if launches <= 0:
        raise AssertionError("the streamed census launched no kernel")
    if digest(s_out) != CENSUS_DEFAULT_SHA256:
        raise AssertionError("streamed states differ from the census pin")
    stats = sink.stats()
    got = {k: stats[k] for k in ("records_seen", "records_dropped", "flips")}
    if got != STREAMED_EXPECTED:
        raise AssertionError(f"stream {got}, expected {STREAMED_EXPECTED}")
    sha = stream_digest(sink, len(pps))
    if sha != STREAMED_SHA256:
        raise AssertionError("streamed records differ from the JAX "
                             "package's (sha256)")
    for f in ("count", "hist", "deny_count", "emul_count", "kill_count"):
        if not torch.equal(getattr(t_out, f), getattr(tr_ref, f)):
            raise AssertionError(f"streamed carry's {f} != the traced run's")
    rings = recorder.harvest(tr_ref)
    for b, (recs, _) in enumerate(rings):
        rows = sink.export_key(b)["rows"] if recs else np.zeros((0, 8))
        tail = recorder.decode_rows(rows[len(rows) - len(recs):])
        if tail != recs:
            raise AssertionError(f"lane {b}: streamed tail != ring harvest")
    # the traced fixed-width driver and the streamed one, in turns
    turns = {"traced": [], "streamed": []}
    for who in ("traced", "streamed", "streamed", "traced"):
        imgs_t, ids_t, st, tt = pack_fleet(pps, fuel=FUEL, regs=regs,
                                           trace=True, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if who == "traced":
            mops.run(imgs_t, ids_t, st, tt, chunk=CHUNK)
        else:
            fleet.run_fleet_stream(imgs_t, st, ids_t, chunk=CHUNK, trace=tt,
                                   stream=TraceStream(), device=dev)
        torch.cuda.synchronize()
        turns[who].append((time.perf_counter() - t0) * 1e3)
    return {"phase": "streamed", "card": card, **got,
            "records_sha256": sha, "launches": launches,
            "spans": flips.calls, "driver_ms": driver_ms,
            "flip_host_ms": flips.seconds * 1e3,
            "push_block_host_ms": pushes.seconds * 1e3,
            "in_turns_driver_ms": turns, "mismatched_leaves": 0}


def admission_phase(pps, regs, want, dev, card) -> tuple:
    """The default census through a 128-lane pool with a 32-row image
    table (``admission_run``), untraced (K3) and traced under all-ALLOW
    (K2): every harvested lane equals the same lane of the fixed-width
    runs ``want`` (states; traced, the carry too).  Returns (the phase's
    line, {"K3": launches, "K2": launches})."""
    line, launches = {"phase": "admission", "card": card, "pool": 128,
                      "table_rows": 32, "span_steps": 4 * CHUNK}, {}
    for variant, traced in (("K3", False), ("K2", True)):
        torch.cuda.synchronize()
        mops.megastep_chunk.launches = 0
        t0 = time.perf_counter()
        out_s, out_t, stats = admission_run(
            pps, regs, pool=128, table_rows=32, steps=4 * CHUNK, dev=dev,
            traced=traced)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches[variant] = mops.megastep_chunk.launches
        if launches[variant] <= 0:
            raise AssertionError(f"admission {variant} launched no kernel")
        bad = mismatched(want[0], out_s) + (
            mismatched(want[1], out_t) if traced else [])
        if bad:
            raise AssertionError(f"admission {variant}: harvested lanes != "
                                 f"the fixed-width census: {bad}")
        if not stats["preempted"] or stats["restored"] != stats["preempted"]:
            raise AssertionError(f"admission {variant}: {stats}")
        line[variant] = {**stats, "launches": launches[variant],
                         "driver_ms": ms}
    line["mismatched_leaves"] = 0
    return line, launches


def compact_phase(pps, regs, dev, card) -> tuple:
    """``run_fleet_prepared(compact=True)`` on the default census, untraced
    (K3) and traced (K2), against the census pins and the JAX package's
    occupancy ledgers; then the kernel's time (CUDA events around each
    launch) and the driver's, compacted against fixed width, in turns.
    Returns (the phase's line, {"K3": launches, "K2": launches})."""
    ladder = precompile_compact(pps, device=dev)
    line = {"phase": "compact", "card": card, "ladder": ladder}
    launches = {}
    for variant, traced in (("K3", False), ("K2", True)):
        stats = {}
        mops.megastep_chunk.launches = 0
        got = run_fleet_prepared(pps, fuel=FUEL, chunk=CHUNK, regs=regs,
                                 trace=traced, compact=True,
                                 compact_stats=stats, device=dev)
        torch.cuda.synchronize()
        launches[variant] = mops.megastep_chunk.launches
        if launches[variant] <= 0:
            raise AssertionError(f"compact {variant} launched no kernel")
        shas = (digest(got[0]), digest(got[1])) if traced else (digest(got),)
        want = ((CENSUS_DEFAULT_SHA256, TRACED_SHA256) if traced
                else (CENSUS_DEFAULT_SHA256,))
        if shas != want:
            raise AssertionError(f"compacted {variant} census differs from "
                                 "the pins (sha256)")
        pin = COMPACT_STATS_TRACED if traced else COMPACT_STATS
        if stats != pin:
            raise AssertionError(f"compact {variant} ledger {stats}, "
                                 f"expected {pin}")
        line[variant] = {"launches": launches[variant], "stats": stats}
    # fixed width and compacted, K3, in turns: the kernel's and the
    # driver's time from a fresh pack each
    turns = {"fixed": [], "compact": []}
    for who in ("fixed", "compact", "compact", "fixed"):
        imgs, ids, s = pack_fleet(pps, fuel=FUEL, regs=regs, device=dev)
        torch.cuda.synchronize()
        with LaunchTimer() as timer:
            t0 = time.perf_counter()
            if who == "fixed":
                mops.run(imgs, ids, s, chunk=CHUNK)
            else:
                fleet.run_fleet_compact(
                    imgs, s, ids, chunk=CHUNK,
                    min_bucket=HookConfig().compact_min_bucket,
                    hysteresis=HookConfig().compact_hysteresis, device=dev)
            torch.cuda.synchronize()
            driver_ms = (time.perf_counter() - t0) * 1e3
        turns[who].append({"kernel_ms": timer.ms(), "driver_ms": driver_ms,
                           "launches": len(timer.pairs)})
    line.update(in_turns=turns, mismatched_leaves=0)
    return line, launches


# -- the fleet server ---------------------------------------------------------
#
# The helpers take the package (PORT here, the JAX package in
# scripts/torch_port_pins.py) so both servers are driven the same way.

PORT = types.SimpleNamespace(
    FleetServer=FleetServer, PolicyScheduler=PolicyScheduler,
    TenantBudget=TenantBudget, prepare=prepare, programs=programs,
    Mechanism=Mechanism, HookConfig=HookConfig,
    DurabilityManager=DurabilityManager, ChaosMonkey=ChaosMonkey)

SERVED_STATS = (
    "generations", "dispatches", "completed", "harvested_steps",
    "discarded_steps", "c3_readmissions", "scalar_reexecutions",
    "image_admissions", "image_dedup_hits", "enosys_total",
    "emul_served_total", "trace_records", "trace_dropped",
    "trace_histogram", "dispatched_steps", "executed_steps", "occupancy",
    "pool_grows", "pool_shrinks", "min_bucket_seen", "admission_waits",
    "admission_wait_gens_mean", "admission_wait_gens_max", "resume_waits")


def json_sha(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()
                          ).hexdigest()


def publication_ledger(results) -> list:
    """[rid, admitted_gen, completed_gen, attempts, preemptions], by rid:
    the server's host decisions, which count generations, not time."""
    return sorted([int(r.rid), int(r.admitted_gen), int(r.completed_gen),
                   int(r.attempts), int(r.preemptions)] for r in results)


def records_digest(results) -> str:
    """sha256 of every published trace record, rids in order, each rid's
    records in sequence order, 8 int64 words each: stream_digest's
    format, so rid i's records digest as a stream's key i."""
    h = hashlib.sha256()
    for r in sorted(results, key=lambda r: r.rid):
        if r.trace:
            h.update(np.asarray([dataclasses.astuple(x) for x in r.trace],
                                np.int64).tobytes())
    return h.hexdigest()


def census_server(pkg, pps, regs, **kw):
    """A FS_POOL-lane server of ``pkg`` with the census queued on it in
    census order (request i is census lane i)."""
    srv = pkg.FleetServer(pool=FS_POOL, gen_steps=FS_GEN_STEPS, chunk=CHUNK,
                          fuel=FUEL, **kw)
    for pp, rg in zip(pps, regs):
        srv.submit(pp, regs=rg)
    return srv


def served_summary(srv, results) -> dict:
    """The served census's deterministic stats and publication ledger."""
    st = srv.stats()
    out = {k: st[k] for k in SERVED_STATS}
    out["stream"] = {k: st["stream"][k] for k in
                     ("records_seen", "records_emitted", "records_dropped",
                      "flips", "buffered_records")} if st["stream"] else {}
    out["ledger_sha256"] = json_sha(publication_ledger(results))
    return out


def sched_mix(pkg, mix=SCHED_MIX):
    """benchmarks/policy_scheduler.py's build_mix in ``pkg``: ``n_noisy``
    svc storms (unhooked) and ``n_victim`` short hooked getpid loops, as
    [(prepared process, entry registers)] each."""
    storm = pkg.prepare(pkg.programs.syscall_storm_param(),
                        pkg.Mechanism.NONE)
    victim = pkg.prepare(pkg.programs.getpid_loop_param(),
                         pkg.Mechanism.ASC, virtualize=True)
    return ([(storm, {19: mix["storm_iters"], 20: 4, 21: 20})]
            * mix["n_noisy"],
            [(victim, {19: mix["victim_iters"]})] * mix["n_victim"])


def serve_sched_mix(pkg, noisy, vics, *, scheduled, mix=SCHED_MIX, **kw):
    """benchmarks/policy_scheduler.py's serve_mix on ``pkg``'s server: the
    storms first, one generation, then the deadline-carrying victims;
    traced (the budget reads the verdict counters).  Returns (the
    deterministic summary, the server, {rid: result}, {rid: tenant})."""
    sched = (pkg.PolicyScheduler(budgets={"noisy": pkg.TenantBudget(
        max_svc=mix["budget_svc"])}) if scheduled else None)
    srv = pkg.FleetServer(pool=mix["pool"], gen_steps=mix["gen_steps"],
                          chunk=mix["chunk"], fuel=FUEL, scheduler=sched,
                          trace=True, **kw)
    meta = {}
    for pp, rg in noisy:
        meta[srv.submit(pp, regs=rg, tenant="noisy", priority=0)] = "noisy"
    results = {r.rid: r for r in srv.step()}
    for pp, rg in vics:
        meta[srv.submit(pp, regs=rg, tenant="victim", priority=10,
                        deadline_steps=mix["deadline_steps"])] = "victim"
    for r in srv.run():
        results[r.rid] = r
    if len(results) != len(meta):
        raise AssertionError(f"{len(results)} of {len(meta)} published")
    lat = {"noisy": [], "victim": []}
    for rid, tenant in meta.items():
        lat[tenant].append(results[rid].completed_gen
                           - results[rid].submitted_gen)
    st = srv.stats()
    summary = {
        **{k: st[k] for k in ("generations", "idle_generations",
                              "preemptions", "evictions",
                              "budget_exhaustions", "quarantine_blocks",
                              "trace_records", "trace_dropped")},
        "quarantine_events": (len(st["quarantine"]["events"])
                              if st["quarantine"] else 0),
        "tenants": st["tenants"],
        "victim_latency_gens": {
            "p50": float(np.percentile(lat["victim"], 50)),
            "p95": float(np.percentile(lat["victim"], 95)),
            "max": int(np.max(lat["victim"]))},
        "noisy_latency_gens": {
            "p50": float(np.percentile(lat["noisy"], 50)),
            "p95": float(np.percentile(lat["noisy"], 95))},
        "preempted_results": sum(r.preemptions > 0
                                 for r in results.values()),
        "ledger_sha256": json_sha(publication_ledger(results.values()))}
    return summary, srv, results, meta


def c3_request(pkg, srv):
    """tests/test_fleet_server.py's C3 workload (indirect_svc(3), hooked,
    virtualized) served on ``srv`` after what it served before.  Returns
    (the result, its deterministic summary)."""
    rid = srv.submit(lambda: pkg.programs.indirect_svc(3), virtualize=True,
                     tenant="c3")
    res = {r.rid: r for r in srv.run()}[rid]
    st = srv.stats()
    return res, {"events": [dataclasses.asdict(e) for e in res.events],
                 "attempts": res.attempts, "halted": int(res.state.halted),
                 "state_sha256": digest(res.state),
                 "c3_readmissions": st["c3_readmissions"],
                 "scalar_reexecutions": st["scalar_reexecutions"]}


def drained(srv) -> bool:
    return (not srv._queue and not srv._readmit
            and all(r is None for r in srv._slots))


def durable_census(pkg, pps, regs, directory=None, **kw):
    """benchmarks/durability_overhead.py's run_server on ``pkg``'s server,
    observed: the census at DUR_POOL lanes, durable in ``directory`` (or
    plain without one).  Returns (the server, its results, the seconds
    the submits took: a durable submit journals the request)."""
    dur = pkg.DurabilityManager(directory) if directory is not None else None
    srv = pkg.FleetServer(pool=DUR_POOL, gen_steps=FS_GEN_STEPS, chunk=CHUNK,
                          fuel=FUEL,
                          cfg=pkg.HookConfig(snapshot_interval=DUR_INTERVAL),
                          durability=dur, obs=True, **kw)
    t0 = time.perf_counter()
    for pp, rg in zip(pps, regs):
        srv.submit(pp, regs=rg)
    submit_s = time.perf_counter() - t0
    return srv, srv.run(), submit_s


def durable_summary(srv, results) -> dict:
    st = srv.stats()
    return {"generations": st["generations"], "snapshots": st["snapshots"],
            "journal_records": st["journal_records"],
            "ledger_sha256": json_sha(publication_ledger(results))}


def kill_and_recover(pkg, make, directory, kill_after, *, watch=None, **kw):
    """A durable server ``make()`` stepped ``kill_after`` generations and
    dropped, then ``pkg.FleetServer.recover(directory, **kw)`` and drained
    (benchmarks/durability_overhead.py's run_kill_recover).  ``watch``
    reads the server just before the kill.  Returns (the recovered
    server, the results by rid — at-least-once, the last wins — the
    deterministic counts, the wall times, what ``watch`` read)."""
    srv = make()
    pre = []
    for _ in range(kill_after):
        if drained(srv):
            break
        pre.extend(srv.step())
    counts_ = {"killed_at_generation": srv.generation}
    seen = watch(srv) if watch is not None else None
    del srv                                    # the crash
    t0 = time.perf_counter()
    srv, replayed = pkg.FleetServer.recover(directory, **kw)
    restore_s = time.perf_counter() - t0
    post = srv.run()
    walls = {"restore_s": restore_s,
             "drain_s": time.perf_counter() - t0 - restore_s}
    union = {}
    for r in pre + replayed + post:
        union[r.rid] = r
    counts_.update(replayed_generations=srv.stats()["recovery_generations"],
                   replayed_results=len(replayed))
    return srv, union, counts_, walls, seen


def obs_watermark(srv) -> dict:
    """What a scraper reads from an observed server: counter series, phase
    counts, the generation count and the span events."""
    hub = srv._obs
    return {"counters": hub.registry.counter_watermark(),
            "phases": dict(hub.profiler.counts),
            "generations": hub.profiler.gen_count,
            "events": dict(hub.spans.summary()["events"])}


def not_below(after: dict, before: dict) -> list:
    """The series of ``before`` (obs_watermark) that ``after`` fell
    below."""
    out = [k for k, v in before["counters"].items()
           if after["counters"].get(k, 0) < v]
    out += [k for k, v in before["phases"].items()
            if after["phases"].get(k, 0) < v]
    out += [k for k, v in before["events"].items()
            if after["events"].get(k, 0) < v]
    if after["generations"] < before["generations"]:
        out.append("generations")
    return out


def chaos_census(pkg, pps, regs, directory, **kw):
    """The census at FS_POOL lanes under the soak's chaos (SOAK_CFG),
    stepped until drained.  Returns (the server, results by rid)."""
    srv = pkg.FleetServer(pool=FS_POOL, gen_steps=FS_GEN_STEPS, chunk=CHUNK,
                          fuel=FUEL, cfg=pkg.HookConfig(**SOAK_CFG),
                          durability=pkg.DurabilityManager(directory),
                          chaos=pkg.ChaosMonkey(), **kw)
    for pp, rg in zip(pps, regs):
        srv.submit(pp, regs=rg)
    out = {}
    for _ in range(100_000):
        if drained(srv):
            break
        for r in srv.step():
            out[r.rid] = r
    return srv, out


def soak_summary(srv) -> dict:
    st = srv.stats()
    summ = srv._chaos.summary()
    return {"injections": summ["injections"], "by_kind": summ["by_kind"],
            "by_resolution": summ["by_resolution"],
            "unresolved": summ["unresolved"],
            **{k: st[k] for k in ("generations", "rollbacks", "retries",
                                  "recovery_generations", "watchdog_trips",
                                  "snapshots", "snapshot_rewrites")},
            "shed_rids": sorted(e["rid"] for e in st["shed"]),
            "ledger_sha256": json_sha(srv._chaos.injections)}


def injected_flip(got_mem, want_mem, ledger) -> bool:
    """``got_mem`` (one lane's memory, host) differs from ``want_mem`` in
    exactly one word, by one bit-flip of the chaos ledger."""
    diff = np.asarray(got_mem) ^ np.asarray(want_mem)
    words = np.flatnonzero(diff)
    return len(words) == 1 and any(
        i["kind"] == "bitflip" and i["word"] == words[0]
        and diff[words[0]] == np.int64(1) << np.int64(i["bit"])
        for i in ledger)


def differs(got: dict, want: dict) -> list:
    return sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))


def equal_to_solo(states, solo) -> list:
    """The leaves on which any of ``states`` differs from ``solo``."""
    st = fleet.stack_states(states)
    return [f for f, x, y in zip(st._fields, st, solo)
            if not torch.equal(x, y.unsqueeze(0).expand_as(x))]


def run_counted(name, fn) -> tuple:
    """``fn()`` with the megastep's launch count set to 0 just before and
    read just after, and every launch timed on the card (LaunchTimer).
    Returns (what ``fn`` returned, {launches, ms, kernel_ms,
    device_idle_share}); raises if the run launched no kernel."""
    torch.cuda.synchronize()
    mops.megastep_chunk.launches = 0
    with LaunchTimer() as timer:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    launches = mops.megastep_chunk.launches
    if launches <= 0:
        raise AssertionError(f"{name} launched no kernel")
    kernel_ms = timer.ms()
    return out, {"launches": launches, "ms": ms, "kernel_ms": kernel_ms,
                 "device_idle_share": 1 - kernel_ms / ms}


def fleet_server_phase(pps, regs, want, dev, card) -> tuple:
    """The fleet server on the card, three arms (PERF.md section 4):

    * ``served``: the census through FS_POOL lanes, untraced (K3); every
      published state equal to ``want``'s lane (the fixed-width census),
      the JAX server's ledger and stats, no scalar re-execution;
    * ``served_traced``: the same, traced, streamed, compacted and
      observed (K2); 0 records dropped, the records by rid equal to the
      census stream's (STREAMED_SHA256), the states equal to ``served``'s,
      the profiler's phase breakdown;
    * ``scheduled``: the noisy-neighbor mix unscheduled and scheduled
      (K2), every state equal to its solo run on the card, the JAX
      server's scheduler counters; then one C3 request on the scheduled
      server, its events equal to ``run_with_c3``'s and the JAX pin's.

    Returns (the phase's line, its breakdown line, {arm: launches})."""
    line = {"phase": "fleet_server", "card": card, "pool": FS_POOL,
            "gen_steps": FS_GEN_STEPS, "chunk": CHUNK}
    launches = {}

    def drive(arm, fn):
        out, timing = run_counted(f"fleet_server {arm}", fn)
        launches[arm] = timing["launches"]
        return out, timing

    stacked = {}
    for arm, kw, pin in (
            ("served", {}, FS_SERVED_EXPECTED),
            ("served_traced", {"trace": True, "stream": True,
                               "compact": True, "obs": True},
             FS_TRACED_EXPECTED)):
        srv = census_server(PORT, pps, regs, device=dev, **kw)
        srv.precompile_ladder()
        results, timing = drive(arm, srv.run)
        by_rid = sorted(results, key=lambda r: r.rid)
        if [r.rid for r in by_rid] != list(range(len(pps))):
            raise AssertionError(f"{arm}: published rids differ")
        stacked[arm] = fleet.stack_states([r.state for r in by_rid])
        bad = mismatched(want, stacked[arm])
        if bad or digest(stacked[arm]) != CENSUS_DEFAULT_SHA256:
            raise AssertionError(f"{arm}: served states != the census: {bad}")
        got = served_summary(srv, results)
        if got["scalar_reexecutions"] or differs(got, pin):
            raise AssertionError(f"{arm}: {differs(got, pin)} differ from "
                                 f"the JAX server's: {got}")
        line[arm] = {**timing, "generations": got["generations"],
                     "occupancy": got["occupancy"],
                     "ledger_sha256": got["ledger_sha256"]}
        if arm == "served_traced":
            sha = records_digest(results)
            if got["stream"]["records_dropped"] or sha != STREAMED_SHA256:
                raise AssertionError("served_traced: records dropped or "
                                     "differing from the census stream")
            line[arm].update(records=got["trace_records"],
                             records_sha256=sha,
                             pool_shrinks=got["pool_shrinks"],
                             min_bucket_seen=got["min_bucket_seen"])
            m = srv.metrics()
            breakdown = {
                "phase": "fleet_server_breakdown", "card": card,
                "arm": arm, "generation_ms": m["generation"]["total_s"] * 1e3,
                "generations": m["generation"]["count"],
                "phase_coverage": m["phase_coverage"],
                "phases_ms": {k: v["total_s"] * 1e3
                              for k, v in m["phases"].items()},
                "phase_counts": {k: v["count"]
                                 for k, v in m["phases"].items()}}
    bad = mismatched(stacked["served"], stacked["served_traced"])
    if bad:
        raise AssertionError(f"served_traced states != served's: {bad}")

    noisy, vics = sched_mix(PORT)
    solo = {"noisy": run_prepared(noisy[0][0], fuel=FUEL, regs=noisy[0][1],
                                  device=dev),
            "victim": run_prepared(vics[0][0], fuel=FUEL, regs=vics[0][1],
                                   device=dev)}
    line["scheduled"] = {"mix": SCHED_MIX}
    for arm, scheduled in (("unscheduled", False), ("scheduled", True)):
        (got, srv, results, meta), timing = drive(
            arm, lambda: serve_sched_mix(PORT, noisy, vics,
                                         scheduled=scheduled, device=dev))
        for tenant in ("noisy", "victim"):
            bad = equal_to_solo([results[rid].state for rid, t in meta.items()
                                 if t == tenant], solo[tenant])
            if bad:
                raise AssertionError(f"{arm} {tenant}: published states != "
                                     f"the solo run: {bad}")
        pin = FS_SCHED_EXPECTED[arm]
        if differs(got, pin):
            raise AssertionError(f"{arm}: {differs(got, pin)} differ from "
                                 f"the JAX server's: {got}")
        line["scheduled"][arm] = {**timing, **{
            k: got[k] for k in ("generations", "preemptions", "evictions",
                                "budget_exhaustions", "quarantine_events",
                                "preempted_results", "victim_latency_gens")}}
    if not line["scheduled"]["scheduled"]["preempted_results"]:
        raise AssertionError("the scheduled mix restored no preempted lane")
    (res, got), timing = drive("c3", lambda: c3_request(PORT, srv))
    ref, _, ev_ref, runs_ref = run_with_c3(
        lambda: programs.indirect_svc(3), cfg=HookConfig(), virtualize=True,
        fuel=FUEL, device=dev)
    if ([dataclasses.asdict(e) for e in ev_ref] != got["events"]
            or runs_ref != got["attempts"] or mismatched(ref, res.state)
            or got["scalar_reexecutions"] or got["c3_readmissions"] != 1
            or differs(got, FS_C3_EXPECTED)):
        raise AssertionError(f"C3 request {got}: run_with_c3 gave "
                             f"{ev_ref} in {runs_ref} runs")
    line["c3"] = {**timing, **got}
    line["mismatched_leaves"] = 0
    return line, breakdown, launches


def states_by_rid(results, n) -> MachineState:
    """Published states stacked by rid (rids 0..n-1, each once)."""
    by_rid = sorted(results, key=lambda r: r.rid)
    if [r.rid for r in by_rid] != list(range(n)):
        raise AssertionError("published rids differ from the requests")
    return fleet.stack_states([r.state for r in by_rid])


def durable_server_phase(pps, regs, want, dev, card) -> tuple:
    """Durable serving and chaos on the card, four arms (PERF.md section 4),
    each against the JAX server's pins:

    * ``durable``: the census through DUR_POOL lanes (K3), plain then
      durable in a directory of its own; every published state equal to
      ``want``'s lane (the census pin by rid), the durable publication
      ledger equal to the plain one; both wall times and the overhead,
      the snapshots and journal, the profiler's journal and snapshot
      phases;
    * ``kill_recover``: the durable server killed after DUR_KILL
      generations, ``FleetServer.recover``-ed and drained; the union by
      rid equal to the census;
    * ``traced_recover``: fleet_server's ``served_traced`` server (K2)
      durable, killed at TRACED_KILL and recovered; the records by rid
      the census stream's (STREAMED_SHA256), 0 dropped, the obs counters
      not below what the dead server showed;
    * ``chaos_soak``: the census at FS_POOL lanes under SOAK_CFG (K3);
      the ledger the JAX server's, every published state the census
      lane's but those a bit-flip reached before any boundary verified
      it (ROADMAP Queue 3), each of which differs by exactly that bit;
      shed and published together every rid.

    Returns (one line per arm, {arm: launches})."""
    lines, launches = [], {}
    n = len(pps)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-durable-") as tmp:
        tmp = Path(tmp)
        runs = {}
        for arm, d in (("plain", None), ("durable", tmp / "durable")):
            (srv, res, submit_s), timing = run_counted(
                f"durable_server {arm}",
                lambda: durable_census(PORT, pps, regs, d, device=dev))
            timing["submit_ms"] = submit_s * 1e3
            bad = mismatched(want, states_by_rid(res, n))
            if bad:
                raise AssertionError(f"durable {arm}: states != the census: "
                                     f"{bad}")
            runs[arm] = (srv, res, timing)
        (srv, res, timing), (_, res_p, t_plain) = runs["durable"], \
            runs["plain"]
        launches["durable"] = timing["launches"] + t_plain["launches"]
        if publication_ledger(res) != publication_ledger(res_p):
            raise AssertionError("durable: publication ledger != plain's")
        got = durable_summary(srv, res)
        if differs(got, DURABLE_EXPECTED):
            raise AssertionError(f"durable: {differs(got, DURABLE_EXPECTED)} "
                                 f"differ from the JAX server's: {got}")
        phases = srv.metrics()["phases"]
        st = srv.stats()
        lines.append({
            "phase": "durable_server", "arm": "durable", "card": card,
            "pool": DUR_POOL, "gen_steps": FS_GEN_STEPS, "chunk": CHUNK,
            "snapshot_interval": DUR_INTERVAL, **got,
            "snapshot_bytes": st["snapshot_bytes"],
            "plain": t_plain, "durable": timing,
            "overhead_pct": 100 * (timing["ms"] - t_plain["ms"])
            / t_plain["ms"], "reference_bar_pct": OVERHEAD_BAR_PCT,
            "phases_ms": {k: phases[k]["total_s"] * 1e3 for k in
                          ("journal_append", "snapshot_write")
                          if k in phases},
            "phase_counts": {k: phases[k]["count"] for k in
                             ("journal_append", "snapshot_write")
                             if k in phases},
            "mismatched_leaves": 0})
        del srv, res, res_p, runs

        def victim():
            s = FleetServer(pool=DUR_POOL, gen_steps=FS_GEN_STEPS,
                            chunk=CHUNK, fuel=FUEL,
                            cfg=HookConfig(snapshot_interval=DUR_INTERVAL),
                            durability=DurabilityManager(tmp / "victim"),
                            device=dev)
            for pp, rg in zip(pps, regs):
                s.submit(pp, regs=rg)
            return s
        (srv, union, got, walls, _), timing = run_counted(
            "durable_server kill_recover", lambda: kill_and_recover(
                PORT, victim, tmp / "victim", DUR_KILL, device=dev))
        launches["kill_recover"] = timing["launches"]
        bad = mismatched(want, states_by_rid(union.values(), n))
        if bad or differs(got, KILL_RECOVER_EXPECTED):
            raise AssertionError(f"kill_recover: states {bad}, counts "
                                 f"{got} (JAX: {KILL_RECOVER_EXPECTED})")
        lines.append({"phase": "durable_server", "arm": "kill_recover",
                      "card": card, **got, **walls, **timing,
                      "mismatched_leaves": 0})
        del srv, union

        (srv, union, got, walls, before), timing = run_counted(
            "durable_server traced_recover", lambda: kill_and_recover(
                PORT, lambda: census_server(
                    PORT, pps, regs, trace=True, stream=True, compact=True,
                    obs=True, durability=DurabilityManager(tmp / "traced"),
                    device=dev),
                tmp / "traced", TRACED_KILL, watch=obs_watermark,
                device=dev))
        launches["traced_recover"] = timing["launches"]
        below = not_below(obs_watermark(srv), before)
        sha = records_digest(union.values())
        got["records"] = sum(len(r.trace) for r in union.values())
        dropped = srv.stats()["stream"]["records_dropped"]
        bad = mismatched(want, states_by_rid(union.values(), n))
        if (bad or below or dropped or sha != STREAMED_SHA256
                or differs(got, TRACED_RECOVER_EXPECTED)):
            raise AssertionError(
                f"traced_recover: states {bad}, obs below the dead "
                f"server's {below}, {dropped} dropped, records "
                f"{sha == STREAMED_SHA256}, counts {got} (JAX: "
                f"{TRACED_RECOVER_EXPECTED})")
        lines.append({"phase": "durable_server", "arm": "traced_recover",
                      "card": card, **got, "records_sha256": sha,
                      "records_dropped": dropped, "obs_below": below,
                      **walls, **timing, "mismatched_leaves": 0})
        del srv, union

        (srv, got), timing = run_counted(
            "durable_server chaos_soak",
            lambda: chaos_census(PORT, pps, regs, tmp / "soak", device=dev))
        launches["chaos_soak"] = timing["launches"]
        summary = soak_summary(srv)
        shed = set(summary["shed_rids"])
        if set(got) | shed != set(range(n)) or set(got) & shed:
            raise AssertionError("chaos_soak: published and shed do not "
                                 "partition the requests")
        rids = sorted(got)
        pub = fleet.stack_states([got[r].state for r in rids])
        ref = MachineState(*(x.index_select(
            0, torch.tensor(rids, device=dev)) for x in want))
        escaped = []
        for f, a, b in zip(pub._fields, pub, ref):
            lanes = (a != b).reshape(len(rids), -1).any(1).nonzero()
            lanes = lanes.reshape(-1).tolist()
            if lanes and f != "mem":
                raise AssertionError(f"chaos_soak: {f} of rids "
                                     f"{[rids[i] for i in lanes]} != census")
            for i in lanes:
                if not injected_flip(a[i].cpu().numpy(), b[i].cpu().numpy(),
                                     srv._chaos.injections):
                    raise AssertionError(f"chaos_soak: rid {rids[i]}'s mem "
                                         "differs beyond an injected flip")
                escaped.append(rids[i])
        summary["escaped_flip_rids"] = escaped
        if differs(summary, CHAOS_SOAK_EXPECTED):
            raise AssertionError(
                f"chaos_soak: {differs(summary, CHAOS_SOAK_EXPECTED)} "
                f"differ from the JAX server's: {summary}")
        lines.append({"phase": "durable_server", "arm": "chaos_soak",
                      "card": card, "pool": FS_POOL, "cfg": SOAK_CFG,
                      **summary, **timing})
    return lines, launches


def shard_phase(pps, regs, want, dev, card) -> tuple:
    """Lane sharding through the entry points (K3): the census through
    ``run_fleet_prepared(shard=True)``, a ``FleetServer(shard=True)`` and
    a durable ``FleetServer(shard=True)``, each on every visible card
    (``device=None``).  With one card the mesh has one device and
    ``shard=True`` is the no-op path: every pin is the unsharded run's
    (the census's counts and sha256, the JAX server's stats and ledger,
    the JAX durable server's generations, snapshots and journal records);
    the journal's ``open`` record says ``shard: true``; and
    ``engine="pallas"`` with ``shard=True`` raises ``ValueError``, as in
    the JAX package.  Returns (the phase's line, {arm: launches})."""
    mesh = sharding.fleet_mesh()
    line = {"phase": "shard", "card": card, "devices": mesh.size,
            "divisor": sharding.fleet_divisor(len(pps), mesh)}
    launches = {}
    out, timing = run_counted("shard census", lambda: run_fleet_prepared(
        pps, fuel=FUEL, chunk=CHUNK, regs=regs, shard=True))
    got = counts(out)
    chunks = math.ceil(got["longest_lane_steps"] / CHUNK)
    if (got != CENSUS_DEFAULT_EXPECTED or digest(out) != CENSUS_DEFAULT_SHA256
            or mismatched(out, want)
            or timing["launches"] != chunks * mesh.size):
        raise AssertionError(f"sharded census: {got}, launches "
                             f"{timing['launches']} for {chunks} chunks")
    launches["census"] = timing["launches"]
    line["census"] = {**timing, "sha256": digest(out)}

    srv = census_server(PORT, pps, regs, shard=True)
    results, timing = run_counted("shard fleet_server", srv.run)
    states = fleet.stack_states([r.state for r in sorted(
        results, key=lambda r: r.rid)])
    got = served_summary(srv, results)
    bad = differs(got, FS_SERVED_EXPECTED)
    if bad or mismatched(want, states):
        raise AssertionError(f"sharded server: {bad} differ from the JAX "
                             "server's, or a state from the census's")
    launches["fleet_server"] = timing["launches"]
    line["fleet_server"] = {**timing, "ledger_sha256": got["ledger_sha256"]}

    with tempfile.TemporaryDirectory(prefix="chip-smoke-shard-") as d:
        (srv, res, _), timing = run_counted(
            "shard durable", lambda: durable_census(PORT, pps, regs, d,
                                                    shard=True))
        got = durable_summary(srv, res)
        recs, _ = Journal.replay(Path(d) / "journal.jsonl")
        opened = recs[0]["server"]
        del srv
    if differs(got, DURABLE_EXPECTED) or opened["shard"] is not True:
        raise AssertionError(f"sharded durable server: "
                             f"{differs(got, DURABLE_EXPECTED)}, open record "
                             f"shard={opened['shard']}")
    launches["durable_server"] = timing["launches"]
    line["durable_server"] = {**timing, **got,
                              "open_record_shard": opened["shard"]}

    raised = []
    for name, call in (
            ("run_fleet_prepared", lambda: run_fleet_prepared(
                pps[:2], fuel=FUEL, chunk=CHUNK, regs=regs[:2], shard=True,
                engine="pallas")),
            ("FleetServer", lambda: FleetServer(pool=2, shard=True,
                                                engine="pallas"))):
        try:
            call()
        except ValueError as e:
            raised.append(name)
            line.setdefault("pallas_shard_error", str(e))
    if len(raised) != 2:
        raise AssertionError(f"engine='pallas', shard=True raised only for "
                             f"{raised}")
    line["pallas_shard_raises"] = raised
    return line, launches


# -- training (the JAX package's train/ and optim/, on the card) --------------
# train_pins: SMOKE configs, numpy-seeded parameters saved as a step-0
# checkpoint, run_training for TRAIN_STEPS steps straight and with a crash
# at TRAIN_FAIL_AT then a resume; the losses pinned from the JAX package
# (scripts/torch_port_pins.py --only train)
TRAIN_ARCHS = ("qwen3-1.7b", "recurrentgemma-2b")
TRAIN_SHAPE = (32, 4)             # seq_len, global batch
TRAIN_STEPS = 10
TRAIN_FAIL_AT = 5
TRAIN_PARAM_SEED = 0
TRAIN_DATA_SEED = 3
TRAIN_RUN = dict(attn_chunk=8, mlstm_chunk=8, remat_policy="nothing",
                 loss_chunk=8, warmup_steps=2, total_steps=30,
                 learning_rate=3e-3, ckpt_every=5, z_loss=1e-4)
TRAIN_TOL = 2e-2                  # relative, a step's loss (bf16 bound)
TRAIN_PINS = {  # the JAX package's straight-run losses
    "qwen3-1.7b": [6.091129302978516, 6.057677745819092, 5.635338306427002,
                   5.766507148742676, 5.872946262359619, 5.232533931732178,
                   5.586441993713379, 5.89182186126709, 5.963068962097168,
                   5.163453578948975],
    "recurrentgemma-2b": [6.2999348640441895, 6.371365547180176,
                          5.434496879577637, 5.884324550628662,
                          5.8923563957214355, 4.907963275909424,
                          4.815901756286621, 5.42406702041626,
                          5.73120641708374, 4.167857646942139],
}
# train_full: qwen3-1.7b at full width and depth, three steps through
# make_train_step, every tile checkpointed, the head and xent in chunks
FULL_TRAIN_ARCH = "qwen3-1.7b"
FULL_TRAIN_SHAPE = (512, 4)
FULL_TRAIN_STEPS = 3
FULL_TRAIN_RUN = dict(remat_policy="nothing", loss_chunk=128)
MODEL_KERNELS = {"flash_attention": fops.flash_attention,
                 "decode_attention": dops.decode_attention,
                 "rglru_scan": rops.rglru_scan,
                 "mlstm_chunk": xops.mlstm_chunk}
# dense_init's scales where a leaf's is not 1/sqrt(fan_in)
_INIT_SCALES = {"conv": 0.3, "wi": 0.02, "wf": 0.02, "ri": 0.02, "rf": 0.02,
                "router": 0.02}

PORT_TRAIN = types.SimpleNamespace(
    run_training=train_loop.run_training,
    InjectedFailure=train_loop.InjectedFailure, RunConfig=RunConfig,
    ShapeConfig=ShapeConfig, get_smoke=get_smoke)


def numpy_params(arch: str, seed: int) -> dict:
    """``arch``'s SMOKE parameters as numpy arrays drawn from ``seed``:
    the port's init tree (its constant leaves — norms, biases, the
    RG-LRU's Lambda — as they are), every other leaf normal with
    dense_init's scale.  The same on every machine, so the JAX package
    (scripts/torch_port_pins.py) trains from the same weights."""
    cfg = get_smoke(arch)
    like = lm.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(tree[k], k) for k in sorted(tree)}
        a = tree.numpy()
        if name == "lam" or a.min() == a.max():
            return a.copy()
        scale = (1 / math.sqrt(cfg.d_model) if name == "tok" else
                 _INIT_SCALES.get(name, 1 / math.sqrt(
                     a.shape[-2] if a.ndim >= 2 else a.shape[-1])))
        return (rng.standard_normal(a.shape) * scale).astype(np.float32)

    return walk(like)


def step0_checkpoint(directory, params: dict) -> None:
    """A step-0 training state of ``params`` (zero moments, step 0, the
    data stream at its start), in the checkpoint files both packages
    read."""
    def zeros(t):
        return ({k: zeros(v) for k, v in t.items()} if isinstance(t, dict)
                else np.zeros_like(t))

    state = {"params": params, "opt": {"m": zeros(params),
                                       "v": zeros(params),
                                       "step": np.int32(0)}}
    CheckpointManager(str(directory)).save(0, state, extra={
        "data_state": {"step": 0, "seed": TRAIN_DATA_SEED, "host_id": 0,
                       "n_hosts": 1}})


def train_pin_runs(pkg, arch: str, directory, **kw) -> dict:
    """``pkg``'s run_training from the same step-0 checkpoint twice:
    ``straight`` (TRAIN_STEPS steps) and ``crashed`` (InjectedFailure at
    TRAIN_FAIL_AT, then the auto-resume to TRAIN_STEPS)."""
    cfg = pkg.get_smoke(arch)
    shape = pkg.ShapeConfig("train_pins", *TRAIN_SHAPE, "train")
    params = numpy_params(arch, TRAIN_PARAM_SEED)
    runs = {}
    for name in ("straight", "crashed"):
        d = Path(directory) / arch / name
        step0_checkpoint(d, params)
        run = pkg.RunConfig(**TRAIN_RUN, ckpt_dir=str(d))
        if name == "crashed":
            try:
                pkg.run_training(cfg, run, shape, steps=TRAIN_STEPS,
                                 seed=TRAIN_DATA_SEED,
                                 fail_at_step=TRAIN_FAIL_AT, **kw)
                raise AssertionError("no injected failure")
            except pkg.InjectedFailure:
                pass
        runs[name] = pkg.run_training(cfg, run, shape, steps=TRAIN_STEPS,
                                      seed=TRAIN_DATA_SEED, **kw)
    return runs


def kernel_launches() -> dict:
    return {name: fn.launches for name, fn in MODEL_KERNELS.items()}


def reset_kernel_launches() -> None:
    for fn in MODEL_KERNELS.values():
        fn.launches = 0


def train_pins_phase(dev, card) -> dict:
    """run_training on the card for each TRAIN_ARCHS: its losses against
    the JAX package's pins, the resumed run equal to the straight run bit
    for bit (losses and every leaf of the final state), no model kernel
    launched."""
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp:
        for arch in TRAIN_ARCHS:
            reset_kernel_launches()
            t1 = time.perf_counter()
            runs = train_pin_runs(PORT_TRAIN, arch, tmp, device=dev)
            launches = kernel_launches()
            straight, crashed = runs["straight"], runs["crashed"]
            pins = TRAIN_PINS[arch]
            rel = [abs(a - b) / abs(b) for a, b in zip(straight.losses, pins)]
            if len(straight.losses) != TRAIN_STEPS or max(rel) > TRAIN_TOL:
                raise AssertionError(f"{arch} losses {straight.losses}: "
                                     f"relative {max(rel)} from the JAX "
                                     f"pins {pins}")
            if crashed.resumed_from != TRAIN_FAIL_AT:
                raise AssertionError(f"{arch} resumed from "
                                     f"{crashed.resumed_from}")
            bad = [i for i, (x, y) in enumerate(zip(
                lm.tree_leaves(straight.state), lm.tree_leaves(
                    crashed.state))) if not torch.equal(x, y)]
            if crashed.losses != straight.losses[TRAIN_FAIL_AT:] or bad:
                raise AssertionError(
                    f"{arch}: resumed {crashed.losses} != straight "
                    f"{straight.losses[TRAIN_FAIL_AT:]}, leaves {bad}")
            if any(launches.values()):
                raise AssertionError(f"{arch}: model kernels launched in "
                                     f"training: {launches}")
            out[arch] = {"losses": straight.losses, "jax_pins": pins,
                         "max_rel_vs_jax": max(rel),
                         "resumed_from": crashed.resumed_from,
                         "resumed_equals_straight": True,
                         "kernel_launches": launches,
                         "seconds": time.perf_counter() - t1}
    return {"phase": "train_pins", "card": card, "shape": TRAIN_SHAPE,
            "steps": TRAIN_STEPS, "fail_at": TRAIN_FAIL_AT,
            "tolerance": TRAIN_TOL, **out,
            "seconds": time.perf_counter() - t0}


def token_ce(cfg, logits, tokens) -> float:
    """Mean next-token cross entropy of (B, S, V) logits, the padded
    vocabulary masked as the loss masks it."""
    lg = logits[:, :-1].float()
    lg = torch.where(torch.arange(lg.shape[-1], device=lg.device)
                     < cfg.vocab, lg, layers.NEG_INF)
    lse = torch.logsumexp(lg, -1)
    picked = lg.gather(-1, tokens[:, 1:, None].long())[..., 0]
    return float((lse - picked).mean())


def refuse_grad_check(dev) -> list:
    """Each model kernel's wrapper, given inputs that require grad, raises
    and launches nothing."""
    g = torch.Generator(dev).manual_seed(0)

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=dtype).requires_grad_(True)

    q, k, v = r(1, 64, 2, 64), r(1, 64, 2, 64), r(1, 64, 2, 64)
    a = torch.rand((1, 16, 32), generator=g, device=dev).requires_grad_(True)
    b, h0 = r(1, 16, 32, dtype=torch.float32), r(1, 32, dtype=torch.float32)
    mq, mk, mv = r(1, 8, 1, 64), r(1, 8, 1, 64), r(1, 8, 1, 64)
    lf, li = r(1, 8, 1, dtype=torch.float32), r(1, 8, 1, dtype=torch.float32)
    C0 = torch.zeros((1, 1, 64, 64), device=dev)
    n0 = torch.zeros((1, 1, 64), device=dev)
    calls = {"flash_attention": lambda: fops.flash_attention(q, k, v),
             "decode_attention": lambda: dops.decode_attention(
                 q[:, :1], k, v, 64),
             "rglru_scan": lambda: rops.rglru_scan(a, b, h0),
             "mlstm_chunk": lambda: xops.mlstm_chunk(mq, mk, mv, lf, li, C0,
                                                     n0)}
    before = kernel_launches()
    raised = []
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "no backward kernel" not in str(e):
                raise
            raised.append(name)
            continue
        raise AssertionError(f"{name} launched on inputs that require grad")
    if kernel_launches() != before:
        raise AssertionError("a kernel launched under grad")
    return raised


def train_full_phase(dev, card) -> dict:
    """FULL_TRAIN_ARCH at full width and depth: FULL_TRAIN_STEPS steps of
    make_train_step (AdamW, f32 parameters and moments on the card),
    every leaf's gradient finite and not all zero, step 0's CE against
    the kernel route's logits on the same batch, no model kernel launched
    while training; step ms, tokens/s and peak memory."""
    t0 = time.perf_counter()
    cfg = get_config(FULL_TRAIN_ARCH)
    run = RunConfig(**FULL_TRAIN_RUN)
    seq, gb = FULL_TRAIN_SHAPE
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, run, torch.Generator(dev).manual_seed(0))
    n_params = sum(t.numel() for t in lm.tree_leaves(state["params"]))
    stream = TokenStream(cfg, ShapeConfig("train_full", seq, gb, "train"),
                         seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in stream.batch_at(i).items()}
               for i in range(FULL_TRAIN_STEPS)]
    # the kernel route's logits (flash attention) for step 0's batch
    reset_kernel_launches()
    with torch.no_grad():
        logits, _, _ = lm.forward(cfg, run, state["params"], batches[0])
        ce_kernel = token_ce(cfg, logits, batches[0]["tokens"])
    kernel_route = kernel_launches()
    if kernel_route["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"kernel route launches {kernel_route}")
    del logits
    # every leaf's gradient, on step 0's batch
    reset_kernel_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads, m0 = grads_and_metrics(cfg, run, state["params"], batches[0])
    torch.cuda.synchronize()
    grad_pass_ms = (time.perf_counter() - t1) * 1e3
    bad = [i for i, t in enumerate(lm.tree_leaves(grads))
           if not (bool(torch.isfinite(t).all()) and bool((t != 0).any()))]
    n_leaves = len(lm.tree_leaves(grads))
    del grads
    if bad:
        raise AssertionError(f"leaves {bad} of {n_leaves}: a gradient not "
                             "finite or all zero")
    step_fn = make_train_step(cfg, run)
    losses, ces, step_ms = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        ces.append(float(m["ce"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    rel = abs(ces[0] - ce_kernel) / abs(ce_kernel)
    if any(launches.values()):
        raise AssertionError(f"model kernels launched in training: "
                             f"{launches}")
    if not all(map(math.isfinite, losses)) or rel > TRAIN_TOL:
        raise AssertionError(f"losses {losses}; step 0's CE {ces[0]} vs the "
                             f"kernel route's {ce_kernel} (relative {rel})")
    if losses[0] != float(m0["loss"]):
        raise AssertionError(f"step 0's loss {losses[0]} != the gradient "
                             f"pass's {float(m0['loss'])}")
    raised = refuse_grad_check(dev)
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    del state, step_fn, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "train_full", "card": card, "arch": FULL_TRAIN_ARCH,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab, "params": n_params, "seq_len": seq,
            "global_batch": gb, "remat_policy": run.remat_policy,
            "loss_chunk": run.loss_chunk, "losses": losses, "ce": ces,
            "ce_kernel_route": ce_kernel, "ce_rel_vs_kernel_route": rel,
            "grad_leaves_finite_nonzero": n_leaves,
            "kernel_launches": launches,
            "kernel_route_launches": kernel_route,
            "refuse_grad": raised, "grad_pass_ms": grad_pass_ms,
            "step_ms": step_ms,
            "steady_step_ms": steady,
            "tokens_per_s": gb * seq / (steady / 1e3),
            "peak_gib": peak, "seconds": time.perf_counter() - t0}


# -- collective hooks (the JAX package's hooks/ and make_ddp_train_step) ------
# The train_full model, run and batch through the explicit-all-reduce DDP
# step on a one-rank NCCL world.  HOOK_CENSUS: the JAX package's census_fn of
# its make_ddp_train_step for the same config and batch, traced on a (1, 1)
# test mesh (scripts/torch_port_pins.py --only hooks)
HOOK_STEPS = 2
HOOK_CENSUS = {"total_sites": 17, "by_primitive": {"psum": 17},
               "payload_bytes_static": 6_883_348_496,
               "payload_bytes_per_step": 6_883_348_496}
HOOK_WIRE_TOL = 2e-2              # relative, the compressed run against the
                                  # unhooked: loss, grad_norm, each leaf's
                                  # gradient (L2); the bf16 bound
HOOK_MIN_BYTES = 1 << 16          # CastCompressHandler's default
HOOK_TURNS = 5                    # timed steps each, unhooked and traced


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def states_equal(a, b) -> list:
    """The leaves (by index) where two train states differ."""
    return [i for i, (x, y) in enumerate(zip(lm.tree_leaves(a),
                                             lm.tree_leaves(b)))
            if not torch.equal(x, y)]


def collective_hooks_phase(dev, card) -> dict:
    """make_ddp_train_step at FULL_TRAIN_ARCH's full width on a one-rank
    world (NCCL on the card, raising if it does not come up), against
    make_train_step and under each shipped handler; see the module
    docstring (phase 26)."""
    t0 = time.perf_counter()
    arch = FULL_TRAIN_ARCH
    world = mesh_lib.init_world(dev)
    if torch.device(dev).type == "cuda" and world.backend != "nccl":
        raise AssertionError(f"the card's world runs {world.backend}")
    mesh = mesh_lib.make_test_mesh(1, 1)
    cfg = get_config(arch)
    run = RunConfig(**FULL_TRAIN_RUN)
    seq, gb = FULL_TRAIN_SHAPE
    stream = TokenStream(cfg, ShapeConfig("collective_hooks", seq, gb,
                                          "train"), seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in stream.batch_at(i).items()}
               for i in range(HOOK_STEPS)]
    ddp = make_ddp_train_step(cfg, run, mesh)
    plain = make_train_step(cfg, run)
    line = {"phase": "collective_hooks", "card": card, "arch": arch,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "seq_len": seq, "global_batch": gb, "steps": HOOK_STEPS,
            "backend": world.backend, "world_size": world.size}

    def fresh():
        return init_train_state(cfg, run, torch.Generator(dev).manual_seed(0))

    def arm(step_fn, handlers=None, after_first=None):
        """HOOK_STEPS steps from a fresh state: (state, losses, step ms,
        operators the hook saw a step, grad_norm a step);
        ``after_first(state, grad_norm)`` sees the state after step 1."""
        state, losses, ms, seen, norms = fresh(), [], [], [], []
        for b in batches:
            _sync(dev)
            t1 = time.perf_counter()
            if handlers is None:
                state, m = step_fn(state, b)
            else:
                with hooking(handlers) as mode:
                    state, m = step_fn(state, b)
                seen.append(mode.dispatched)
            losses.append(float(m["loss"]))
            _sync(dev)
            ms.append((time.perf_counter() - t1) * 1e3)
            norms.append(float(m["grad_norm"]))
            if after_first is not None and len(norms) == 1:
                after_first(state, norms[0])
        return state, losses, ms, seen, norms

    def wire(state, grad_norm):
        """After one step from zero moments m = (1 - b1) c g, with c =
        min(1, clip / grad_norm): the gradient each leaf's all-reduce
        carried, on the host."""
        c = min(1.0, run.grad_clip / grad_norm) if grad_norm else 1.0
        return [(x / ((1 - run.b1) * c)).cpu()
                for x in lm.tree_leaves(state["opt"]["m"])]

    # (c) the census of the full-width step, on clones of a fresh state
    state = fresh()
    census = census_fn(ddp, state, batches[0])
    del state
    got = {k: census[k] for k in HOOK_CENSUS}
    if got != HOOK_CENSUS:
        raise AssertionError(f"census {got} != the JAX package's "
                             f"{HOOK_CENSUS}")
    sites = census["total_sites"]
    non_scalar = sum(1 for s in census["sites"] if s.in_shapes[0])
    line["census"] = {**got, "non_scalar_sites": non_scalar}
    gc.collect()
    torch.cuda.empty_cache()

    # make_train_step twice (the step reproduces itself), then (a) the DDP
    # step unhooked, (b) under TraceHandler, (e) under RSAGHandler(1): each
    # equal to it bit for bit
    ref_wire = []
    ref, ref_losses, ms_plain, _, ref_norms = arm(
        plain, after_first=lambda st, gn: ref_wire.extend(wire(st, gn)))
    again = arm(plain)[0]
    bad = states_equal(ref, again)
    del again
    if bad:
        raise AssertionError(f"make_train_step twice: leaves {bad} differ")
    ms = {"train_step": ms_plain}
    out = {}
    th, rh = TraceHandler(), RSAGHandler(axis_size=world.size)
    for name, handlers in (("ddp", None), ("trace", {"psum": th}),
                           ("rsag", {"psum": rh})):
        state, losses, ms[name], seen, _ = arm(ddp, handlers)
        bad = states_equal(ref, state)
        del state
        if bad or losses != ref_losses:
            raise AssertionError(f"{name}: leaves {bad} differ from "
                                 f"make_train_step; losses {losses} vs "
                                 f"{ref_losses}")
        out[name] = {"equal_to_train_step": True}
        if seen:
            out[name]["dispatched_per_step"] = seen
    del ref
    gc.collect()
    if th.count != HOOK_STEPS * sites or (
            th.total_bytes != HOOK_STEPS * census["payload_bytes_per_step"]):
        raise AssertionError(f"trace: {th.count} calls, {th.total_bytes} "
                             f"bytes; the census: {sites} sites, "
                             f"{census['payload_bytes_per_step']} bytes a "
                             "step")
    if rh.rewritten != HOOK_STEPS * non_scalar:
        raise AssertionError(f"rsag rewrote {rh.rewritten}, not "
                             f"{HOOK_STEPS} x {non_scalar}")
    out["trace"].update(count=th.count, total_bytes=th.total_bytes)
    out["rsag"]["rewritten"] = rh.rewritten

    # (d) CastCompressHandler: every f32 gradient leaf of 64 KiB or more
    #     and the values its wire carried: after step 1, each leaf's
    #     gradient (from m) within relative L2 HOOK_WIRE_TOL of the unhooked
    #     step's, and grad_norm at each step within it too
    ch = CastCompressHandler(min_bytes=HOOK_MIN_BYTES)
    wire_err = []

    def held(st, gn):
        for got, want in zip(wire(st, gn), ref_wire):
            n = float(torch.linalg.vector_norm(want))
            d = float(torch.linalg.vector_norm(got - want))
            wire_err.append(d / n if n else d)

    state, losses, ms["compress"], _, norms = arm(ddp, {"psum": ch},
                                                  after_first=held)
    big = sum(1 for p in lm.tree_leaves(state["params"])
              if p.dtype == torch.float32 and p.numel() * 4 >= HOOK_MIN_BYTES)
    rel = abs(losses[-1] - ref_losses[-1]) / abs(ref_losses[-1])
    norm_rel = [abs(a - b) / b for a, b in zip(norms, ref_norms)]
    if ch.compressed_sites != HOOK_STEPS * big or len(wire_err) != len(
            ref_wire) or not all(e <= HOOK_WIRE_TOL
                                 for e in [rel, *wire_err, *norm_rel]):
        raise AssertionError(f"compress: {ch.compressed_sites} sites (want "
                             f"{HOOK_STEPS} x {big}); loss {losses} vs "
                             f"{ref_losses} (relative {rel}); gradients "
                             "relative L2 up to "
                             f"{max(wire_err, default=None)}; grad_norm "
                             f"{norms} vs {ref_norms}")
    out["compress"] = {"compressed_sites": ch.compressed_sites,
                       "big_f32_leaves": big, "losses": losses,
                       "rel_vs_unhooked": rel,
                       "grad_rel_l2_max": max(wire_err),
                       "grad_rel_l2_leaves": len(wire_err),
                       "grad_norm_rel": norm_rel}
    ref_wire.clear()

    # (f) the completeness report over one profiled, hooked step
    th_f = TraceHandler()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with hooking({"psum": th_f}):
            state, _ = ddp(state, batches[0])
        _sync(dev)
    # the hook's cost: steps from this state in turns, unhooked and traced
    turns = {"ddp": [], "trace": []}
    for name in ("ddp", "trace", "trace", "ddp") * (HOOK_TURNS // 2) + (
            ("ddp", "trace") if HOOK_TURNS % 2 else ()):
        _sync(dev)
        t1 = time.perf_counter()
        if name == "ddp":
            state, _ = ddp(state, batches[0])
        else:
            with hooking({"psum": TraceHandler()}):
                state, _ = ddp(state, batches[0])
        _sync(dev)
        turns[name].append((time.perf_counter() - t1) * 1e3)
    del state
    names = collections.Counter(
        e.name for e in prof.events()
        if ":" in e.name and e.name.split(":")[0] in ("nccl", "gloo"))
    backend = backend_collective_census(prof)
    rep = completeness_report(census, backend)
    if not rep.fully_hooked or backend.get("all-reduce") != sites \
            or th_f.count != sites:
        raise AssertionError(f"completeness: {rep} ({dict(names)}); the "
                             f"hook saw {th_f.count}")
    out["completeness"] = {"fully_hooked": rep.fully_hooked,
                           "backend_counts": backend,
                           "census_counts": rep.census_counts,
                           "backend_events": dict(names)}
    gc.collect()
    torch.cuda.empty_cache()
    mesh_lib.destroy_world()

    median = {k: sorted(v)[len(v) // 2] for k, v in turns.items()}
    extra_ms = median["trace"] - median["ddp"]
    ops = out["trace"]["dispatched_per_step"][-1]
    return {**line, "losses": ref_losses, **out, "step_ms": ms,
            "turns_ms": turns, "turns_median_ms": median,
            "hook_us_per_intercepted_call": extra_ms * 1e3 / sites,
            "hook_us_per_dispatched_op": extra_ms * 1e3 / ops,
            "seconds": time.perf_counter() - t0}



# -- the examples (repro_torch.examples: the JAX package's examples/) ---------
# serve_demo on the card for each arch, and the kernels its path launches
# there (the others must launch 0 times); hooked_training's census of the
# DDP step: the JAX package's census_fn of its own (SMOKE qwen3-1.7b, batch
# 4 x 64; JAX_PLATFORMS=cpu, examples/hooked_training.py's step)
EXAMPLE_SERVE = {"qwen3-1.7b": ("flash", "decode"),
                 "recurrentgemma-2b": ("flash", "rglru"),
                 "xlstm-350m": ("mlstm",)}
EXAMPLE_NEW = 12
EXAMPLE_STEPS = 3
HOOKED_CENSUS = {"total_sites": 17, "by_primitive": {"psum": 17},
                 "payload_bytes_per_step": 362_000}
# hooked_training on the card against the same run on the CPU, each bound
# about ten times the gap measured on an H100 80GB HBM3 (700 W): the
# losses (1.24e-4 relative at step 2), the norm of the parameters' change
# over the run (1.6e-5 relative) and the distance between the two runs'
# final parameters over that change (1.84e-2; a run whose steps change
# nothing is at 1)
HOOKED_LOSS_TOL = 2e-3
HOOKED_UPDATE_TOL = 2e-4
HOOKED_PARAMS_TOL = 0.2
# core.fleet_step_traced on the card against the CPU: three lanes of
# mixed programs (tests/test_torch_surface.py's), one halting on the way
FLEET_STEP_STEPS = 100


def example_lanes():
    return [prepare(programs.getpid_loop(5), Mechanism.NONE),
            prepare(programs.read_loop(4, 256), Mechanism.SIGNAL,
                    virtualize=True),
            prepare(programs.mixed_ops(3, 128), Mechanism.PTRACE)]


def on_host(tree):
    """A named tuple of tensors, each copied to the host."""
    return type(tree)(*(x.cpu() for x in tree))


def fleet_step_check(dev) -> dict:
    """``core.fleet_step_traced`` (the eager step, not the kernel) stepped
    FLEET_STEP_STEPS times on the card and on the CPU from the same packed
    carry: every MachineState and TraceState leaf equal at every step, and
    the untraced ``fleet_step`` equal to the traced state (all-ALLOW)."""
    pps = example_lanes()
    carries = {d: pack_fleet(pps, trace=True, device=d)
               for d in (dev, "cpu")}
    imgs, ids, s, tr = carries[dev]
    _, _, s_c, tr_c = carries["cpu"]
    imgs_c, ids_c = carries["cpu"][:2]
    plain = clone(s)
    t0 = time.perf_counter()
    for i in range(FLEET_STEP_STEPS):
        s, tr = fleet_step_traced(imgs, ids, s, tr)
        plain = fleet_step(imgs, ids, plain)
        s_c, tr_c = fleet_step_traced(imgs_c, ids_c, s_c, tr_c)
        bad = (mismatched(on_host(s), s_c) + mismatched(on_host(tr), tr_c)
               + mismatched(plain, s))
        if bad:
            raise AssertionError(f"fleet_step_traced on the card != on the "
                                 f"CPU at step {i}: {bad}")
    torch.cuda.synchronize()
    records = tr.count.cpu().tolist()
    if min(records) < 4 or int(s.halted[0]) == 0:
        raise AssertionError(f"fleet_step lanes: records {records}, "
                             f"halted {s.halted.tolist()}")
    return {"steps": FLEET_STEP_STEPS, "lanes": len(pps),
            "records": records, "icount": s.icount.cpu().tolist(),
            "mismatched_leaves": 0, "s": time.perf_counter() - t0}


def serve_example(arch, dev) -> dict:
    """``serve_demo`` on the card: its tokens; the kernels on its path each
    launched (counted from 0 around ``generate``), the others not; the run
    teacher-forced through the kernels (each attention, scan and mLSTM call
    held to its plain version on the same inputs) and through their plain
    versions, held as ``serve`` holds them."""
    engine, reqs = ex_serve.demo_engine(arch, EXAMPLE_NEW, dev)
    cfg, run, params = engine.cfg, engine.run, engine.params
    counted = {"flash": fops.flash_attention, "decode": dops.decode_attention,
               "rglru": rops.rglru_scan, "mlstm": xops.mlstm_chunk}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    outs = engine.generate(reqs)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    on_path = EXAMPLE_SERVE[arch]
    if any((n > 0) != (k in on_path) for k, n in launches.items()):
        raise AssertionError(f"serve_demo {arch}: launches {launches}, "
                             f"expected on {on_path} only")
    lines = ex_serve.demo_lines(reqs, outs)
    tokens = np.stack([o.tokens for o in outs])
    if tokens.shape != (len(reqs), EXAMPLE_NEW) or not (
            (tokens >= 0) & (tokens < cfg.vocab)).all():
        raise AssertionError(f"serve_demo {arch}: tokens {tokens.shape}")
    toks, plen = engine._pad_batch(reqs)
    fed = torch.from_numpy(tokens.astype(np.int64)).to(dev)
    acheck, scheck, mcheck = AttentionCheck(), ScanCheck(), MlstmCheck()
    lk, _, _ = teacher_forced(cfg, run, params, toks, plen, fed,
                              attention=acheck, scan=scheck, mlstm=mcheck)
    lp, _, _ = teacher_forced(cfg, run, params, toks, plen, fed,
                              attention=plain_attention, scan=rglru_scan_seq,
                              mlstm=plain_mlstm)
    agree, n_over, worst, rel = compare_routes(lk, lp, tokens, cfg.vocab)
    if acheck.over or scheck.over or scheck.unequal or mcheck.over:
        raise AssertionError(f"serve_demo {arch}: a kernel call off its "
                             f"plain version (attention {acheck.over}, scan "
                             f"{scheck.over}/{scheck.unequal}, mlstm "
                             f"{mcheck.over})")
    return {"lines": lines, "launches": launches, "generate_s": gen_s,
            "tokens_agreeing": agree, "logits_over_bound": n_over,
            "max_logit_diff": worst, "rel_l2": rel,
            "checked_calls": {"attention": acheck.calls,
                              "rglru": scheck.calls, "mlstm": mcheck.calls},
            "max_abs_err": {"attention": acheck.max_err,
                            "rglru": scheck.max_err, "mlstm": mcheck.max_err}}


def examples_phase(dev, card) -> tuple:
    """The port's three examples through their functions, on the card:
    the quickstart's text against the JAX example's (``QUICKSTART_TEXT``)
    with the megastep kernel's launches counted; serve_demo for each arch
    of ``EXAMPLE_SERVE``; hooked_training's census against
    ``HOOKED_CENSUS``, no model kernel launched, and its run against the
    same run on the CPU (gloo): learning rates equal, losses, the norm of
    the parameters' change and the final parameters within the
    ``HOOKED_*_TOL`` bounds; then ``fleet_step_traced`` on the card
    against the CPU.  Returns (line, launches by kernel)."""
    t0 = time.perf_counter()
    mops.megastep_chunk.launches = 0
    text = ex_quickstart.quickstart(dev)
    torch.cuda.synchronize()
    qs_launches = mops.megastep_chunk.launches
    if text != QUICKSTART_TEXT:
        diff = [(a, b) for a, b in zip(text.splitlines(),
                                       QUICKSTART_TEXT.splitlines()) if a != b]
        raise AssertionError(f"quickstart text != the JAX example's: {diff}")
    if not qs_launches:
        raise AssertionError("the quickstart launched no megastep kernel")
    qs_s = time.perf_counter() - t0

    serve, launches = {}, collections.Counter({"megastep": qs_launches})
    for arch in EXAMPLE_SERVE:
        serve[arch] = serve_example(arch, dev)
        launches.update(serve[arch]["launches"])
        gc.collect()

    counted = {"flash": fops.flash_attention, "decode": dops.decode_attention,
               "rglru": rops.rglru_scan, "mlstm": xops.mlstm_chunk}
    for fn in counted.values():
        fn.launches = 0
    t1 = time.perf_counter()
    card_run = ex_hooked.hooked_training(EXAMPLE_STEPS, device=dev)
    torch.cuda.synchronize()
    hooked_s = time.perf_counter() - t1
    model_launches = {k: fn.launches for k, fn in counted.items()}
    cpu_run = ex_hooked.hooked_training(EXAMPLE_STEPS, device="cpu")
    cen = {k: card_run.census[k] for k in HOOKED_CENSUS}
    if cen != HOOKED_CENSUS:
        raise AssertionError(f"hooked_training census {cen} != "
                             f"{HOOKED_CENSUS}")
    if any(model_launches.values()):
        raise AssertionError(f"training launched model kernels "
                             f"{model_launches}")
    rel = [abs(a - b) / abs(b) for a, b in zip(card_run.losses,
                                               cpu_run.losses)]
    if not all(map(math.isfinite, card_run.losses)) or max(rel) > \
            HOOKED_LOSS_TOL:
        raise AssertionError(f"hooked_training losses {card_run.losses} vs "
                             f"the CPU's {cpu_run.losses}")
    if card_run.lrs != cpu_run.lrs:
        raise AssertionError(f"hooked_training learning rates "
                             f"{card_run.lrs} vs the CPU's {cpu_run.lrs}")
    moved = cpu_run.update_norm
    update_rel = abs(card_run.update_norm - moved) / moved
    apart = sum(float((a.cpu().double() - b.double()).pow(2).sum())
                for a, b in zip(lm.tree_leaves(card_run.params),
                                lm.tree_leaves(cpu_run.params))) ** 0.5
    if not moved > 0 or update_rel > HOOKED_UPDATE_TOL \
            or apart / moved > HOOKED_PARAMS_TOL:
        raise AssertionError(
            f"hooked_training's parameters: moved {card_run.update_norm} "
            f"on the card, {moved} on the CPU; the two runs {apart} apart")

    fs = fleet_step_check(dev)
    line = {"phase": "examples", "card": card,
            "quickstart": {"lines": len(text.splitlines()),
                           "equal_to_jax_text": True,
                           "megastep_launches": qs_launches, "s": qs_s},
            "serve_demo": serve,
            "hooked_training": {**cen, "lines": card_run.lines,
                                "losses": card_run.losses,
                                "cpu_losses": cpu_run.losses,
                                "max_rel_vs_cpu": max(rel),
                                "lrs": card_run.lrs,
                                "update_norm": card_run.update_norm,
                                "cpu_update_norm": moved,
                                "update_norm_rel_vs_cpu": update_rel,
                                "params_apart_over_update": apart / moved,
                                "model_kernel_launches": model_launches,
                                "s": hooked_s},
            "fleet_step_traced": fs,
            "seconds": time.perf_counter() - t0}
    return line, dict(launches)

# -- the multi-pod dry run (the JAX package's launch/dryrun.py) ---------------
# (a) full-width cells traced on fake 256- and 512-rank worlds, one process a
# cell (a fake world must not share a process with a real one); (b) the
# train_full cell's operator count and roofline against a real step.
# DRYRUN_DOT_FLOPS: the JAX package's one-device HLO dot count of that step
# (scripts/torch_port_pins.py --only dryrun)
# (arch, shape, both meshes): the first two on 16x16 and 2x16x16, then on
# 16x16 a cell a repaired layout: the MoE's routing, attention over whole
# heads, the ring's prefill writes, the xLSTM (its loops counted)
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k", True),
                ("recurrentgemma-2b", "long_500k", True),
                ("dbrx-132b", "decode_32k", False),
                ("gemma-7b", "train_4k", False),
                ("recurrentgemma-2b", "prefill_32k", False),
                ("xlstm-350m", "train_4k", False))
DRYRUN_DOT_FLOPS = 27_384_753_422_336
DRYRUN_STEPS = 3
DRYRUN_TIMEOUT_S = 400


def dryrun_cells(directory) -> list:
    """Start one ``python -m repro_torch.launch.dryrun`` a cell of
    DRYRUN_CELLS on its meshes, fake tensors on the card's device type;
    returns (arch, shape, out, log, process) each."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, both in DRYRUN_CELLS:
        out = Path(directory) / f"{arch}_{shape}.json"
        log = open(Path(directory) / f"{arch}_{shape}.log", "w")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--device", "cuda",
               "--out", str(out), "--label", "chip_smoke"]
        cmd += ["--both-meshes"] if both else []
        procs.append((arch, shape, out, log, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)))
    return procs


def dryrun_cell_lines(procs, card) -> list:
    """Wait for the cells of :func:`dryrun_cells` and check each: status
    OK, a dominant term, dot FLOPs and bytes above zero, loops counted
    (``while_trips``) where a cell has them (the xLSTM's)."""
    lines = []
    for arch, shape, out, log, proc in procs:
        try:
            rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        tail = Path(log.name).read_text()[-3000:]
        if rc != 0 or not out.exists():
            raise AssertionError(f"dry run {arch} {shape}: exit {rc}\n{tail}")
        for c in json.loads(out.read_text()):
            r = c.get("roofline", {})
            if c["status"] != "OK" or r.get("dominant") not in (
                    "compute", "memory", "collective") \
                    or not c["hlo_dot_flops_per_device"] > 0 \
                    or not c["bytes_per_device"] > 0 \
                    or (c["arch"] == "xlstm-350m") != bool(c["while_trips"]):
                raise AssertionError(f"dry run cell {c['arch']} "
                                     f"{c['shape']} {c['mesh']}: "
                                     f"{c.get('error')}\n{tail}")
            lines.append({
                "phase": "dryrun", "part": "cell", "card": card,
                **{k: c[k] for k in (
                    "arch", "shape", "mesh", "status", "trace_s",
                    "bytes_per_device", "fits_hbm", "argument_bytes",
                    "hlo_dot_flops_per_device", "hlo_mem_bytes_per_device",
                    "collective_wire_bytes_per_device", "collectives",
                    "wire_bytes_by_group_size", "model_flops_per_device",
                    "useful_flops_ratio", "roofline_fraction",
                    "while_trips")},
                "roofline": r})
    return lines


def dryrun_measure(dev) -> dict:
    """The train_full cell on the card (plain tensors, no process group):
    one step under ``opanalysis.analyze`` (its counts), then DRYRUN_STEPS
    steps timed alone, with ``max_memory_allocated``; the state freed
    before and after."""
    cfg = get_config(FULL_TRAIN_ARCH)
    run = RunConfig(**FULL_TRAIN_RUN)
    seq, gb = FULL_TRAIN_SHAPE
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    state = init_train_state(cfg, run, torch.Generator(dev).manual_seed(0))
    stream = TokenStream(cfg, ShapeConfig("dryrun", seq, gb, "train"),
                         seed=0)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch_at(0).items()}
    step = make_train_step(cfg, run)
    real = opanalysis.analyze(step, state, batch)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(DRYRUN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated() - base
    loss = float(m["loss"])
    del state, batch, step, m
    gc.collect()
    torch.cuda.empty_cache()
    return {"real": real, "step_ms": step_ms, "peak": peak, "loss": loss}


def dryrun_prediction(dev, card, measured) -> dict:
    """The train_full cell's operator count on fake tensors against
    :func:`dryrun_measure`'s step: the dot FLOPs pinned to the JAX
    package's, no collective, the predicted peak bytes beside
    ``max_memory_allocated`` and the step's time beside the roofline
    bound."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(FULL_TRAIN_ARCH)
    run = RunConfig(**FULL_TRAIN_RUN)
    seq, gb = FULL_TRAIN_SHAPE
    t0 = time.perf_counter()
    with FakeTensorMode():
        state = init_train_state(cfg, run, torch.Generator(dev))
        batch = {"tokens": torch.empty((gb, seq), dtype=torch.int32,
                                       device=dev)}
        fake = opanalysis.analyze(make_train_step(cfg, run), state, batch)
    fake_s = time.perf_counter() - t0
    real, step_ms, peak, loss = (measured[k] for k in (
        "real", "step_ms", "peak", "loss"))
    if not (fake.dot_flops == real.dot_flops == DRYRUN_DOT_FLOPS):
        raise AssertionError(f"dot FLOPs: fake {fake.dot_flops}, real "
                             f"{real.dot_flops}, JAX {DRYRUN_DOT_FLOPS}")
    if fake.collectives or real.collectives or not math.isfinite(loss):
        raise AssertionError(f"collectives {fake.collectives} "
                             f"{real.collectives}; loss {loss}")
    terms = opanalysis.roofline_terms(fake)
    median = sorted(step_ms)[len(step_ms) // 2]
    model_fl = dryrun.model_flops_per_step(
        cfg, ShapeConfig("dryrun", seq, gb, "train"))
    return {"phase": "dryrun", "part": "prediction", "card": card,
            "arch": FULL_TRAIN_ARCH, "seq_len": seq, "global_batch": gb,
            "remat_policy": run.remat_policy, "loss_chunk": run.loss_chunk,
            "dot_flops": fake.dot_flops, "dot_flops_real": real.dot_flops,
            "dot_flops_jax": DRYRUN_DOT_FLOPS,
            "mem_bytes": fake.mem_bytes, "mem_bytes_real": real.mem_bytes,
            "predicted_peak_bytes": fake.peak_bytes,
            "predicted_peak_bytes_real": real.peak_bytes,
            "argument_bytes": fake.argument_bytes,
            "max_memory_allocated": peak,
            "peak_ratio": fake.peak_bytes / peak,
            "roofline": terms.to_dict(), "bound_ms": terms.bound_s * 1e3,
            "step_ms": step_ms, "step_ms_median": median,
            "roofline_fraction_on_card": terms.bound_s * 1e3 / median,
            "roofline_fraction_predicted":
                (model_fl / opanalysis.HW.peak_flops) / terms.bound_s,
            "model_flops_utilization":
                model_fl / opanalysis.HW.peak_flops / (median / 1e3),
            "loss": loss, "fake_trace_s": fake_s}


def dryrun_phase(dev, card) -> list:
    """(b)'s real step first, timed with nothing else running on the
    host; then (a)'s full-width cells in processes of their own while
    (b)'s fake trace runs here; one line each (see the module docstring,
    phase 27)."""
    t0 = time.perf_counter()
    measured = dryrun_measure(dev)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-dryrun-") as d:
        procs = dryrun_cells(d)
        try:
            pred = dryrun_prediction(dev, card, measured)
        except BaseException:
            for *_, log, proc in procs:
                proc.kill()
                proc.wait()
                log.close()
            raise
        cells = dryrun_cell_lines(procs, card)
    return cells + [{**pred, "seconds": time.perf_counter() - t0}]


def check_chunks(name, imgs, ids, start, tr, checks):
    """One chunk at 1, 8 and 128 steps and 3 and 4 lanes a block (500
    lanes leave a ragged last block at 3): the kernel equals the plain
    version on every leaf.  Returns the largest error."""
    err = 0
    for chunk in (1, 8, 128):
        want = megastep_chunk_ref(imgs, ids, clone(start),
                                  None if tr is None else clone(tr),
                                  chunk=chunk)
        for block in CHECK_BLOCKS:
            got = mops.megastep_chunk(imgs, ids, clone(start),
                                      None if tr is None else clone(tr),
                                      chunk=chunk, block=block)
            torch.cuda.synchronize()
            pairs = [(want, got)] if tr is None else list(zip(want, got))
            for w, g in pairs:
                bad = mismatched(w, g)
                if bad:
                    raise AssertionError(
                        f"kernel != plain on {name}, chunk={chunk}, "
                        f"block={block}: leaves {bad}")
                err = max(err, max_abs_err(w, g))
            checks.append(name)
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="an earlier design's megastep.cu, timed in turns "
                         "with this one on the census (optional)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_script = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False

    # 1. build: the five kernel libraries from src/, one nvcc each, all
    #    started together
    t0 = time.perf_counter()
    mods = {"megastep": mkernel, "flash_attention": fkernel,
            "decode_attention": dkernel, "rglru_scan": rkernel,
            "mlstm_chunk": xkernel}
    with ThreadPoolExecutor(len(mods)) as ex:
        futs = {name: ex.submit(mod.build) for name, mod in mods.items()}
        built = {name: f.result() for name, f in futs.items()}
    build_s = time.perf_counter() - t0
    for mod in mods.values():
        mod.load_library()
    lib, report = built["megastep"]
    parent = None
    if args.parent:  # an earlier design, built from its source
        parent = (mkernel.load_library(Path(args.parent).resolve()),
                  PARENT_BLOCK)
    emit({"phase": "build", "card": card, "seconds": build_s,
          "library": lib.name, "ptxas": nvcc.ptxas_lines(report),
          "rglru_scan_library": built["rglru_scan"][0].name,
          "rglru_scan_ptxas": nvcc.ptxas_lines(built["rglru_scan"][1]),
          "kind": kind, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    attn_ptxas = {}
    for name in ("flash_attention", "decode_attention"):
        table = nvcc.ptxas_table(built[name][1])
        attn_ptxas[name] = {
            "library": built[name][0].name, "instances": len(table),
            "max_registers": max((v.get("registers", 0)
                                  for v in table.values()), default=None),
            "spill_bytes": sum(v.get("spill_stores", 0)
                               + v.get("spill_loads", 0)
                               for v in table.values())}
    # the main paths' instances: ptxas's registers and spills, the
    # runtime's shared memory and threads, HGMMA instructions in the SASS
    hgmma = nvcc.sass_counts(built["flash_attention"][0], "HGMMA")
    table = nvcc.ptxas_table(built["flash_attention"][1])
    for key, inst, hd in (("main_path_instance",
                           MAIN_INSTANCE["flash_attention"], 128),
                          ("recurrentgemma_instance", RG_INSTANCE, 256)):
        # ptxas's report is empty when the library was built before
        ptxas = [v for k_, v in table.items() if inst in k_]
        sass = [(k_, n) for k_, n in hgmma.items() if inst in k_]
        if len(sass) != 1:
            raise AssertionError(f"flash instance {inst}: {len(sass)} in "
                                 "the library's SASS")
        row = {"kernel": sass[0][0], "hgmma": sass[0][1],
               "ptxas": ptxas[0] if ptxas else None, **fkernel.tc_info(hd)}
        if not row["hgmma"] or row["local_bytes"] or (ptxas and (
                ptxas[0]["spill_stores"] or ptxas[0]["spill_loads"])):
            raise AssertionError(f"flash instance {inst}: {row}: not "
                                 "tensor-core code without spills")
        attn_ptxas["flash_attention"][key] = row
    table = nvcc.ptxas_table(built["decode_attention"][1])
    rows = [(k_, v) for k_, v in table.items()
            if MAIN_INSTANCE["decode_attention"] in k_]
    attn_ptxas["decode_attention"]["main_path_instance"] = (
        {"kernel": rows[0][0], **rows[0][1]} if rows else None)
    emit({"phase": "attn_build", "card": card, "seconds": build_s,
          **attn_ptxas})
    emit(mlstm_build_line(built["mlstm_chunk"], card, build_s))
    emit(megastep_build_line(built["megastep"], card, build_s))

    # 2. kernel vs plain, one chunk, on the card
    t0 = time.perf_counter()
    pps_off, regs = census_processes(HookConfig(emul_enabled=False))
    pps_def, _ = census_processes()
    imgs, ids, s_off = pack_fleet(pps_off, fuel=FUEL, regs=regs, device=dev)
    imgs_d, ids_d, s_def = pack_fleet(pps_def, fuel=FUEL, regs=regs,
                                      device=dev)
    if not (all(map(torch.equal, imgs, imgs_d)) and torch.equal(ids, ids_d)):
        raise AssertionError("the emulation flag changed the decode images")
    prep_s = time.perf_counter() - t0
    code = code_of(pps_off)
    B = int(s_off.pc.shape[0])

    def host(s):
        return {f: getattr(s, f).cpu().numpy() for f in MachineState._fields}

    def on_card(leaves):
        return MachineState(*(torch.from_numpy(leaves[f]).to(dev)
                              for f in MachineState._fields))

    starts = [("emul_off_initial", s_off, None)]
    for seed in (0, 1, 2):
        starts.append((f"emul_off_random_seed{seed}", on_card(scramble(
            host(s_off), code, np.random.default_rng(seed))), None))
    starts.append(("default_initial", s_def, None))
    for seed in (3, 4):
        rng = np.random.default_rng(seed)
        starts.append((f"default_random_kern_seed{seed}", on_card(
            scramble_kern(scramble(host(s_def), code, rng), code, rng)),
            None))
    rng = np.random.default_rng(5)
    tr0 = fleet_trace(pps_def, device=dev)
    pa, pg = tpolicy.policy_rows(random_policies(B, rng, kill_lane=7))
    tr_pol = tr0._replace(pol_action=torch.from_numpy(pa).to(dev),
                          pol_arg=torch.from_numpy(pg).to(dev))  # fresh rings
    starts.append(("traced_policies_seed5", s_def, tr_pol))
    rng = np.random.default_rng(6)
    s_rand = on_card(scramble_kern(scramble(host(s_def), code, rng), code,
                                   rng))
    starts.append(("traced_random_seed6", s_rand, interop.trace_from_numpy(
        scramble_trace(B, int(tr0.buf.shape[2]), rng,
                       random_policies(B, rng, kill_lane=11)), dev)))
    checks, err_by = [], {}
    for name, start, tr in starts:
        variant = "K2" if tr is not None else (
            "K1" if name.startswith("emul_off") else "K3")
        e = check_chunks(name, imgs, ids, start, tr, checks)
        err_by[variant] = max(err_by.get(variant, 0), e)
    emit({"phase": "kernel_vs_plain", "card": card, "lanes": B,
          "images": int(imgs.packed.shape[0]),
          "starts": [n for n, *_ in starts],
          "chunks": [1, 8, 128], "lanes_per_block": list(CHECK_BLOCKS),
          "checks": len(checks),
          "mismatched_leaves": 0, "prepare_s": prep_s,
          "seconds": time.perf_counter() - t0})

    # 3. the main path: the default census to halt, through the kernel
    run_fleet_prepared(pps_def[:8], fuel=FUEL, chunk=CHUNK, regs=regs[:8],
                       device=dev)  # warm-up: allocator, streams
    torch.cuda.synchronize()
    mops.megastep_chunk.launches = 0
    t0 = time.perf_counter()
    out = run_fleet_prepared(pps_def, fuel=FUEL, chunk=CHUNK, regs=regs,
                             device=dev)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches_k3 = mops.megastep_chunk.launches
    got = counts(out)
    halted = out.halted.cpu().numpy()
    chunks = math.ceil(got["longest_lane_steps"] / CHUNK)
    if launches_k3 <= 0 or launches_k3 != chunks:
        raise AssertionError(f"launches {launches_k3}, chunks {chunks}")
    if got != CENSUS_DEFAULT_EXPECTED or not (halted == HALT_EXIT).all():
        raise AssertionError(f"default census counts {got}, halted "
                             f"{np.bincount(halted).tolist()}; expected "
                             f"{CENSUS_DEFAULT_EXPECTED}, all HALT_EXIT")
    if digest(out) != CENSUS_DEFAULT_SHA256:
        raise AssertionError("default census leaves differ from the JAX "
                             "package's (sha256)")

    # where the main path's time goes: packing (host), then the driver
    # loop (kernel launches + one host sync per chunk)
    t0 = time.perf_counter()
    _, _, sd = pack_fleet(pps_def, fuel=FUEL, regs=regs, device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mops.run(imgs_d, ids_d, sd, chunk=CHUNK)
    torch.cuda.synchronize()
    driver_ms = (time.perf_counter() - t0) * 1e3
    if mismatched(sd, out):
        raise AssertionError("driver run != main path")

    # the plain version to halt on the card, from the same packed state
    _, _, sp0 = pack_fleet(pps_def, fuel=FUEL, regs=regs, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain, _, plain_chunks = plain_run_to_halt(imgs_d, ids_d, sp0, CHUNK)
    torch.cuda.synchronize()
    plain_ms_k3 = (time.perf_counter() - t0) * 1e3
    bad = mismatched(plain, out)
    if bad:
        raise AssertionError(f"main path != plain version: leaves {bad}")
    err_by["K3"] = max(err_by["K3"], max_abs_err(plain, out))

    kernel_ms_k3, runs_k3, (sk, _) = kernel_census_ms(pps_def, regs, chunks,
                                                     dev=dev)
    if mismatched(sk, out):
        raise AssertionError("timed kernel run != main path")
    turns_k3 = None
    if parent:
        turns_k3, outs = census_in_turns(pps_def, regs, chunks, parent,
                                         dev=dev)
        if mismatched(outs["parent"][0], out):
            raise AssertionError("the earlier design's census != main path")
    grid = census_grid()
    churn_payload = sum(2 * CHURN_NBYTES * g[4] for g in grid
                        if g[3] == "churn")
    cw = code_words_of(pps_def)
    (bound_k3, by_k3), nbytes, nops = census_bound_ms(
        out, cw, emul_payload=churn_payload)
    emit({"phase": "main_path", "card": card, **got,
          "sha256": CENSUS_DEFAULT_SHA256,
          "halted": {"HALT_EXIT": int((halted == HALT_EXIT).sum())},
          "chunk": CHUNK, "launches": launches_k3,
          "path_s": path_s, "pack_s": pack_s, "driver_ms": driver_ms,
          "kernel_ms": kernel_ms_k3, "kernel_ms_runs": runs_k3,
          "device_idle_share": 1 - kernel_ms_k3 / driver_ms,
          "host_gap_ms_per_chunk": (driver_ms - kernel_ms_k3) / launches_k3,
          "lane_steps_per_s": got["total_steps"] / (kernel_ms_k3 / 1e3),
          "lanes_per_block": mkernel.DEFAULT_BLOCK,
          "in_turns_with_parent_ms": turns_k3,
          "plain_ms": plain_ms_k3, "plain_chunks": plain_chunks,
          "bound_ms": bound_k3, "bound_by": by_k3, "bound_bytes": nbytes,
          "bound_ops": nops, "emul_payload_bytes": churn_payload,
          "mismatched_leaves": 0})

    # 4. the emulation-off census (slice 1's path, K1)
    mops.megastep_chunk.launches = 0
    out_off = run_fleet_prepared(pps_off, fuel=FUEL, chunk=CHUNK, regs=regs,
                                 device=dev)
    torch.cuda.synchronize()
    launches_k1 = mops.megastep_chunk.launches
    got_off = counts(out_off)
    got_off.pop("emul_served_total")
    if (got_off != CENSUS_EXPECTED
            or not (out_off.halted.cpu().numpy() == HALT_EXIT).all()):
        raise AssertionError(f"emul-off census counts {got_off}; expected "
                             f"{CENSUS_EXPECTED}, all HALT_EXIT")
    chunks_off = math.ceil(got_off["longest_lane_steps"] / CHUNK)
    if launches_k1 != chunks_off:
        raise AssertionError(f"launches {launches_k1}, chunks {chunks_off}")
    _, _, sp0 = pack_fleet(pps_off, fuel=FUEL, regs=regs, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_off, _, _ = plain_run_to_halt(imgs, ids, sp0, CHUNK)
    torch.cuda.synchronize()
    plain_ms_k1 = (time.perf_counter() - t0) * 1e3
    bad = mismatched(plain_off, out_off)
    if bad:
        raise AssertionError(f"emul-off census != plain version: {bad}")
    err_by["K1"] = max(err_by["K1"], max_abs_err(plain_off, out_off))
    kernel_ms_k1, runs_k1, _ = kernel_census_ms(pps_off, regs, chunks_off,
                                                dev=dev)
    turns_k1 = None
    if parent:
        turns_k1, outs = census_in_turns(pps_off, regs, chunks_off, parent,
                                         dev=dev)
        if mismatched(outs["parent"][0], out_off):
            raise AssertionError("the earlier design's K1 census differs")
    (bound_k1, by_k1), _, _ = census_bound_ms(out_off, cw)
    emit({"phase": "census_emul_off", "card": card, **got_off,
          "launches": launches_k1,
          "kernel_ms": kernel_ms_k1, "kernel_ms_runs": runs_k1,
          "lane_steps_per_s": got_off["total_steps"] / (kernel_ms_k1 / 1e3),
          "in_turns_with_parent_ms": turns_k1,
          "plain_ms": plain_ms_k1, "bound_ms": bound_k1, "bound_by": by_k1,
          "mismatched_leaves": 0})

    # 5. the churn census: emulation on vs the stubs, kernel only
    churn = {}
    for arm in ("emul", "stub"):
        pps_c, regs_c = churn_processes(arm == "emul")
        out_c = run_fleet_prepared(pps_c, fuel=FUEL, chunk=CHUNK,
                                   regs=regs_c, device=dev)
        got_c = counts(out_c)
        if ({k: got_c[k] for k in CHURN_EXPECTED[arm]} != CHURN_EXPECTED[arm]
                or not (out_c.halted.cpu().numpy() == HALT_EXIT).all()):
            raise AssertionError(f"churn {arm} counts {got_c}; expected "
                                 f"{CHURN_EXPECTED[arm]}, all HALT_EXIT")
        n_chunks = math.ceil(got_c["longest_lane_steps"] / CHUNK)
        ms, runs, (sk, _) = kernel_census_ms(pps_c, regs_c, n_chunks, dev=dev)
        if mismatched(sk, out_c):
            raise AssertionError(f"timed churn {arm} run != entry point")
        churn[arm] = {**got_c, "chunks": n_chunks, "kernel_ms": ms,
                      "kernel_ms_runs": runs}
    emit({"phase": "churn", "card": card, **churn,
          "emul_over_stub": churn["emul"]["kernel_ms"]
          / churn["stub"]["kernel_ms"]})

    # 6. the default census traced, all-ALLOW (K2)
    mops.megastep_chunk.launches = 0
    out_t, tr_t = run_fleet_prepared(pps_def, fuel=FUEL, chunk=CHUNK,
                                     regs=regs, trace=True, device=dev)
    torch.cuda.synchronize()
    launches_k2 = mops.megastep_chunk.launches
    if launches_k2 != chunks:
        raise AssertionError(f"traced launches {launches_k2}, chunks {chunks}")
    bad = mismatched(out_t, out)
    if bad:
        raise AssertionError(f"traced states != untraced: leaves {bad}")
    count = tr_t.count.cpu().numpy()
    verdicts = {"deny": int(tr_t.deny_count.sum()),
                "emul": int(tr_t.emul_count.sum()),
                "kill": int(tr_t.kill_count.sum())}
    if any(verdicts.values()):
        raise AssertionError(f"verdicts under all-ALLOW: {verdicts}")
    if not np.array_equal(count, tr_t.hist.sum((1, 2)).cpu().numpy()):
        raise AssertionError("trace count != histogram total")
    if ({"records_total": int(count.sum()), **verdicts} != TRACED_EXPECTED
            or digest(tr_t) != TRACED_SHA256):
        raise AssertionError("traced census differs from the JAX package's "
                             "(record count / sha256)")
    _, _, sp0 = pack_fleet(pps_def, fuel=FUEL, regs=regs, device=dev)
    tp0 = fleet_trace(pps_def, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_t, plain_tr, _ = plain_run_to_halt(imgs_d, ids_d, sp0, CHUNK, tp0)
    torch.cuda.synchronize()
    plain_ms_k2 = (time.perf_counter() - t0) * 1e3
    bad = mismatched(plain_t, out_t) + mismatched(plain_tr, tr_t)
    if bad:
        raise AssertionError(f"traced census != plain version: {bad}")
    if recorder.harvest(plain_tr) != recorder.harvest(tr_t):
        raise AssertionError("decoded rings differ from the plain version")
    err_by["K2"] = max(err_by["K2"], max_abs_err(plain_tr, tr_t),
                       max_abs_err(plain_t, out_t))
    # traced and untraced kernel times, interleaved on one card
    t_un1, _, _ = kernel_census_ms(pps_def, regs, chunks, dev=dev, reps=1)
    kernel_ms_k2, runs_k2, (sk, tk) = kernel_census_ms(
        pps_def, regs, chunks, dev=dev, traced=True)
    t_un2, _, _ = kernel_census_ms(pps_def, regs, chunks, dev=dev, reps=1)
    if mismatched(sk, out_t) or mismatched(tk, tr_t):
        raise AssertionError("timed traced run != entry point")
    turns_k2 = None
    if parent:
        turns_k2, outs = census_in_turns(pps_def, regs, chunks, parent,
                                         dev=dev, traced=True)
        if (mismatched(outs["parent"][0], out_t)
                or mismatched(outs["parent"][1], tr_t)):
            raise AssertionError("the earlier design's traced census differs")
    records = int(count.sum())
    (bound_k2, by_k2), _, _ = census_bound_ms(
        out_t, cw, emul_payload=churn_payload, records=records,
        traced_lanes=B)
    emit({"phase": "traced", "card": card, "launches": launches_k2,
          "records": records,
          "records_max_lane": int(count.max()), **verdicts,
          "trace_sha256": digest(tr_t),
          "kernel_ms": kernel_ms_k2, "kernel_ms_runs": runs_k2,
          "lane_steps_per_s": int(out_t.icount.sum()) / (kernel_ms_k2 / 1e3),
          "in_turns_with_parent_ms": turns_k2,
          "untraced_kernel_ms": [t_un1, t_un2],
          "traced_over_untraced": kernel_ms_k2 / min(t_un1, t_un2),
          "plain_ms": plain_ms_k2, "bound_ms": bound_k2, "bound_by": by_k2,
          "mismatched_leaves": 0})

    # 7. the deterministic invariant: Table 3 per-call cycles
    cyc = table3(per_call_cycles(device=dev))
    if cyc != TABLE3_CYCLES:
        raise AssertionError(f"Table-3 cycles {cyc} != {TABLE3_CYCLES}")
    emit({"phase": "table3", "card": card, "cycles_per_call": cyc,
          "script_s": time.perf_counter() - t_script})

    # 8-9. the attention kernels vs their plain versions, on the card
    line, err_by["flash"] = flash_phase(dev, card)
    emit(line)
    line, err_by["decode"] = decode_phase(dev, card)
    emit(line)

    # 10. the LM serving path: full-width qwen3-1.7b, random weights
    serve, attn_rows = serve_phase(dev, card)
    emit(serve)
    torch.cuda.empty_cache()  # qwen3-1.7b's weights went with the phase

    # 11. the RG-LRU scan kernel vs its plain versions, on the card
    line, err_by["rglru"] = rglru_phase(dev, card)
    emit(line)

    # 12. the hybrid serving path: full-width recurrentgemma-2b
    serve_rg, rg_rows = serve_rg_phase(dev, card)
    emit(serve_rg)
    torch.cuda.empty_cache()  # recurrentgemma-2b's weights went with it

    # 13. the mLSTM kernel vs its plain versions, on the card
    line, err_by["mlstm"] = mlstm_phase(dev, card)
    emit(line)

    # 14. the xLSTM serving path: full-width xlstm-350m
    serve_xl, xl_rows = serve_xlstm_phase(dev, card)
    emit(serve_xl)
    gc.collect()
    torch.cuda.empty_cache()  # xlstm-350m's weights went with the phase

    # 15-17. the other model families, each freed before the next: the
    #        MoE, the encoder-decoder, the patch-prefix decoder
    family, family_lines = {}, {}
    for name, arch, kw in (("serve_moe", MOE_ARCH, {}),
                           ("serve_encdec", ENCDEC_ARCH, {}),
                           ("serve_vlm", VLM_ARCH, {"n_layers": VLM_LAYERS})):
        family_lines[name], family[name] = serve_family_phase(
            name, arch, dev, card, **kw)
        emit(family_lines[name])

    # 18-20. the census drivers: streamed harvest, admission and restore
    #        into a pool, live-lane compaction
    t0 = time.perf_counter()
    line = streamed_phase(pps_def, regs, tr_t, dev, card)
    launches_stream = line["launches"]
    emit({**line, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    line, launches_adm = admission_phase(pps_def, regs, (out, tr_t), dev,
                                         card)
    emit({**line, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    line, launches_cmp = compact_phase(pps_def, regs, dev, card)
    emit({**line, "seconds": time.perf_counter() - t0})

    # 21. the fleet server over the census and the noisy-neighbor mix
    t0 = time.perf_counter()
    line, breakdown, launches_fs = fleet_server_phase(pps_def, regs, out,
                                                      dev, card)
    emit({**line, "seconds": time.perf_counter() - t0,
          "script_s": time.perf_counter() - t_script})
    emit(breakdown)

    # 22. durable serving and chaos: the journal, snapshots, kill and
    #     recover, the chaos soak
    t0 = time.perf_counter()
    lines, launches_dur = durable_server_phase(pps_def, regs, out, dev, card)
    for line in lines:
        emit(line)
    emit({"phase": "durable_server_done", "card": card,
          "seconds": time.perf_counter() - t0,
          "script_s": time.perf_counter() - t_script})

    # 23. lane sharding (K3): run_fleet_prepared, the fleet server and
    #     the durable server with shard=True
    t0 = time.perf_counter()
    line, launches_shard = shard_phase(pps_def, regs, out, dev, card)
    emit({**line, "seconds": time.perf_counter() - t0,
          "script_s": time.perf_counter() - t_script})

    # 24-25. training: the fault-tolerant loop at SMOKE against the JAX
    #        package's pinned losses, then qwen3-1.7b at full width
    emit({**train_pins_phase(dev, card),
          "script_s": time.perf_counter() - t_script})
    emit({**train_full_phase(dev, card),
          "script_s": time.perf_counter() - t_script})

    # 26. collective hooks: the DDP step at full width on a one-rank NCCL
    #     world, unhooked and under each handler, its census and the
    #     completeness check
    emit({**collective_hooks_phase(dev, card),
          "script_s": time.perf_counter() - t_script})

    # 27. the examples: quickstart, serve_demo and hooked_training through
    #     the port's entry points on the card; fleet_step_traced
    line, launches_ex = examples_phase(dev, card)
    emit({**line, "script_s": time.perf_counter() - t_script})

    # 28. the multi-pod dry run: full-width cells on fake 256- and
    #     512-rank worlds, and the train_full cell's prediction against
    #     the card
    for line in dryrun_phase(dev, card):
        emit({**line, "script_s": time.perf_counter() - t_script})

    # 29. the kernel table, the card, and the device line (last)
    attn_src = {
        "flash": ("flash_attention",
                  "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
                  "src/repro/kernels/flash_attention/kernel.py:72"),
        "decode": ("decode_attention",
                   "src/repro_torch/kernels/decode_attention/csrc/"
                   "decode_attention.cu",
                   "src/repro/kernels/decode_attention/kernel.py:58")}
    family_table = []
    for phase, rows in family.items():
        fl = family_lines[phase]
        for r in rows.values():
            kname, src, rep = attn_src[r["kernel"]]
            family_table.append({
                "name": f"{kname} ({fl['arch']}, case {r['case']})",
                "route": "cuda", "source": src, "replaces": rep,
                "max_abs_err": max(err_by[r["kernel"]],
                                   fl["attention_max_abs_err"]),
                **{k_: r[k_] for k_ in ("launches", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms", "eager_ms", "case")}})
    common = {"route": "cuda",
              "source": "src/repro_torch/kernels/megastep/csrc/megastep.cu",
              "replaces": "src/repro/kernels/megastep/kernel.py:103",
              "library_ms": None}
    emit({"kernels": [
        {"name": "megastep_chunk K1 (untraced, emulation off)", **common,
         "launches": launches_k1, "max_abs_err": err_by["K1"],
         "ms": kernel_ms_k1, "plain_ms": plain_ms_k1, "bound_ms": bound_k1,
         "bound_by": by_k1},
        {"name": "megastep_chunk K3 (untraced, emulation on)", **common,
         "launches": launches_k3, "max_abs_err": err_by["K3"],
         "ms": kernel_ms_k3, "plain_ms": plain_ms_k3, "bound_ms": bound_k3,
         "bound_by": by_k3,
         "launches_by_path": {"main_path": launches_k3,
                              "admission": launches_adm["K3"],
                              "compact": launches_cmp["K3"],
                              "fleet_server": launches_fs["served"],
                              "durable_server": launches_dur["durable"]
                              + launches_dur["kill_recover"]
                              + launches_dur["chaos_soak"],
                              "shard": sum(launches_shard.values()),
                              "examples": launches_ex["megastep"]}},
        {"name": "megastep_chunk K2 (traced, policy gate)", **common,
         "launches": launches_k2, "max_abs_err": err_by["K2"],
         "ms": kernel_ms_k2, "plain_ms": plain_ms_k2, "bound_ms": bound_k2,
         "bound_by": by_k2,
         "launches_by_path": {"traced": launches_k2,
                              "streamed": launches_stream,
                              "admission": launches_adm["K2"],
                              "compact": launches_cmp["K2"],
                              "fleet_server": sum(
                                  n for arm, n in launches_fs.items()
                                  if arm != "served"),
                              "durable_server":
                                  launches_dur["traced_recover"]}},
        {"name": "flash_attention (qwen3-1.7b prefill)", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
         "max_abs_err": err_by["flash"], **attn_rows["flash"],
         "examples_launches": launches_ex.get("flash", 0)},
        {"name": "decode_attention (qwen3-1.7b decode)", "route": "cuda",
         "source": "src/repro_torch/kernels/decode_attention/csrc/"
                   "decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:58",
         "max_abs_err": err_by["decode"], **attn_rows["decode"],
         "examples_launches": launches_ex.get("decode", 0)},
        {"name": "flash_attention (recurrentgemma-2b prefill, window 2048)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
         "max_abs_err": max(err_by["flash"], serve_rg["attention_max_abs_err"]),
         **rg_rows["flash"]},
        {"name": "rglru_scan (recurrentgemma-2b, prefill and decode)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan/kernel.py:40",
         "max_abs_err": max(err_by["rglru"],
                            serve_rg["scan_max_abs_err_vs_associative"]),
         **rg_rows["rglru"],
         "examples_launches": launches_ex.get("rglru", 0)},
        {"name": "mlstm_chunk (xlstm-350m, prefill and decode)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/mlstm_chunk/csrc/mlstm_chunk.cu",
         "replaces": "src/repro/kernels/mlstm_chunk/kernel.py:69",
         "max_abs_err": max(err_by["mlstm"], serve_xl["mlstm_max_abs_err"]),
         **xl_rows["mlstm"],
         "examples_launches": launches_ex.get("mlstm", 0)}] + family_table})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
