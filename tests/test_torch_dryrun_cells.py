"""The dry run's cells that used to fail, traced on the CPU, and the
repairs that make them trace, each a no-op on plain tensors.

* SMOKE cells on the 16x16 fake world (one child process for them all:
  a fake world must not share a process with a real one): the MoE
  (dbrx-132b ``train_4k``, qwen2-moe-a2.7b ``decode_32k``: routing without
  ``searchsorted``), the xLSTM (``long_500k``: a batch of one laid out
  whole; ``train_4k``: the chunked mLSTM's products on each rank's shards,
  the sLSTM's loop counted from one step) and attention over whole
  heads (gemma-7b ``train_4k`` and seamless-m4t-medium ``decode_32k`` at
  16 heads, so that the heads divide the model axis as at full width:
  batch and heads, both sharded, are not flattened into one dimension).
* The MoE's routing plan equals its ``searchsorted`` form and the JAX
  package's ``_route_row`` statements exactly, over seeded random choices
  with ties and empty experts.
* The ring's prefill write (a rotation) equals the index write it
  replaces, bit for bit.
* ``sharding.einsum`` and ``sharding.local_map`` of plain tensors are
  ``torch.einsum`` and the function itself.
"""
import collections
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import lm, moe
from repro_torch.parallel import sharding

REPO = pathlib.Path(__file__).parent.parent

CELLS = [
    ("dbrx-132b", "train_4k"),
    ("qwen2-moe-a2.7b", "decode_32k"),
    ("xlstm-350m", "long_500k"),
    ("xlstm-350m", "train_4k"),
    ("gemma-7b", "train_4k"),              # at 16 heads: whole heads
    ("seamless-m4t-medium", "decode_32k"),  # at 16 heads: whole heads
]
WHOLE_HEADS = ("gemma-7b", "seamless-m4t-medium")

CHILD = r"""
import dataclasses, json, sys
from repro_torch import configs
from repro_torch.launch import dryrun
cells, whole = json.loads(sys.argv[1]), json.loads(sys.argv[2])
smoke = configs.get_smoke
dryrun.get_smoke = lambda a: (dataclasses.replace(
    smoke(a), n_heads=16, n_kv_heads=16, head_dim=8) if a in whole
    else smoke(a))
out = [dryrun.run_cell(a, s, multi_pod=False, smoke=True, device="cpu")
       for a, s in cells]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def traced():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", CHILD, json.dumps(CELLS),
         json.dumps(WHOLE_HEADS)],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    cells = json.loads(res.stdout.strip().splitlines()[-1])
    return {(c["arch"], c["shape"]): c for c in cells}


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(c))
def test_smoke_cell_traces_ok(traced, cell):
    c = traced[cell]
    assert c["status"] == "OK", (c.get("error"), c.get("traceback"))
    assert c["mesh"] == "16x16"
    assert c["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert c["hlo_dot_flops_per_device"] > 0 and c["bytes_per_device"] > 0
    arch, shape = cell
    # a train step's loops: the sLSTM's over the 512 SMOKE positions,
    # counted from one step (forward, the checkpoint's recompute,
    # backward), and each mLSTM's over its two chunks of 256 (forward,
    # recompute); decode runs one step a token (no loop)
    want = {"train_4k": {512: 3, 2: 6}, "long_500k": {}}
    if arch == "xlstm-350m":
        assert collections.Counter(c["while_trips"]) == want[shape]
    else:
        assert c["while_trips"] == []
    if shape == "train_4k":
        assert {"all-reduce", "reduce-scatter"} & set(c["collectives"])


def _old_plan(top_e, E, C):
    """The routing plan as it was computed with ``searchsorted``."""
    B, S, k = top_e.shape
    flat_e = top_e.reshape(B, S * k)
    order = torch.sort(flat_e, dim=-1, stable=True).indices
    se = flat_e.gather(1, order)
    first = torch.searchsorted(se, torch.arange(E).expand(B, E).contiguous())
    rank_sorted = torch.arange(S * k) - first.gather(1, se)
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    keep = rank < C
    slot = torch.where(keep, flat_e * C + rank, E * C)
    return first, slot.reshape(B, S, k), keep.reshape(B, S, k), order // k


def _jax_plan(top_e_row, E, C):
    """The JAX package's ``_route_row`` statements for one row:
    (first, slot of each sorted slot, stok)."""
    S, k = top_e_row.shape
    flat_e = jnp.asarray(top_e_row.reshape(-1))
    flat_tok = jnp.repeat(jnp.arange(S), k)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = jnp.searchsorted(se, jnp.arange(E), side="left")
    rank = jnp.arange(S * k) - first[se]
    slot = jnp.where(rank < C, se * C + rank, E * C)
    return (np.array(first), np.array(order), np.array(slot),
            np.array(flat_tok[order]))


@pytest.mark.parametrize("E,k,cf,live", [
    (6, 2, 1.25, 6),    # qwen2-moe-a2.7b SMOKE
    (4, 2, 1.0, 2),     # two experts never chosen
    (16, 4, 0.5, 5),    # most tokens dropped past capacity
    (60, 4, 1.25, 60),  # qwen2-moe-a2.7b's expert count
])
def test_routing_plan_equals_searchsorted_and_jax(E, k, cf, live):
    base = configs.get_smoke("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, n_experts=E, top_k=k, capacity_factor=cf))
    rng = np.random.default_rng(E * 100 + k)
    B, S = 3, 37
    C = moe.capacity(cfg.moe, S)
    # k distinct experts a token, drawn from the first ``live``; low
    # counts make many ties in the sort
    top_e = torch.from_numpy(np.stack([
        np.stack([rng.permutation(live)[:k] for _ in range(S)])
        for _ in range(B)]).astype(np.int64))
    logits = torch.randn(B, S, E, generator=torch.Generator().manual_seed(0))
    probs = torch.softmax(logits, -1)
    top_w = probs.gather(-1, top_e)
    r = moe.plan(cfg, logits, probs, top_e, top_w)
    first, slot, keep, stok = _old_plan(top_e, E, C)
    assert torch.equal(r.first, first) and r.first.dtype == torch.int64
    assert torch.equal(r.slot, slot) and torch.equal(r.keep, keep)
    assert torch.equal(r.stok, stok) and r.C == C
    if live < E:
        assert (r.first[:, live:] == S * k).all()  # empty experts
    for b in range(B):
        j_first, j_order, j_slot, j_stok = _jax_plan(top_e[b].numpy(), E, C)
        np.testing.assert_array_equal(r.first[b].numpy(), j_first)
        np.testing.assert_array_equal(r.slot[b].reshape(-1)[j_order].numpy(),
                                      j_slot)
        np.testing.assert_array_equal(r.stok[b].numpy(), j_stok)


@pytest.mark.parametrize("window", [1, 3, 16, 33])
def test_ring_prefill_equals_the_index_write(window):
    g = torch.Generator().manual_seed(window)
    for S in range(1, 70):
        w = min(window, S)
        k = torch.randn(2, S, 3, 4, generator=g).bfloat16()
        last_pos = torch.arange(S - w, S, dtype=torch.int32)
        slots = (last_pos % w).long()
        want = torch.zeros_like(k[:, -w:])
        want[:, slots] = k[:, -w:]
        want_sp = torch.full((w,), -1, dtype=torch.int32)
        want_sp[slots] = last_pos
        got = lm._ring(k[:, -w:], 1, S)
        got_sp = lm._ring(last_pos, 0, S)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        assert torch.equal(got_sp, want_sp) and got_sp.dtype == torch.int32
        assert got.is_contiguous() and got.untyped_storage().data_ptr() \
            != k.untyped_storage().data_ptr()


def test_layout_helpers_are_noops_on_plain_tensors():
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(2, 5, 3, 4, generator=g), torch.randn(2, 3, 4, 6,
                                                             generator=g)
    eq = "bkhd,bhde->bkhe"
    assert torch.equal(sharding.einsum(eq, a, b), torch.einsum(eq, a, b))

    def fn(x, y):
        return x + 1, y

    marker = object()
    out = sharding.local_map(fn, (a, marker), ((0,), ()), (0,))
    assert torch.equal(out[0], a + 1) and out[1] is marker
    mask = torch.ones(2, 5, 5, dtype=torch.bool)
    q = torch.randn(2, 5, 3, 1, 4, generator=g)
    want = torch.einsum("bqhgd,bkhd->bhgqk", q, a)
    got = lm.per_head(lambda q, k, v, m: torch.einsum("bqhgd,bkhd->bhgqk",
                                                       q, k), q, a, a, mask)
    assert torch.equal(got, want)
