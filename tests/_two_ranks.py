"""One rank of tests/test_torch_hooks.py's spawned two-rank gloo world.

A module of its own that imports no JAX, so that each spawned rank
starts in the time it takes to import the port."""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.data.pipeline import TokenStream
from repro_torch.hooks import RSAGHandler, TraceHandler, hooking
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import lm
from repro_torch.train.step import init_train_state, make_ddp_train_step

DDP_ARCH = "qwen3-1.7b"
DDP_RUN = dict(attn_chunk=8, mlstm_chunk=4, remat_policy="none", z_loss=1e-4)
DDP_SHAPE = (16, 4)            # seq_len, global batch: two rows a rank


def ddp_inputs():
    cfg = configs.get_smoke(DDP_ARCH)
    run = configs.RunConfig(**DDP_RUN)
    state = init_train_state(cfg, run, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in TokenStream(
        cfg, configs.ShapeConfig("t", *DDP_SHAPE, "train")).batch_at(
            0).items()}
    return cfg, run, state, batch


def rank_main(rank, path, out):
    """RSAG on a (6, 5) all-reduce, then one DDP step on this rank's half
    of the batch; puts (rank, rewritten, traced, RSAG == all-reduce,
    RSAG changed its input, loss, parameters, grad_norm, first moments)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(path, 2), rank=rank,
                            world_size=2)
    try:
        x = torch.from_numpy(np.random.default_rng(rank).standard_normal(
            (6, 5)).astype(np.float32))
        plain = x.clone()
        dist.all_reduce(plain)
        rh, th = RSAGHandler(axis_size=2), TraceHandler()
        with hooking({"psum": rh, "reduce_scatter": th, "all_gather": th}):
            y = x.clone()
            dist.all_reduce(y)
        cfg, run, state, batch = ddp_inputs()
        step = make_ddp_train_step(cfg, run, make_test_mesh(2, 1))
        state, m = step(state, batch)
        # the handler's own collectives ran natively: the trace saw none
        out.put((rank, rh.rewritten, th.count, torch.equal(plain, y),
                 torch.equal(y, x), float(m["loss"]),
                 [t.numpy() for t in lm.tree_leaves(state["params"])],
                 float(m["grad_norm"]),
                 [t.numpy() for t in lm.tree_leaves(state["opt"]["m"])]))
    finally:
        dist.destroy_process_group()
