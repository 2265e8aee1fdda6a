"""The training driver: ``train/step.make_ddp_train_step`` on a one-rank
NCCL world (``launch/mesh.init_world``), steps back to back (a step a
unit of the window), each on a fresh batch of token ids drawn on the
card from the seed.

A cell's ``params``: ``hook``, what intercepts the step's all-reduces
(``none``: no hook; ``trace``: ``hooks.hooking({"psum":
TraceHandler()})`` around every step; ``compress``: the same with
``CastCompressHandler()``, the gradients cast to bfloat16 on the wire);
``checked_steps``, the steps the reference replays; ``limits``, the
limit of each number compared.

Set-up builds the one train state from the benchmark's own parameters
and drives it through the configuration's checked steps with the
window's own call and feed; the window carries on from there.  What the
reference compares is read as those steps go: each step's loss, each
leaf's first gradient as AdamW got it (its first moment after one step,
``(1 - b1)`` times the clipped gradient) and each leaf's change after
the checked steps.  Once the window has closed, the program's state is
freed and the plain reference (``bench/ref/qwen3``) replays the checked
steps from the same parameters and tokens, drawn again from the seed.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Tuple

import torch
from torch.profiler import record_function

from .. import counts, traffic
from ..common import check, positive_int
from ..ref import qwen3 as ref

KINDS = ("train",)
HOOKS = ("none", "trace", "compress")
NUMBERS = ("train.loss_gap", "train.grad_gap", "train.change_gap")
PARAMS = {
    "hook": lambda v: v in HOOKS,
    "checked_steps": positive_int,
    "limits": lambda v: isinstance(v, dict) and set(v) == set(NUMBERS)
    and all(isinstance(x, (int, float)) and x > 0 for x in v.values()),
}
# the reference in the program's place, in a precision below the
# configuration's (``ref.qwen3``'s ``quant``)
CONTROLS = ref.QUANTS

# (flat name, path in the port's parameter tree)
_PATHS = {"tok": ("embed", "tok"), "final_norm": ("final_norm",)}
_PATHS.update({k: ("tiles", "b0", k) for k in ("ln1", "ln2")})
_PATHS.update({k: ("tiles", "b0", "attn", k)
               for k in ("wq", "wk", "wv", "wo", "q_norm", "k_norm")})
_PATHS.update({k: ("tiles", "b0", "mlp", k) for k in ("w1", "w2", "w3")})
ORDER = ("tok", "final_norm") + ref.STACKED


def shapes(c: Dict, t: Dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Each leaf's shape and the scale of its normal draw (0: ones)."""
    L, d, ff = c["num_hidden_layers"], c["hidden_size"], c["intermediate_size"]
    H, Hkv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                  c["head_dim"])
    mult = t["vocab_pad_multiple"]
    vpad = -(-c["vocab_size"] // mult) * mult

    def r(n):
        return 1.0 / math.sqrt(n)

    return {"tok": ((vpad, d), r(d)), "final_norm": ((d,), 0.0),
            "ln1": ((L, d), 0.0), "ln2": ((L, d), 0.0),
            "wq": ((L, d, H * hd), r(d)), "wk": ((L, d, Hkv * hd), r(d)),
            "wv": ((L, d, Hkv * hd), r(d)), "wo": ((L, H * hd, d), r(H * hd)),
            "q_norm": ((L, hd), 0.0), "k_norm": ((L, hd), 0.0),
            "w1": ((L, d, ff), r(d)), "w3": ((L, d, ff), r(d)),
            "w2": ((L, ff, d), r(ff))}


def make_leaf(c: Dict, t: Dict, seed: int, name: str, dev) -> torch.Tensor:
    """One parameter leaf, drawn on ``dev`` from its own generator (one
    call a leaf; the same seed gives the same values)."""
    shape, scale = shapes(c, t)[name]
    if scale == 0.0:
        return torch.ones(shape, dtype=torch.float32, device=dev)
    g = torch.Generator(dev)
    g.manual_seed(traffic.param_seed(seed, ORDER.index(name)))
    return torch.randn(shape, generator=g, dtype=torch.float32,
                       device=dev).mul_(scale)


def make_params(c: Dict, t: Dict, seed: int, dev) -> Dict[str, torch.Tensor]:
    return {n: make_leaf(c, t, seed, n, dev) for n in ORDER}


def port_tree(flat: Dict[str, torch.Tensor]) -> Dict:
    """The port's parameter tree over the same tensors."""
    tree: Dict = {}
    for n, path in _PATHS.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[n]
    return tree


def _at(tree: Dict, path) -> torch.Tensor:
    for k in path:
        tree = tree[k]
    return tree


def leaf_norms(get, names=ORDER) -> Dict[str, float]:
    """The L2 norm of every leaf of the published model: a stacked leaf
    is one leaf a layer (``layers.<i>.<name>``).  ``get(name)`` gives the
    flat tensor."""
    out: Dict[str, float] = {}
    for n in names:
        x = get(n)
        if n in ref.STACKED:
            v = torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=1,
                                         dtype=torch.float64).tolist()
            out.update({f"layers.{i}.{n}": float(a) for i, a in enumerate(v)})
        else:
            out[n] = float(torch.linalg.vector_norm(x, dtype=torch.float64))
    return out


def gap(prog: Dict[str, float], ref_: Dict[str, float],
        skip=()) -> Tuple[float, str]:
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and the median leaf's: (gap, leaf)."""
    vals = sorted(ref_.values())
    med = vals[len(vals) // 2]
    worst, at = 0.0, ""
    for k, r in ref_.items():
        if k in skip:
            continue
        g = abs(prog[k] - r) / max(r, med, 1e-30)
        if g > worst:
            worst, at = g, k
    return worst, at


def tiny_grads(first_ref: Dict[str, float]) -> set:
    """Leaves whose reference gradient is under a thousandth of the median
    leaf's: rounding moves them under Adam, so their change is not
    compared."""
    vals = sorted(first_ref.values())
    med = vals[len(vals) // 2]
    return {k for k, v in first_ref.items() if v < 1e-3 * med}


def port_configs(c: Dict, t: Dict):
    from repro_torch.configs.base import ModelConfig, RunConfig
    if c["hidden_act"] != "silu" or c["model_type"] != "qwen3":
        raise ValueError("the train driver runs Qwen3 (SwiGLU, qk-norm)")
    mc = ModelConfig(
        name=c["name"], n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab=c["vocab_size"], head_dim=c["head_dim"], act="swiglu",
        qk_norm=True, qkv_bias=c["attention_bias"],
        tie_embeddings=c["tie_word_embeddings"],
        rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        vocab_pad_multiple=t["vocab_pad_multiple"])
    run = RunConfig(**{k: t[k] for k in (
        "learning_rate", "warmup_steps", "total_steps", "weight_decay", "b1",
        "b2", "eps", "grad_clip", "z_loss", "remat_policy", "loss_chunk")})
    return mc, run


class Cell:
    def __init__(self, wl: Dict, cfg: Dict, seed: int, device):
        if not cfg["tie_word_embeddings"]:
            raise ValueError("the train driver ties the head to the "
                             "embedding, as the configuration does")
        self.wl, self.cfg, self.seed = wl, cfg, seed
        self.t = cfg["train"]
        self.dev = torch.device(device)
        self.checked = wl["params"]["checked_steps"]
        self.counters: Dict[str, float] = {}

    def batch(self):
        t = self.t
        return {"tokens": torch.randint(
            0, self.cfg["vocab_size"], (t["batch"], t["seq_len"]),
            generator=self.gen, device=self.dev)}

    def unit(self) -> None:
        """One train step on a fresh batch, synchronised."""
        from repro_torch.hooks import hooking
        with record_function("bench.train.batch"):
            b = self.batch()
        with record_function("bench.train.step"):
            if self.handlers is None:
                self.state, self.metrics = self.step_fn(self.state, b)
            else:
                with hooking(self.handlers) as mode:
                    self.state, self.metrics = self.step_fn(self.state, b)
                self.dispatched += mode.dispatched
        with record_function("bench.train.sync"):
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
        self.steps += 1

    def setup(self) -> None:
        import torch.distributed as dist
        from repro_torch.hooks import CastCompressHandler, TraceHandler
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.optim.adamw import init_opt_state
        from repro_torch.train.step import make_ddp_train_step
        t0 = time.perf_counter()
        self.own_world = not dist.is_initialized()
        mesh_lib.init_world(self.dev)
        mesh = mesh_lib.make_test_mesh(1, 1)
        self.counters["world_s"] = time.perf_counter() - t0
        mc, run = port_configs(self.cfg, self.t)
        t0 = time.perf_counter()
        params = port_tree(make_params(self.cfg, self.t, self.seed, self.dev))
        self.state = {"params": params, "opt": init_opt_state(params)}
        self.step_fn = make_ddp_train_step(mc, run, mesh)
        self.handlers = {"none": None,
                         "trace": {"psum": TraceHandler()},
                         "compress": {"psum": CastCompressHandler()},
                         }[self.wl["params"]["hook"]]
        self.gen = torch.Generator(self.dev)
        self.gen.manual_seed(traffic.token_seed(self.seed))
        self.steps = self.dispatched = 0
        self.losses: List[float] = []
        self.counters["state_s"] = time.perf_counter() - t0
        for k in range(1, self.checked + 1):
            t0 = time.perf_counter()
            self.unit()
            self.losses.append(float(self.metrics["loss"]))
            if k == 1:
                m = self.state["opt"]["m"]
                self.first = leaf_norms(lambda n: _at(m, _PATHS[n]))
            self.counters[f"step{k}_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        p = self.state["params"]
        self.change = leaf_norms(lambda n: _at(p, _PATHS[n]) - make_leaf(
            self.cfg, self.t, self.seed, n, self.dev))
        self.counters["change_s"] = time.perf_counter() - t0
        self.steps = self.dispatched = 0

    def tokens_per_step(self) -> int:
        return self.t["batch"] * self.t["seq_len"]

    def end_to_end(self, times: List[float],
                   window_s: float) -> Dict[str, float]:
        return {"train_tokens_per_s":
                self.tokens_per_step() * len(times) / window_s}

    def flops_per_step(self) -> float:
        c = self.cfg
        return counts.train_flops(
            params_in_matmuls=counts.qwen3_matmul_params(c),
            layers=c["num_hidden_layers"], heads=c["num_attention_heads"],
            head_dim=c["head_dim"], seq_len=self.t["seq_len"],
            tokens=self.tokens_per_step())

    def release(self) -> None:
        import torch.distributed as dist
        from repro_torch.launch import mesh as mesh_lib
        self.final_loss = float(self.metrics["loss"])
        del self.state, self.metrics, self.step_fn
        gc.collect()
        if self.own_world and dist.is_initialized():
            mesh_lib.destroy_world()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, quant=None):
        """(losses, first gradient norms, change norms) of the checked
        steps by the plain reference."""
        p = make_params(self.cfg, self.t, self.seed, self.dev)
        gen = torch.Generator(self.dev)
        gen.manual_seed(traffic.token_seed(self.seed))
        t = self.t
        batches = [torch.randint(0, self.cfg["vocab_size"],
                                 (t["batch"], t["seq_len"]), generator=gen,
                                 device=self.dev)
                   for _ in range(self.checked)]
        got = {}

        def on_step(k, p_, m):
            if k == 1:
                got["first"] = leaf_norms(lambda n: m[n])

        losses = ref.train(self.cfg, t, p, batches, quant=quant,
                           on_step=on_step)
        change = leaf_norms(lambda n: p[n] - make_leaf(
            self.cfg, t, self.seed, n, self.dev))
        return losses, got["first"], change

    def control(self, name: str) -> Dict[str, float]:
        """The control's numbers: the reference computed in ``name``'s
        precision (``ref.qwen3``'s ``quant``) in the program's place,
        against the reference."""
        if name not in CONTROLS:
            raise ValueError(f"no training control {name!r}")
        ref32 = self.reference()
        self.losses, self.first, self.change = self.reference(quant=name)
        return self.numbers(ref32)

    def numbers(self, reference) -> Dict[str, float]:
        losses, first, change = reference
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(self.losses,
                                                           losses))
        grad_gap, self.grad_leaf = gap(self.first, first)
        skip = tiny_grads(first)
        change_gap, self.change_leaf = gap(self.change, change, skip=skip)
        self.skipped = len(skip)
        return {"train.loss_gap": loss_gap, "train.grad_gap": grad_gap,
                "train.change_gap": change_gap}

    def check(self) -> List[dict]:
        nums = self.numbers(self.reference())
        lim = self.wl["params"]["limits"]
        out = [check(k, v, lim[k]) for k, v in nums.items()]
        out.append(check("train.final_loss_not_finite",
                         0 if math.isfinite(self.final_loss) else 1, 0))
        self.failed = 0 if all(c["ok"] for c in out) else self.checked
        return out
