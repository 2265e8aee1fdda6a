"""The port's three examples (``repro_torch.examples``) against the JAX
package's (``examples/``), on the CPU.

* quickstart: the rewrite report and Figure 4's C3 sections equal the JAX
  example's text (its ``main``, run in-process) line for line; the
  Table-3 section, whose 400 simulated getpid calls the port's plain CPU
  step takes ~40 s to run, is held to the same text on the card by
  ``chip_smoke.py``'s ``examples`` phase, against the pin
  ``QUICKSTART_TEXT`` — which equals the JAX example's whole text here.
* serve_demo: with JAX's ``lm.init_params(cfg, PRNGKey(0))`` carried
  across (``models.interop.params_from_numpy``), every request's tokens
  equal the JAX ``ServeEngine``'s (compiled with excess precision off,
  ``tests/_lm_parity.Strict``, which the port equals bit for bit) for
  qwen3-1.7b and recurrentgemma-2b SMOKE, at the example's config,
  requests and batch.
* hooked_training, ``--steps 3`` in a child process (it brings up its
  own one-rank gloo world) from JAX's ``init_train_state(PRNGKey(0))``
  parameters: the census's sites (17), primitives and bytes a step equal
  JAX's ``census_fn`` of JAX's step; step 0's loss within 1e-5 relative of
  JAX's hooked step (strict; ``LOSS0_RTOL`` says why not 1e-6), steps 1-2
  within 2e-2 (the bf16 bound: after a step on the bf16 wire the
  parameters differ); the learning rates bit for bit.
* Every example raises without a card unless asked for the CPU.
"""
import contextlib
import importlib.util
import io
import json
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro import hooks as jhooks
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data.pipeline import TokenStream as JTokenStream
from repro.launch.mesh import make_test_mesh as jmake_test_mesh
from repro.models import lm as jlm
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train.step import init_train_state as jinit_train_state
from repro.train.step import make_ddp_train_step as jmake_ddp_train_step
from repro_torch.examples import hooked_training, quickstart, serve_demo
from repro_torch.models.interop import params_from_numpy

from _lm_parity import Strict

REPO = pathlib.Path(__file__).resolve().parents[1]
SRC = REPO / "src"
# step 0, the same parameters and batch: tests/test_torch_ddp.py holds
# 1e-6 at 16 positions, where the port's forward equals strict JAX bit for
# bit; at the example's 64 positions three XLA orders the port does not
# reproduce (its rsqrt's refined hardware estimate, one projection's dot
# order, a softmax sum over 55 keys) flip single bf16 roundings: 5.6e-6
LOSS0_RTOL = 1e-5
LOSS_RTOL = 2e-2    # after a step on the bf16 wire (PERF.md §2)
STEPS = 3


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sections(text: str) -> dict:
    """{heading: the section's text} of an example's output."""
    return {s.splitlines()[0]: s for s in text.strip("\n").split("\n\n")}


@pytest.fixture(scope="module")
def jax_quickstart() -> str:
    mod = _load("_jax_quickstart", REPO / "examples" / "quickstart.py")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue()


def test_quickstart_text_equals_jax(jax_quickstart):
    want = _sections(jax_quickstart)
    assert len(want) == 3
    got = _sections(quickstart.quickstart("cpu", ("rewrite", "c3")))
    assert list(got) == list(want)[1:]
    for head, text in got.items():
        assert text.splitlines() == want[head].splitlines(), head


def test_quickstart_card_pin_is_the_jax_text(jax_quickstart):
    smoke = _load("_chip_smoke_examples", REPO / "chip_smoke.py")
    assert smoke.QUICKSTART_TEXT == jax_quickstart.rstrip("\n")
    assert list(_sections(smoke.QUICKSTART_TEXT)) == [
        "=== Table 3: hooking a virtualised getpid ===",
        "=== ASC-Hook rewrite report (the paper's §3.1) ===",
        "=== Figure 4: indirect jump onto an svc (strategy C3) ==="]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-2b"])
def test_serve_demo_tokens_equal_jax(arch):
    new = 12
    cfg = jconfigs.get_smoke(arch)
    run = JRunConfig(attn_chunk=8, mlstm_chunk=4, remat_policy="none",
                     decode_budget=max(new, 16))
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    eng = JServeEngine(cfg, run, jp, max_batch=serve_demo.MAX_BATCH)
    eng._prefill = Strict(lambda p, b: jlm.prefill(cfg, run, p, b))
    eng._decode = Strict(lambda p, c, t, pos: jlm.decode_step(
        cfg, run, p, c, t, pos))
    rng = np.random.default_rng(0)
    reqs = [JRequest(rng.integers(0, cfg.vocab, n).astype(np.int32),
                     max_new_tokens=new) for n in serve_demo.PROMPT_LENS]
    want = [f"req{i}: prompt={rq.prompt.tolist()} -> {o.tokens.tolist()}"
            for i, (rq, o) in enumerate(zip(reqs, eng.generate(reqs)))]
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    got = serve_demo.serve_demo(arch, new, "cpu", params=params)
    assert got == want


def test_serve_demo_main_prints_its_lines(capsys):
    serve_demo.main(["--device", "cpu", "--new-tokens", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and all(ln.startswith(f"req{i}: prompt=[")
                                   for i, ln in enumerate(lines))
    assert [len(json.loads(ln.split("-> ")[1])) for ln in lines] == [3] * 3


HOOKED_CHILD = r"""
import json, pickle, sys
from repro_torch.examples import hooked_training
from repro_torch.models.interop import params_from_numpy
with open(sys.argv[1], "rb") as f:
    params = params_from_numpy(pickle.load(f), device="cpu")
out = hooked_training.hooked_training(int(sys.argv[2]), device="cpu",
                                      params=params)
cen = out.census
print(json.dumps({"sites": cen["total_sites"],
                  "by_primitive": cen["by_primitive"],
                  "bytes": cen["payload_bytes_per_step"],
                  "losses": out.losses, "lrs": out.lrs,
                  "lines": out.lines}))
"""


def _jax_hooked(steps: int):
    """The JAX example's computation (examples/hooked_training.py), its
    hooked step compiled strict: (state at step 0, census, losses, lrs)."""
    cfg = jconfigs.get_smoke("qwen3-1.7b")
    run = JRunConfig(attn_chunk=8, remat_policy="none", learning_rate=3e-3,
                     warmup_steps=5, total_steps=steps, z_loss=0.0)
    mesh = jmake_test_mesh(data=jax.device_count(), model=1)
    state = jinit_train_state(cfg, run, jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, state["params"])
    step = jmake_ddp_train_step(cfg, run, mesh)
    stream = JTokenStream(cfg, JShapeConfig("demo", 64, 4, "train"))
    batch0 = {k: jnp.asarray(v) for k, v in stream.batch_at(0).items()}
    cen = jhooks.census_fn(step, state, batch0)
    hooked = Strict(jhooks.hook_collectives(
        step, {"psum": jhooks.CastCompressHandler(min_bytes=1 << 12)}))
    losses, lrs = [], []
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in stream.batch_at(i).items()}
        state, metrics = hooked(state, batch)
        losses.append(float(metrics["loss"]))
        lrs.append(float(metrics["lr"]))
    return params0, cen, losses, lrs


def test_hooked_training_matches_jax(tmp_path):
    params0, cen, losses, lrs = _jax_hooked(STEPS)
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(params0, f)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", HOOKED_CHILD,
                          str(tmp_path / "params.pkl"), str(STEPS)],
                         env=env, capture_output=True, text=True,
                         timeout=600, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["sites"] == cen["total_sites"] == 17
    assert got["by_primitive"] == dict(cen["by_primitive"])
    assert got["bytes"] == cen["payload_bytes_per_step"]
    assert got["losses"][0] == pytest.approx(losses[0], rel=LOSS0_RTOL)
    for a, b in zip(got["losses"][1:], losses[1:]):
        assert a == pytest.approx(b, rel=LOSS_RTOL)
    assert got["lrs"] == lrs
    lines = got["lines"]
    assert lines[0] == (f"collective census: 17 sites, "
                        f"{cen['payload_bytes_per_step'] / 2**20:.1f} "
                        f"MiB/step on the wire")
    assert lines[1].startswith("step   0 loss ") and len(lines) == 3
    assert lines[2].endswith("(compressed gradient wire)")


@pytest.mark.parametrize("run", [
    lambda: quickstart.quickstart(None, ("c3",)),
    lambda: serve_demo.serve_demo(),
    lambda: hooked_training.hooked_training(1)],
    ids=["quickstart", "serve_demo", "hooked_training"])
def test_examples_raise_without_a_card(run, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
