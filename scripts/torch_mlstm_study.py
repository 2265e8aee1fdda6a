#!/usr/bin/env python3
"""Studies of the port's CUDA mLSTM kernels on one NVIDIA GPU (and one on
the CPU): what their time and their error are made of.

    PYTHONPATH=src python scripts/torch_mlstm_study.py probe
    PYTHONPATH=src python scripts/torch_mlstm_study.py timeline
    PYTHONPATH=src python scripts/torch_mlstm_study.py variants
    PYTHONPATH=src python scripts/torch_mlstm_study.py routes
    PYTHONPATH=src python scripts/torch_mlstm_study.py worst --out FILE
    PYTHONPATH=src python scripts/torch_mlstm_study.py splits FILE  (CPU)

* ``probe``: build the library (ptxas's report, ``HGMMA`` counts, the
  runtime's view of each kernel), hold seeded cases to the plain versions
  (largest error and elements over ``chip_smoke.MLSTM_TOL``), time
  xlstm-350m's prefill and decode shapes (device and eager, as
  ``chip_smoke.py`` does), split the time between the kernels with
  ``torch.profiler``, and time the state pass over S and B x H.
* ``timeline``: build a copy of the source with ``clock64`` stamps at the
  state pass's phases (block (0, 0), a thread of each warpgroup) and
  print the cycles of each phase of the first chunks, and of each slice
  of the inter products.
* ``variants``: build copies of the source with parts taken out (the
  results are wrong; only the time counts) and time their state pass.
* ``routes``: xlstm-350m served as ``chip_smoke.py``'s ``serve_xlstm``
  phase serves it, teacher-forced with the kernels' arithmetic in plain
  PyTorch at several bf16 split precisions in the mLSTM's place: each
  route's relative L2 from the plain route, beside the plain routes'.
* ``worst``: the same run through the kernels, each mLSTM call's worst
  element against the plain version (as a share of the bound), and one
  batch row of the worst calls' inputs saved to ``--out``.
* ``splits`` (on the CPU): on those inputs, the kernels' arithmetic with
  every step in f64 but the bf16 splits of C, the scores and g v (two or
  three parts each), against the exact recurrence in f64.

Each prints JSON lines, then the card line.  All but ``splits`` need a
card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.kernels import nvcc  # noqa: E402
from repro_torch.kernels.mlstm_chunk import kernel as xk  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ops as xo  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ref as R  # noqa: E402

PREFILL, DECODE = (8, 512, 4, 512, False), (8, 1, 4, 512, True)


def smoke():
    """chip_smoke.py as a module (its helpers and constants)."""
    import chip_smoke
    return chip_smoke


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def kernel_ms(fn, reps: int = 5) -> dict:
    """{kernel name: device ms a call} of ``fn()`` from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "mlstm" in e.key:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            out[e.key.split("(")[0]] = us / e.count / 1e3
    return out


# -- variants of the source, built side by side -------------------------------

def build_variant(name: str, src: str, extra: str = "") -> ctypes.CDLL:
    """Compile ``src`` (+ ``extra``) as its own library and load it with
    the prefill launcher's argument types."""
    d = Path(tempfile.mkdtemp(prefix=f"mlstm_{name}_"))
    cu, lib = d / f"{name}.cu", d / f"lib{name}.so"
    cu.write_text(src + extra)
    proc = subprocess.run([nvcc.find_nvcc(), *nvcc.NVCC_FLAGS, "-o",
                           str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed:\n{proc.stderr[-3000:]}")
    L = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int64
    L.mlstm_prefill_launch.argtypes = [P] * 11 + [I] * 13 + [ctypes.c_float,
                                                              P]
    L.mlstm_scratch_bytes.argtypes = [I] * 3
    L.mlstm_scratch_bytes.restype = I
    L.spill = [ln for ln in nvcc.ptxas_lines(proc.stdout + proc.stderr)
               if "spill" in ln]
    return L


def prefill_with(L, args) -> None:
    q, k, v, lf, li, C0, n0 = args
    B, S, H, dh = q.shape
    sc = torch.empty(int(L.mlstm_scratch_bytes(B * H, S, dh)),
                     dtype=torch.uint8, device=q.device)
    h = torch.empty((B, S, H, dh), device=q.device)
    C, n = torch.empty_like(C0), torch.empty_like(n0)
    rc = L.mlstm_prefill_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(),
        li.data_ptr(), C0.data_ptr(), n0.data_ptr(), h.data_ptr(),
        C.data_ptr(), n.data_ptr(), sc.data_ptr(), B, S, H, dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], xk.scale_of(dh),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: {rc}")


def edit(src: str, pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise ValueError(f"not found once in the source: {old[:60]!r}")
        src = src.replace(old, new)
    return src


# parts of the state pass taken out by ``variants`` (text of the source)
VARIANTS = {
    "base": [],
    "no_inter_products": [("wgmma_rs(acc, f3[kq][pt],",
                           "if (0) wgmma_rs(acc, f3[kq][pt],")],
    "no_update_products": [("wgmma_ss<1, 1>(t, desc_mn(gv + pt * TILE",
                            "if (0) wgmma_ss<1, 1>(t, desc_mn(gv + pt * "
                            "TILE")],
    "no_qn": [("if (i < my_ns) {\n#pragma unroll\n                    for "
               "(int u = 2 * hf;", "if (0) {\n#pragma unroll\n             "
               "       for (int u = 2 * hf;")],
    "no_h": [("if (e < dh && j < kc)\n                        hp[",
              "if (0)\n                        hp[")],
}

# clock64 stamps (the phase's number, where) for ``timeline``
STAMP = ("if ((threadIdx.x & 127) == 32 && blockIdx.x == 0 && blockIdx.y == 0)"
         " g_ts[(threadIdx.x >> 7) * 1024 + c * 32 + {k}] = clock64();")
MARKS = [
    ("mbar_wait(cfull + 8 * cs, (c >> 1) & 1);", "0", "after"),
    ("if (i < nsw) mbar_wait(rfull + 8 * i, par);", "8 + 4 * i", "after"),
    ("        qnp[(2 * w + qh) * KC + qj] =", "1", "before"),
    ("__syncthreads();  // the q slices and the other chunk stage are free",
     "2", "after"),
    ("        // C^T = exp(d_end) C^T + (g v)^T k", "3", "before"),
    ("for (int i = 0; i < nsw; ++i) mbar_wait(rfull + 8 * (4 + i), par);",
     "4", "after"),
    ("        // n = exp(d_end) n + u over", "5", "before"),
    ("__syncthreads();  // the k slices, n, X, the partials, g v are free",
     "6", "after"),
]
PHASES = ("wait for the chunk", "inter", "to the barrier", "copy issue",
          "wait for k", "update and h", "to the end")


def cmd_probe(args) -> None:
    S = smoke()
    lib, report = xk.build()
    emit({"ptxas": nvcc.ptxas_table(report),
          "hgmma": nvcc.sass_counts(lib, "HGMMA"), "info": xk.info()})
    dev = torch.device("cuda")
    for i, case in enumerate(S.MLSTM_CASES + (PREFILL, DECODE)):
        a = S.mlstm_inputs(case, 100 + i, dev)
        got = xo.mlstm_chunk(*a)
        torch.cuda.synchronize()
        row = {"case": list(case)}
        for name, want in (("chunked", R.mlstm_chunk_ref(*a, xk.CHUNK)),
                           ("sequential", R.mlstm_seq(*a)),
                           ("kernel_form", S.mlstm_kernel_form(*a))):
            row[name] = [S.over_bound(g, w, torch.float32, S.MLSTM_TOL)
                         for g, w in zip(got, want)]
        emit(row)
    for case in (PREFILL, DECODE):
        a = S.mlstm_inputs(case, 7, dev)
        emit({"case": list(case), **S.mlstm_timed(a), **S.mlstm_bounds(case),
              "profile": kernel_ms(lambda: xo.mlstm_chunk(*a))})
    for shape in ((8, 64, 4), (8, 128, 4), (8, 256, 4), (8, 1024, 4),
                  (1, 512, 1), (4, 512, 4), (16, 512, 4)):
        B, Sq, H = shape
        a = S.mlstm_inputs((B, Sq, H, 512, False), 7, dev)
        emit({"B, S, H": list(shape),
              "profile": kernel_ms(lambda: xo.mlstm_chunk(*a))})
    print(S.card_line())


def cmd_variants(args) -> None:
    S = smoke()
    src = xk.SOURCE.read_text()
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(
            lambda n: build_variant(n, edit(src, VARIANTS[n])), VARIANTS)))
    a = S.mlstm_inputs(PREFILL, 7, "cuda")
    for name, L in libs.items():
        emit({"variant": name, "spill": L.spill,
              "profile": kernel_ms(lambda: prefill_with(L, a))})
    print(S.card_line())


def cmd_timeline(args) -> None:
    S = smoke()
    src = xk.SOURCE.read_text()
    pairs = []
    for anchor, k, where in MARKS:
        stamp = STAMP.format(k=k)
        pairs.append((anchor, f"{anchor}\n{stamp}" if where == "after"
                      else f"{stamp}\n{anchor}"))
    start = "    __syncthreads();  // the barriers are initialised, n is in"
    pairs.append((start, start + "\n    { const int c = 31; "
                  + STAMP.format(k=7) + " }"))
    pairs.append(("constexpr int KC = 64;",
                  "__device__ long long g_ts[2048];\nconstexpr int KC = 64;"))
    L = build_variant("timeline", edit(src, pairs), '\nextern "C" int '
                      'read_ts(long long* o) { return (int)'
                      'cudaMemcpyFromSymbol(o, g_ts, sizeof(g_ts)); }\n')
    for case in ((1, 512, 1, 512, False), PREFILL):
        a = S.mlstm_inputs(case, 7, "cuda")
        for _ in range(2):
            prefill_with(L, a)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 2048)()
        if L.read_ts(buf):
            raise RuntimeError("read_ts failed")
        for wg in (0, 1):
            t = buf[wg * 1024:(wg + 1) * 1024]
            chunks = []
            for c in range(3):
                r = t[c * 32:c * 32 + 7]
                prev = t[31 * 32 + 7] if c == 0 else t[(c - 1) * 32 + 6]
                cyc = [r[0] - prev] + [r[i] - r[i - 1] for i in range(1, 7)]
                sl = []
                for i in range(4):  # slice i: from its wait to the next
                    nxt = t[c * 32 + 8 + 4 * (i + 1)] if i < 3 else r[1]
                    sl.append(nxt - t[c * 32 + 8 + 4 * i])
                chunks.append({"phases": dict(zip(PHASES, cyc)),
                               "inter_slices": sl})
            emit({"case": list(case), "warpgroup": wg, "chunks": chunks})
    print(S.card_line())


def serve_run():
    """xlstm-350m served as chip_smoke.py's serve_xlstm phase serves it;
    returns the teacher-forcing arguments."""
    S = smoke()
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    kinds = get_config(S.XL_ARCH).layer_kinds()
    calls = kinds.count("mlstm") * (1 + S.SERVE_NEW)
    m = S.serve_main_path(S.XL_ARCH, torch.device("cuda"), {
        "flash": 0, "decode": 0, "rglru": 0, "mlstm": calls})
    return S, m, (m["cfg"], m["run"], m["params"], m["toks"], m["plen"],
                  m["fed"])


def kernel_form(*parts):
    """The kernels' arithmetic in plain PyTorch (``ref.mlstm_tc_ref``; the
    decode step exact, ``ref.mlstm_decode_ref``) with C, the scores and
    g v in the given numbers of bf16 parts, in the model's mLSTM's place."""
    def f(q, k, v, log_f, log_i, C0, n0, *, chunk, out=None):
        if q.shape[1] == 1:
            C, n = C0.clone(), n0.clone()
            return R.mlstm_decode_ref(q, k, v, log_f, log_i, C, n), C, n
        return R.mlstm_tc_ref(q, k, v, log_f, log_i, C0, n0, xk.CHUNK,
                              parts)
    return f


def cmd_routes(args) -> None:
    S, m, tf = serve_run()
    vocab = m["cfg"].vocab
    lp, _, _ = S.teacher_forced(*tf, mlstm=S.plain_mlstm)
    routes = {"model": S.model_mlstm, "sequential": S.seq_mlstm,
              "kernels": S.MLSTM}
    for parts in ((2, 2, 2), (3, 2, 2), (3, 3, 2), (3, 2, 3), (3, 3, 3)):
        routes["kernel_form C%d S%d gv%d" % parts] = kernel_form(*parts)
    out = {}
    for name, fn in routes.items():
        lk, _, _ = S.teacher_forced(*tf, mlstm=fn)
        out[name] = S.route_stats(lk, lp, vocab)[3]
    lf, _, _ = S.teacher_forced(*tf, mlstm=S.model_mlstm)
    ls, _, _ = S.teacher_forced(*tf, mlstm=S.seq_mlstm)
    out["model_vs_sequential"] = S.route_stats(lf, ls, vocab)[3]
    emit({"rel_l2_from_the_plain_route": out})
    print(S.card_line())


def cmd_worst(args) -> None:
    S, m, tf = serve_run()
    rows, saved = [], {}

    class Worst:
        calls = 0

        def __call__(self, *a, chunk, out=None):
            want = R.mlstm_chunk_ref(*a, xk.CHUNK)
            got = S.MLSTM(*a, chunk=chunk, out=out)
            for leaf, g, w in zip("hCn", got, want):
                ratio = (g - w).abs() / (S.MLSTM_TOL[0]
                                         + S.MLSTM_TOL[1] * w.abs())
                k = int(ratio.argmax())
                rows.append({"call": self.calls, "S": a[0].shape[1],
                             "leaf": leaf, "ratio": float(ratio.flatten()[k]),
                             "got": float(g.flatten()[k]),
                             "want": float(w.flatten()[k]), "index": k})
                if ratio.flatten()[k] > args.save_above:
                    b = k // (g[0].numel())
                    saved[self.calls] = [x[b:b + 1].cpu().clone() for x in a]
            self.calls += 1
            return got

    S.teacher_forced(*tf, mlstm=Worst())
    rows.sort(key=lambda r: -r["ratio"])
    for r in rows[:args.top]:
        emit(r)
    if args.out:
        torch.save(saved, args.out)
        emit({"saved_calls": sorted(saved)})
    print(S.card_line())


def truth(q, k, v, lf, li, C0, n0):
    """The recurrence one step at a time, in f64."""
    q, k, v = q.double(), k.double(), v.double()
    scale = 1 / math.sqrt(q.shape[-1])
    f, i = lf.double().exp(), li.double().clamp(max=30).exp()
    C, n, hs = C0.double(), n0.double(), []
    for t in range(q.shape[1]):
        C = (f[:, t, :, None, None] * C
             + (i[:, t, :, None, None] * k[:, t, :, :, None])
             * v[:, t, :, None, :])
        n = f[:, t, :, None] * n + i[:, t, :, None] * k[:, t]
        qs = q[:, t] * scale
        den = (qs * n).sum(-1).abs().clamp(min=1)
        hs.append((qs[..., :, None] * C).sum(-2) / den[..., None])
    return torch.stack(hs, 1), C, n


def split64(x, parts):
    """x (f64) as the sum of ``parts`` bf16 values, each rounding what the
    earlier ones leave."""
    out, r = torch.zeros_like(x), x.clone()
    for _ in range(parts):
        p = r.float().bfloat16().double()
        out, r = out + p, r - p
    return out


def split_model(q, k, v, lf, li, C0, n0, pc, ps, pg, K=64):
    """The kernels' arithmetic in f64 but for the bf16 splits."""
    scale = 1 / math.sqrt(q.shape[-1])
    qf, kf, vf = (x.double().transpose(1, 2) for x in (q, k, v))
    lf, li = lf.double().transpose(1, 2), li.double().transpose(1, 2)
    C, n, hs = C0.double(), n0.double(), []
    for c0 in range(0, q.shape[1], K):
        qc, kc, vc = (x[:, :, c0:c0 + K] for x in (qf, kf, vf))
        d = lf[:, :, c0:c0 + K].cumsum(-1)
        gi = li[:, :, c0:c0 + K]
        rel = d[..., :, None] - d[..., None, :] + gi[..., None, :]
        live = torch.tril(torch.ones(qc.shape[2], qc.shape[2],
                                     dtype=torch.bool))
        s = torch.where(live, (qc @ kc.transpose(-1, -2)) * scale
                        * rel.clamp(max=30).exp(), torch.zeros((),
                                                               dtype=C.dtype))
        eq = d.exp() * scale
        den = (eq * (qc @ n[..., None])[..., 0] + s.sum(-1)).abs().clamp(
            min=1)
        hs.append((eq[..., None] * (qc @ split64(C, pc))
                   + split64(s, ps) @ vc) / den[..., None])
        g = (d[..., -1:] - d + gi).exp()
        C = (C * d[..., -1].exp()[..., None, None]
             + kc.transpose(-1, -2) @ split64(g[..., None] * vc, pg))
        n = n * d[..., -1].exp()[..., None] + (g[..., None] * kc).sum(-2)
    return torch.cat(hs, 2).transpose(1, 2), C, n


def cmd_splits(args) -> None:
    data = torch.load(args.inputs)
    lo, hi = 3e-4, 3e-3  # chip_smoke.MLSTM_TOL
    for call, a in data.items():
        t = truth(*a)
        for parts in ((2, 2, 2), (3, 2, 2), (2, 3, 2), (2, 2, 3), (3, 2, 3),
                      (3, 3, 3)):
            got = split_model(*a, *parts)
            emit({"call": call, "parts C, S, gv": list(parts),
                  "worst_share_of_bound": {
                      leaf: float(((g - w).abs() / (lo + hi * w.abs())).max())
                      for leaf, g, w in zip("hCn", got, t)}})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("probe", "timeline", "variants", "routes"):
        sub.add_parser(name)
    w = sub.add_parser("worst")
    w.add_argument("--out", default=None)
    w.add_argument("--top", type=int, default=12)
    w.add_argument("--save-above", type=float, default=0.5)
    sp = sub.add_parser("splits")
    sp.add_argument("inputs")
    args = ap.parse_args()
    if args.cmd != "splits" and not torch.cuda.is_available():
        print("torch_mlstm_study: no CUDA device is available",
              file=sys.stderr)
        return 2
    {"probe": cmd_probe, "timeline": cmd_timeline, "variants": cmd_variants,
     "routes": cmd_routes, "worst": cmd_worst,
     "splits": cmd_splits}[args.cmd](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
