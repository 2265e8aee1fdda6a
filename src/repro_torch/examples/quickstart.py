"""Quickstart: ASC-Hook on a simulated AArch64 process, on the card.

Builds a syscall-heavy program, intercepts it with every mechanism from
the paper's evaluation, and reproduces the Figure-4 completeness flow:
the JAX package's ``examples/quickstart.py``, line for line, through the
port's entry points (``prepare``, ``run_prepared`` and ``run_with_c3``,
whose runs go through the megastep kernel on the card).

The ns/call of Table 3 are the cost model's simulated cycles
(``costmodel.cycles_to_ns``), the same on every device; they are not
times measured on the card.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List, Sequence

from ..core import (HookConfig, Mechanism, costmodel, hook_invocations,
                    layout, mem_read, prepare, programs, run_prepared,
                    run_with_c3)

SECTIONS = ("table3", "rewrite", "c3")
CALLS = 100  # getpid calls a Table-3 run makes


def table3(device=None) -> List[str]:
    lines = ["=== Table 3: hooking a virtualised getpid ==="]
    for mech in (Mechanism.LD_PRELOAD, Mechanism.ASC, Mechanism.SIGNAL,
                 Mechanism.PTRACE):
        pp = prepare(programs.getpid_loop(CALLS), mech, virtualize=True)
        st = run_prepared(pp, device=device)
        ns = costmodel.cycles_to_ns(int(st.cycles)) / CALLS
        pid = mem_read(st, layout.SCRATCH)
        lines.append(f"  {mech.value:11s} {ns:9.1f} ns/call  pid={pid} "
                     f"hooks={hook_invocations(st)}")
    return lines


def rewrite_report() -> List[str]:
    """The rewriter's report (host only: no device runs)."""
    lines = ["=== ASC-Hook rewrite report (the paper's §3.1) ==="]
    pp = prepare(programs.mixed_ops(4, 256), Mechanism.ASC)
    lines.append(f"  {pp.report.summary()}")
    for s in pp.report.sites:
        lines.append(f"  svc@{s.svc_addr:#x} {s.lib}+{s.offset:#x} "
                     f"nr={s.syscall_nr} -> {s.classification}")
    return lines


def c3(device=None) -> List[str]:
    lines = ["=== Figure 4: indirect jump onto an svc (strategy C3) ==="]
    st, pp, events, runs = run_with_c3(lambda: programs.indirect_svc(2),
                                       cfg=HookConfig(), virtualize=True,
                                       device=device)
    lines.append(f"  executions: {runs} (fault -> config -> re-exec)")
    for ev in events:
        lines.append(f"  pinned: {ev.lib}+{ev.offset:#x} "
                     f"syscall={ev.syscall_nr}")
    lines.append(f"  final pid: {mem_read(st, layout.SCRATCH)} "
                 f"(virtualised: {layout.VIRT_PID})")
    return lines


def quickstart(device=None, sections: Sequence[str] = SECTIONS) -> str:
    """The example's text (``sections`` of it, in order, each after a
    blank line but the first), run on ``device`` (None: the card)."""
    parts = {"table3": lambda: table3(device), "rewrite": rewrite_report,
             "c3": lambda: c3(device)}
    return "\n\n".join("\n".join(parts[s]()) for s in sections)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch step on the CPU)")
    args = ap.parse_args(argv)
    print(quickstart(args.device))


if __name__ == "__main__":
    main()
