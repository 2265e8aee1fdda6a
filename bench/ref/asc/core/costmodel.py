"""Cycle-cost model for the simulated Neoverse-N1 (the paper's test machine).

Two tiers, with an honest split:

* **Mechanistic** per-instruction costs — ALU ops, loads/stores, branches,
  indirect-branch mispredict penalty.  These come from public Neoverse-N1
  software-optimisation-guide orders of magnitude and drive the *relative*
  cost of trampoline designs (this is what the rewriter actually controls).
* **Calibrated** OS-boundary constants — kernel crossing, signal delivery,
  ptrace stops.  These are kernel-path costs our user-level simulation cannot
  derive mechanistically; they are calibrated once against the paper's own
  environment (dual-core Neoverse-N1 @ 2.8 GHz, Linux 5.4, glibc 2.31,
  Table 3) and then *held fixed* across every experiment, so all comparisons
  between mechanisms remain fair.
"""

CLOCK_GHZ = 2.8  # paper's machine


def cycles_to_ns(cycles: float) -> float:
    return cycles / CLOCK_GHZ


# -- mechanistic per-instruction costs (cycles) ------------------------------
COST_ALU = 1          # mov/add/sub/logic/madd/adr(p)
COST_MEM = 2          # L1-hit load/store (incl. pair)
COST_BRANCH = 1       # direct b / b.cond / cbz
COST_CALL = 2         # bl / ret (predicted)
COST_INDIRECT = 9     # br/blr: 1 issue + ~8-cycle BTB-miss penalty.  The
                      # trampoline path takes several cold indirect branches;
                      # this is the dominant mechanistic term in ASC-Hook's
                      # 5x-over-LD_PRELOAD overhead, matching the paper's
                      # explanation of where its time goes.

# -- calibrated OS-boundary costs (cycles) ------------------------------------
KERNEL_CROSS = 380      # svc entry/exit (~136 ns) — cancels out in Table 3
                        # because the paper's hook virtualises getpid.
SIGNAL_DELIVERY = 2400  # deliver SIGTRAP/SIGILL to a user handler
PTRACE_STOP = 2780      # one ptrace stop + tracer context switch; a syscall
                        # costs two stops (entry + exit).
IO_BYTES_PER_CYCLE = 8  # copy bandwidth for read/write payloads
