"""Static analysis pass (paper §2 observations + §3.3 strategies C1/C2).

Linear-scan disassembly of every rewritable section (the paper uses GNU
libopcodes over procfs text maps), producing for each ``svc``:

* the displaced-pair partner — the nearest preceding assignment to x8 within
  the 20-instruction window;
* its classification:
    - ``pair``      -> two-instruction rewrite (R1/R2);
    - ``no_x8``     -> strategy C1 (missing/unsafe ABI) -> signal (R3);
    - ``jump_between`` -> strategy C2 (a *direct* branch targets the region
       between the pair, svc inclusive) -> signal (R3);
    - ``pinned``    -> pinned in the config file (user knowledge about
       indirect jumps, or a previous C3 fault) -> signal (R3).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Set

from . import isa
from .hookcfg import HookConfig
from .image import Image
from .isa import Op


BRANCH_OPS = {Op.B, Op.BL, Op.BR, Op.BLR, Op.RET, Op.CBZ, Op.CBNZ, Op.BCOND}
DIRECT_BRANCH_OPS = {Op.B, Op.BL, Op.CBZ, Op.CBNZ, Op.BCOND}
# Walking backward past any of these means the x8 assignment (if any) belongs
# to different control flow / a different wrapper: "clear ABI omission" (C1).
BACKWARD_STOP_OPS = BRANCH_OPS | {Op.SVC, Op.BRK, Op.HLT, Op.ILLEGAL}


@dataclasses.dataclass
class SvcSite:
    svc_addr: int
    lib: str
    offset: int                 # svc offset within its library
    x8_addr: Optional[int]      # address of the displaced assignment (if any)
    x8_word: Optional[int]      # its original encoding (re-executed in L2)
    classification: str         # pair | no_x8 | jump_between | pinned
    syscall_nr: int = -1        # statically known when the pair half is movz

    @property
    def return_addr(self) -> int:
        return self.svc_addr + 4


def direct_branch_targets(image: Image) -> Set[int]:
    """All statically-computable branch targets in the process image."""
    targets: Set[int] = set()
    for sec in image.sections:
        for off in range(0, sec.size, 4):
            pc = sec.base + off
            d = isa.decode(image.word_at(pc))
            if d.op in DIRECT_BRANCH_OPS:
                targets.add(pc + d.imm)
    return targets


def scan_image(image: Image, cfg: Optional[HookConfig] = None) -> List[SvcSite]:
    cfg = cfg or HookConfig()
    targets = direct_branch_targets(image)
    sites: List[SvcSite] = []

    for sec in image.sections:
        if not sec.rewrite:
            continue
        for off in range(0, sec.size, 4):
            pc = sec.base + off
            d = isa.decode(image.word_at(pc))
            if d.op != Op.SVC:
                continue

            # Backward search for the x8 assignment (paper: <= 20 instrs).
            x8_addr = None
            x8_word = None
            for back in range(1, cfg.backward_window + 1):
                q = pc - 4 * back
                if q < sec.base:
                    break
                w = image.word_at(q)
                qd = isa.decode(w)
                if isa.is_x8_assign(w):
                    x8_addr, x8_word = q, w
                    break
                if qd.op in BACKWARD_STOP_OPS:
                    # Crossed a control-flow edge / wrapper boundary before
                    # finding the assignment: "clear ABI omission" -> C1.
                    break

            nr = -1
            if x8_word is not None:
                xd = isa.decode(x8_word)
                if xd.op == Op.MOVZ and xd.sh == 0:
                    nr = xd.imm

            cls = "pair"
            if x8_addr is None:
                cls = "no_x8" if cfg.enable_c1 else "pair_unsafe"
            else:
                # C1 also rejects control flow strictly inside the pair.
                inner = range(x8_addr + 4, pc, 4)
                if cfg.enable_c1 and any(
                        isa.decode(image.word_at(q)).op in BRANCH_OPS for q in inner):
                    cls = "no_x8"
                # C2: a direct branch targets (x8_addr, svc_addr] — the region
                # where entering skips the first replacement instruction.
                elif cfg.enable_c2 and any(
                        x8_addr < t <= pc for t in targets if t % 4 == 0):
                    cls = "jump_between"

            if cls.startswith("pair") and cfg.is_pinned(sec.name, off, pc):
                cls = "pinned"

            sites.append(SvcSite(
                svc_addr=pc, lib=sec.name, offset=off,
                x8_addr=x8_addr, x8_word=x8_word,
                classification="pair" if cls == "pair_unsafe" else cls,
                syscall_nr=nr))
    return sites


def census(image: Image) -> dict:
    """Table 1/2 analogue: svc population of a process image."""
    sites = scan_image(image)
    by_lib: dict = {}
    for s in sites:
        by_lib.setdefault(s.lib, 0)
        by_lib[s.lib] += 1
    return {
        "total_svc": len(sites),
        "by_lib": by_lib,
        "signal_needed": sum(1 for s in sites if s.classification != "pair"),
        "classes": {c: sum(1 for s in sites if s.classification == c)
                    for c in ("pair", "no_x8", "jump_between", "pinned")},
    }
