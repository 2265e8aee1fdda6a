"""The hybrid replacement strategy (paper §3.1).

For each classified svc site:

* ``pair`` sites get the two-instruction rewrite —
  R1 (``movz x8, #L1; ...; br x8``) for the first 3840 sites,
  R2 (``adrp x8, page; ...; br x8``) past the L1 budget;
* everything else (C1/C2/pinned) gets R3: the svc is replaced with ``brk``
  (or an illegal instruction, per config) and intercepted via the signal path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from . import isa
from .hookcfg import HookConfig
from .image import Image
from .scanner import SvcSite, scan_image
from .trampoline import TrampolineBuilder


@dataclasses.dataclass
class RewriteReport:
    sites: List[SvcSite]
    r1_sites: int = 0
    r2_sites: int = 0
    r3_sites: int = 0
    l1_used: int = 0
    trampoline_bytes: int = 0

    @property
    def needs_signal(self) -> bool:
        return self.r3_sites > 0

    def summary(self) -> Dict[str, int]:
        return {"svc_total": len(self.sites), "r1": self.r1_sites,
                "r2": self.r2_sites, "r3": self.r3_sites,
                "l1_slots": self.l1_used,
                "trampoline_bytes": self.trampoline_bytes}


def _rewrite_r3(image: Image, site: SvcSite, cfg: HookConfig) -> None:
    word = isa.brk(0) if cfg.use_brk else isa.UDF_WORD
    image.set_word(site.svc_addr, word)


def rewrite_image(image: Image, hook_entry: int,
                  cfg: Optional[HookConfig] = None) -> RewriteReport:
    """Apply ASC-Hook to ``image`` in place. Returns the rewrite report."""
    cfg = cfg or HookConfig()
    sites = scan_image(image, cfg)
    report = RewriteReport(sites=sites)
    builder = TrampolineBuilder(image, hook_entry, max_l1_slots=cfg.max_l1_slots)

    for site in sites:
        if site.classification != "pair":
            _rewrite_r3(image, site, cfg)
            report.r3_sites += 1
            continue
        assert site.x8_addr is not None
        l1 = builder.add_r1(site)
        if l1 is not None:
            # R1: movz x8, #L1 (imm16 reach is why L1 lives below 65536)
            image.set_word(site.x8_addr, isa.movz(8, l1))
            image.set_word(site.svc_addr, isa.br(8))
            report.r1_sites += 1
        else:
            # R2 fallback: adrp x8, <page of trampoline>
            page = builder.add_r2(site)
            delta_pages = (page >> 12) - (site.x8_addr >> 12)
            image.set_word(site.x8_addr, isa.adrp(8, delta_pages))
            image.set_word(site.svc_addr, isa.br(8))
            report.r2_sites += 1

    report.l1_used = builder.ts.l1_used
    report.trampoline_bytes = builder.ts.bytes_used
    return report


def rewrite_all_to_signal(image: Image, cfg: Optional[HookConfig] = None) -> RewriteReport:
    """The paper's 'signal interception methods' baseline: every svc -> brk."""
    cfg = cfg or HookConfig()
    sites = scan_image(image, cfg)
    report = RewriteReport(sites=sites)
    for site in sites:
        _rewrite_r3(image, site, cfg)
        report.r3_sites += 1
    return report
