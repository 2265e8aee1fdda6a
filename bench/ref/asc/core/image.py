"""Process-image model: sections, symbols, a mini-libc, a loader.

The paper scans the live process through procfs and rewrites the text of the
application plus its shared libraries (most svc sites live in glibc /
ld.so / libpthread).  Here a process image is the full executable region
``[0, CODE_LIMIT)`` plus a section table that plays the role of
``/proc/self/maps``: each section knows its "library" name, base and whether
the rewriter may touch it (the hook library and the signal handler live in a
separate ``dlmopen`` namespace and are *never* rewritten — §3.4).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import isa
from . import layout as L
from .isa import Asm

# Section bases (within [0, CODE_LIMIT)).
APP_BASE = L.TEXT_BASE      # 0x10000 application text
LIBC_BASE = 0x18000         # mini-libc ("libc-2.31.so" of this world)
PRELOAD_BASE = 0x1E000      # LD_PRELOAD interposition stubs
HOOK_BASE = 0x20000         # hook library (dlmopen namespace, not rewritten)
HANDLER_BASE = 0x24000      # signal handler (registered pre-main, not rewritten)
TRAMP_BASE = 0x28000        # L2 pool + shared L3
PAGE_TRAMP_BASE = 0x30000   # R2 page-aligned trampolines (4 KiB each)


@dataclasses.dataclass
class Section:
    name: str
    base: int
    size: int  # bytes
    rewrite: bool  # may the rewriter modify this section?

    @property
    def end(self) -> int:
        return self.base + self.size


class Image:
    """A flat executable region with a maps-style section table."""

    def __init__(self) -> None:
        self.words = np.zeros(L.CODE_WORDS, np.uint32)
        self.sections: List[Section] = []
        self.symbols: Dict[str, int] = {}

    # -- construction ---------------------------------------------------------
    def add_section(self, name: str, base: int, words: List[int], *,
                    rewrite: bool) -> Section:
        assert base % 4 == 0 and base >= L.NULL_END
        idx = base // 4
        for s in self.sections:
            if not (base + 4 * len(words) <= s.base or base >= s.end):
                raise ValueError(f"section overlap: {name} vs {s.name}")
        self.words[idx:idx + len(words)] = np.asarray(words, np.uint32)
        sec = Section(name, base, 4 * len(words), rewrite)
        self.sections.append(sec)
        return sec

    def add_asm(self, name: str, asm: Asm, *, rewrite: bool,
                symbols: Optional[Dict[str, int]] = None) -> Section:
        words = asm.assemble({**self.symbols, **(symbols or {})})
        sec = self.add_section(name, asm.base, words, rewrite=rewrite)
        for lbl, item_idx in asm.labels.items():
            self.symbols[f"{name}:{lbl}"] = asm.base + 4 * item_idx
        return sec

    # -- access ----------------------------------------------------------------
    def word_at(self, addr: int) -> int:
        assert addr % 4 == 0 and 0 <= addr < L.CODE_LIMIT
        return int(self.words[addr // 4])

    def set_word(self, addr: int, word: int) -> None:
        assert addr % 4 == 0 and 0 <= addr < L.CODE_LIMIT
        self.words[addr // 4] = np.uint32(word)

    def section_of(self, addr: int) -> Optional[Section]:
        for s in self.sections:
            if s.base <= addr < s.end:
                return s
        return None

    def maps(self) -> List[Tuple[str, int, int]]:
        """procfs-style view: (name, base, end)."""
        return [(s.name, s.base, s.end) for s in sorted(self.sections, key=lambda s: s.base)]

    def sym(self, name: str) -> int:
        return self.symbols[name]

    def clone(self) -> "Image":
        im = Image()
        im.words = self.words.copy()
        im.sections = [dataclasses.replace(s) for s in self.sections]
        im.symbols = dict(self.symbols)
        return im


# ---------------------------------------------------------------------------
# mini-libc
# ---------------------------------------------------------------------------

def build_minilibc() -> Asm:
    """Syscall wrappers in the shape compilers actually emit.

    Includes the paper's edge cases:
      * ``raw_svc`` — an svc with **no** x8 assignment in the preceding 20
        instructions (caller supplies x8): completeness strategy C1.
      * ``looped_svc`` — a branch target *between* the x8 assignment and the
        svc (a retry loop re-entering at the svc): strategy C2.
    """
    a = Asm(LIBC_BASE)

    def wrapper(label: str, nr: int, pad_before_svc: int = 0):
        a.label(label)
        a.emit(isa.movz(8, nr, sf=0))  # mov w8, #NR — the displaceable pair half
        for _ in range(pad_before_svc):  # args shuffling between pair halves
            a.emit(isa.nop())
        a.emit(isa.svc(0))
        a.emit(isa.ret())

    wrapper("getpid", L.SYS_GETPID)
    wrapper("read", L.SYS_READ, pad_before_svc=2)   # non-adjacent pair
    wrapper("write", L.SYS_WRITE, pad_before_svc=1)
    wrapper("openat", L.SYS_OPENAT)
    wrapper("close", L.SYS_CLOSE)

    a.label("exit")
    a.emit(isa.movz(8, L.SYS_EXIT, sf=0))
    a.emit(isa.svc(0))
    a.emit(isa.hlt(0))  # unreachable

    # C1 case: svc whose x8 assignment happens in the caller.
    a.label("raw_svc")
    a.emit(isa.svc(0))
    a.emit(isa.ret())

    # C2 case: x19 = retry count; the back-edge targets the svc itself, i.e.
    # a *direct* jump lands between the replaced pair.
    a.label("retry_svc")
    a.emit(isa.movz(8, L.SYS_GETPID, sf=0))
    a.label("retry_svc.loop")
    a.emit(isa.svc(0))
    a.emit(isa.subsi(19, 19, 1))
    a.b_to("retry_svc.loop", cond="ne")
    a.emit(isa.ret())

    # Filler so census numbers look like a real .so (plain ALU bodies).
    a.label("memcpy_like")
    for _ in range(24):
        a.emit(isa.add_r(0, 0, 1))
    a.emit(isa.ret())
    return a


def build_preload_stubs(virtualize: bool) -> Asm:
    """LD_PRELOAD-style function interposition (the paper's baseline #1).

    Calls into a preloaded .so resolve through the PLT: the entry point is a
    PLT-style veneer (materialise the GOT slot, indirect branch) before the
    stub body — that indirection is most of LD_PRELOAD's measured cost in
    Table 3.  The stub bumps the hook counter and either returns the virtual
    pid (Table 3 setup: no kernel crossing) or tail-calls the real wrapper.
    """
    a = Asm(PRELOAD_BASE)
    # PLT veneer (what bl actually lands on in a dynamically-linked binary)
    a.label("getpid")
    a.mov48_sym(16, "getpid.body")   # adrp+add+ldr of the GOT slot, modelled
    a.emit(isa.br(16))               # indirect: the BTB-miss cost
    a.label("getpid.body")
    a.emit(isa.movz(10, L.COUNTER & 0xFFFF), isa.movk(10, L.COUNTER >> 16, 1))
    a.emit(isa.ldr_imm(11, 10), isa.addi(11, 11, 1), isa.str_imm(11, 10))
    if virtualize:
        a.emit(isa.movz(0, L.VIRT_PID))
        a.emit(isa.ret())
    else:
        a.items.append(("fix", ("b", "real_getpid", None)))
    return a


ProgramBuilder = Callable[[Dict[str, int]], Asm]


def build_process(app: Asm, *, extra: Optional[Dict[str, Asm]] = None,
                  preload_virt: Optional[bool] = None) -> Image:
    """Link a process image: mini-libc + optional preload stubs + app text."""
    im = Image()
    libc = build_minilibc()
    im.add_asm("libc.so", libc, rewrite=True)
    if preload_virt is not None:
        stubs = build_preload_stubs(preload_virt)
        im.add_asm("preload.so", stubs, rewrite=True,
                   symbols={"real_getpid": im.sym("libc.so:getpid")})
    for name, asm in (extra or {}).items():
        im.add_asm(name, asm, rewrite=True)
    # When preloading, symbol interposition wins: app calls resolve to stubs.
    syms = dict(im.symbols)
    if preload_virt is not None:
        syms["libc.so:getpid"] = im.sym("preload.so:getpid")
    im.add_asm("app", app, rewrite=True, symbols=syms)
    return im
