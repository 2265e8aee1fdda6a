"""Build a kernel library with ``nvcc`` at first use, shared by every kernel.

Each kernel is one CUDA C++ source with a plain C interface, compiled for
``sm_90a`` into a shared library that the kernel's ``kernel.py`` loads
with ``ctypes``.  The library lands in the kernel's git-ignored ``build/``
directory, named by a hash of the source, the generated headers and the
flags, so an edited source rebuilds and an unchanged one is reused.

Nothing here runs at import time; importing this module needs no card
and no compiler.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Mapping

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels are built with the CUDA "
                       "toolkit on the machine with the card")


def build(name: str, source: Path, build_dir: Path,
          headers: Mapping[str, str] = {}) -> tuple[Path, str]:
    """Compile ``source`` into ``build_dir/lib<name>_<hash>.so`` unless it
    is there already.  ``headers`` maps file names to generated header
    text, written into an include directory of the build.  Returns the
    library path and the compiler's report (``-Xptxas -v``: registers,
    shared memory, spills; empty when the library was already built)."""
    src = source.read_text()
    parts = [src, *(f"{k}\0{v}" for k, v in sorted(headers.items())),
             *NVCC_FLAGS]
    tag = hashlib.sha1("\0".join(parts).encode()).hexdigest()[:16]
    lib = build_dir / f"lib{name}_{tag}.so"
    if lib.exists():
        return lib, ""
    inc = build_dir / f"include_{tag}"
    inc.mkdir(parents=True, exist_ok=True)
    for fname, text in headers.items():
        (inc / fname).write_text(text)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(inc), "-o", str(tmp),
           str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({proc.returncode}):\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def ptxas_lines(report: str) -> list:
    """The lines of a build report that give registers, stack and spills."""
    return [ln.strip() for ln in report.splitlines()
            if "registers" in ln or "spill" in ln or "stack frame" in ln]


def ptxas_table(report: str) -> dict:
    """{kernel (mangled name): {"registers", "stack", "spill_stores",
    "spill_loads"}} from a build report."""
    out, name = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def ptxas_functions(report: str) -> dict:
    """{function (mangled name): {"stack", "spill_stores", "spill_loads"}
    and, for a kernel, "registers"} for every function in a build report:
    the kernels and each device function they call that was not inlined."""
    out, name, entry = {}, None, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and name is not None:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry is not None:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


def sass_counts(lib: Path, opcode: str) -> dict:
    """{kernel (mangled name): instructions named ``opcode``} in a built
    library's SASS (``cuobjdump -sass``, beside nvcc in the toolkit)."""
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True)
    out, name = {}, None
    for ln in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = 0
        elif name is not None and re.search(rf"\b{opcode}\b", ln):
            out[name] += 1
    return out
