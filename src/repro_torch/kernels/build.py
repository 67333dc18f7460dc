"""Builds the port's CUDA C++ kernels and loads them with ctypes.

Each source ``csrc/<name>.cu`` has a plain C interface and compiles with
``nvcc`` alone (no PyTorch headers, so a build takes seconds) into
``build/kernels/lib<name>-<digest>.so`` at the root of the checkout,
which ``.gitignore`` lists. The digest covers the source, the shared
headers ``csrc/*.cuh`` and the flags, so an edited source or header is
rebuilt and a stale library is never loaded. ``ptxas`` reports each
kernel's registers, shared memory and spills (``-Xptxas -v``); the
report is kept beside the library and read by ``ptxas_usage``.
Nothing is built when a module is imported: the first call that needs a
kernel builds it. A missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("window_agg", "flash_attention_sm90", "flash_attention_sm90_f32",
           "flash_attention_bwd_sm90", "ssd_scan", "ssd_scan_bwd_sm90",
           "moe_dispatch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the "
                       "port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together; returns name → library path."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.is_file()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        # write to a private name, then rename: a concurrent build never
        # sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode == 0:
            todo[n].with_suffix(".ptxas.txt").write_text(log)
            os.replace(tmp, todo[n])
        else:
            os.unlink(tmp)
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    return paths


def ptxas_usage(name: str) -> Dict[str, Dict[str, int]]:
    """Kernel → its registers, static shared memory and spill bytes, from
    ptxas's report on the built library of ``csrc/<name>.cu``. Kernel
    names are always demangled, by ``c++filt`` (binutils, which nvcc's host
    compiler needs), to the function and its template arguments, so that
    they read the same wherever the library was built."""
    text = library_path(name).with_suffix(".ptxas.txt").read_text()
    usage, kernel = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
            usage[kernel] = {"registers": 0, "smem_bytes": 0,
                             "spill_stores": 0, "spill_loads": 0}
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[kernel]["spill_stores"] = int(m.group(1))
            usage[kernel]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[kernel]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            usage[kernel]["smem_bytes"] = int(m.group(1)) if m else 0
    if not usage:
        return usage
    cxxfilt = shutil.which("c++filt")
    if cxxfilt is None:
        raise RuntimeError("c++filt not found on PATH: ptxas's kernel names "
                           "cannot be demangled")
    names = subprocess.run([cxxfilt], input="\n".join(usage),
                           capture_output=True, text=True,
                           check=True).stdout.split("\n")
    return {re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", new): v
            for new, v in zip(names, usage.values())}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built on first use)."""
    return ctypes.CDLL(str(build([name])[name]))
