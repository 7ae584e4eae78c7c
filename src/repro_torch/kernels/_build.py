"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``kernels/*/csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain C interface.  The library goes
to ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``); its file name carries a hash of the sources and flags, so
an edited source never loads a stale library.  ``ptxas -v`` reports each
kernel's registers, shared memory and spills; the report is kept beside
the library (:func:`resource_usage`).  A failed build raises: nothing
falls back to the plain versions.
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

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources():
    """The CUDA sources of every kernel package, in a stable order."""
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.relative_to(KERNELS_DIR).as_posix().encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sources()
        objs = [Path(tmp) / f"{s.parents[1].name}_{s.stem}.o" for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o",
                                   str(o)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        errors, logs = [], []
        for src, proc in zip(srcs, procs):
            log, _ = proc.communicate()
            logs.append(log)
            if proc.returncode:
                errors.append(f"{src}:\n{log}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared",
                               *map(str, objs), "-o", str(lib)],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        out.with_suffix(".ptxas.txt").write_text("".join(logs))
        os.replace(lib, out)        # atomic: concurrent builds agree


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    out = library_path()
    if not out.exists():
        _build(out)
    return ctypes.CDLL(str(out))


def resource_usage() -> dict:
    """``{kernel: "N registers, ... spill ..."}`` from the ``ptxas -v``
    report of the current library's build."""
    out, name, usage = {}, None, {}
    report = library_path().with_suffix(".ptxas.txt")
    for line in report.read_text().splitlines() if report.exists() else ():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            k = re.search(r"[a-z][a-z0-9_]*_kernel", m.group(1))
            name = k.group(0) if k else m.group(1)
            usage = out.setdefault(name, {})
        elif name and "spill stores" in line:
            usage["spills"] = line.strip()
        elif name and "Used" in line:
            usage["used"] = line.split(":", 1)[1].strip()
    return {k: "; ".join(v[f] for f in ("used", "spills") if f in v)
            for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def bind(name: str, int_args: frozenset, n_args: int):
    """The C entry ``name`` with its ``argtypes`` set: ``c_int`` at the
    argument positions in ``int_args``, ``c_void_p`` (pointers and the
    stream) everywhere else; it returns an int (a launch's CUDA error
    code)."""
    fn = getattr(library(), name)
    fn.argtypes = [ctypes.c_int if i in int_args else ctypes.c_void_p
                   for i in range(n_args)]
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
