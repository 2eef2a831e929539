"""Build of the port's CUDA kernels: every ``csrc/*.cu`` into one shared
library with a plain C interface, loaded with ``ctypes``.

The sources compile in parallel, one ``nvcc -c`` per ``.cu`` file, all
started together -- so the build time is that of the slowest source, not
the sum, and stays inside ``chip_smoke.py``'s time limit as kernels are
added -- and link into one library under the ignored
``build/repro_torch_kernels/``.  The library's name carries a hash of every
source and header under ``csrc/`` and of the flags, so an edit rebuilds and
an unchanged tree loads what is there.  Nothing builds or loads at import
time: :func:`load` runs at a wrapper's first launch on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None


class Build(NamedTuple):
    """The built library.  ``logs`` maps each source to what
    ``nvcc -Xptxas -v`` printed for it (registers, shared memory, spills)
    and ``seconds`` to its compile time; both are empty when the library
    was already built (:func:`compiler_logs` reads the logs back)."""
    path: Path
    logs: Dict[str, str]
    seconds: Dict[str, float]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's kernels are built with the "
                       "CUDA toolkit at first use on a GPU machine")


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, src: Path, out: Path, kind: str):
    """``nvcc`` on one source (``kind``: ``-c`` or ``-shared``); the
    finished process, its output in ``stdout``, and the seconds taken."""
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, kind, "-o", str(out), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    return proc, time.perf_counter() - t0


def build() -> Build:
    """Compile every kernel source and link the library, once per hash of
    the sources and flags; raises with the compiler's output on failure."""
    lib = BUILD_DIR / f"repro_torch_kernels-{_key()}.so"
    if lib.exists():
        return Build(lib, {}, {})
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        with ThreadPoolExecutor(len(sources)) as pool:
            done = list(pool.map(lambda src, obj: _compile(nvcc, src, obj,
                                                           "-c"),
                                 sources, objs))
        logs = {src.name: proc.stdout for src, (proc, _) in zip(sources, done)}
        seconds = {src.name: t for src, (_, t) in zip(sources, done)}
        failed = [src.name for src, (proc, _) in zip(sources, done)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[n] for n in failed))
        out = Path(tmp) / lib.name
        proc = subprocess.run([nvcc, "-shared", "-o", str(out),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {lib.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        lib.with_suffix(".logs.json").write_text(json.dumps(logs))
        os.replace(out, lib)
    return Build(lib, logs, seconds)


def compiler_logs() -> Dict[str, str]:
    """What ``nvcc -Xptxas -v`` printed for each source of the library that
    :func:`build` made from this tree (registers, shared memory, spills)."""
    lib = build().path
    return json.loads(lib.with_suffix(".logs.json").read_text())


def build_each(sources: Dict[str, Path],
               out_dir: Path) -> Dict[str, Tuple[ctypes.CDLL, str]]:
    """Each source alone into a shared library of its own under
    ``out_dir``, all compiled in parallel -- e.g. an earlier version of a
    kernel, to be held against the port's in one process.  Returns each
    name's loaded library and what ``nvcc -Xptxas -v`` printed for it;
    raises with the compiler's output on failure."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    outs = {name: out_dir / f"{name}.so" for name in sources}
    with ThreadPoolExecutor(len(sources)) as pool:
        done = dict(zip(sources, pool.map(
            lambda name: _compile(nvcc, sources[name], outs[name],
                                  "-shared")[0], sources)))
    for name, proc in done.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {sources[name]}:\n"
                               f"{proc.stdout}")
    return {name: (ctypes.CDLL(str(outs[name])), proc.stdout)
            for name, proc in done.items()}


def load() -> ctypes.CDLL:
    """The kernel library, built at the first call of the process."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build().path))
    return _lib
