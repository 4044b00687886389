"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``src/repro_torch/csrc/*.cu`` file exposes a plain C interface and is
compiled on its own into ``build/torch_kernels/lib<name>-<digest>.so`` at
the repository root, for ``sm_90a`` (Hopper).  The digest covers the source,
every shared header (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and an unchanged one reused.
Nothing here runs at import: a host without ``nvcc`` imports this module
fine, and only a CUDA launch needs the library.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where ``lib<name>`` is built: named by a digest of its source, of
    every header in ``csrc`` (any source may include any of them) and of
    the flags."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _compile(jobs: dict) -> dict[str, str]:
    """``jobs``: key -> (source, library); one ``nvcc`` each, all started
    together, each library written whole or not at all.  Returns each
    key's compiler log.  Raises if any compile fails."""
    nvcc = _nvcc()
    procs = {}
    for key, (src, out) in jobs.items():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for key, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[key] = log
        if proc.returncode != 0:
            failed.append(f"{key} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def build(names=None) -> dict[str, str]:
    """Compile the named sources (all by default), one ``nvcc`` each, all
    started together.  Returns each source's compiler log (``ptxas -v``:
    registers, shared memory, spills).  Raises if any compile fails."""
    names = sources() if names is None else list(names)
    return _compile({name: (CSRC / f"{name}.cu", library_path(name))
                     for name in names})


def build_variants(paths) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Other sources (a probe's microkernel, an uncommitted form of a
    kernel) built as ``build`` builds the kernels, all at once, into
    ``build/torch_kernels/variants``: file name -> (loaded library,
    compiler log)."""
    jobs = {}
    for path in map(Path, paths):
        tag = hashlib.sha1(str(path.resolve()).encode()).hexdigest()[:12]
        jobs[path.name] = (path, BUILD_DIR / "variants" /
                           f"lib{path.stem}-{tag}.so")
    logs = _compile(jobs)
    return {key: (ctypes.CDLL(str(out)), logs[key])
            for key, (_, out) in jobs.items()}


@contextlib.contextmanager
def library_swapped(name: str, lib: ctypes.CDLL):
    """Within the block, ``function(name, ...)`` resolves in ``lib`` (a
    library from ``build_variants``), so a wrapper launches that form."""
    saved = _LIBS.get(name)
    _LIBS[name] = lib
    try:
        yield
    finally:
        if saved is None:
            _LIBS.pop(name)
        else:
            _LIBS[name] = saved


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C function ``symbol`` of ``lib<name>``, building it on first use,
    with its ``argtypes`` and ``restype`` declared."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn
