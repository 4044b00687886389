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


def build(names=None) -> dict[str, str]:
    """Compile the named sources (all by default), one ``nvcc`` each, all
    started together.  Returns each source's compiler log (``ptxas -v``:
    registers, shared memory, spills).  Raises if any compile fails."""
    names = sources() if names is None else list(names)
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


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
