"""Build the port's native sources at first use and load them with ctypes.

Each source has a plain C interface. ``csrc/<name>.cu`` (a CUDA kernel) is
compiled by ``nvcc`` alone (no PyTorch headers, so a build takes seconds);
``csrc/<name>.cc`` (host code: the JPEG codec) by the host C++ compiler
(``$CXX``, else ``c++`` or ``g++`` on PATH: the one ``nvcc`` itself
uses), with ``HOST_CXX_FLAGS`` and no library linked. The result is ``lib<name>-<hash>.so`` under
``BUILD_DIR``, where the hash covers the source and the flags: an edited
source is rebuilt, an unchanged one is reused. ``BUILD_DIR`` is
``build/torch_kernels/`` at the root of the checkout, or ``build/`` inside
the package when it is installed outside one. A failed build raises with
the compiler's output; there is no fallback. Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
_CHECKOUT = PACKAGE_DIR.parent
BUILD_DIR = (
    _CHECKOUT / "build" / "torch_kernels"
    if (_CHECKOUT / "pyproject.toml").exists()
    else PACKAGE_DIR / "build"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the build log
)

HOST_CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: on PATH, under $CUDA_HOME, or in the
    toolkit's default install location."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def host_compiler() -> str:
    """The C++ compiler for a host ``.cc`` source: ``$CXX``, or ``c++`` or
    ``g++`` on PATH."""
    for found in (os.environ.get("CXX"), shutil.which("c++"), shutil.which("g++")):
        if found:
            return found
    raise RuntimeError("no C++ compiler found ($CXX, c++ or g++ on PATH): the host sources cannot be built")


def source_path(name: str) -> Path:
    for suffix in (".cu", ".cc"):
        path = CSRC_DIR / f"{name}{suffix}"
        if path.exists():
            return path
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cc")


def compile_command(name: str, out: Path) -> List[str]:
    src = source_path(name)
    compiler = [nvcc(), *NVCC_FLAGS] if src.suffix == ".cu" else [host_compiler(), *HOST_CXX_FLAGS]
    return [*compiler, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    src = source_path(name)
    flags = NVCC_FLAGS if src.suffix == ".cu" else HOST_CXX_FLAGS
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` or ``.cc`` unless an up-to-date library
    exists; raises with the compiler's output if the build fails."""
    path = library_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    command = compile_command(name, tmp)
    proc = subprocess.run(command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    (BUILD_DIR / f"{name}.log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(command[0]).name} failed for {source_path(name).name} "
                           f"(rc={proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, path)  # atomic: concurrent builders never see half a file
    return path


def build_log(name: str) -> str:
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cc``, built first if
    needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib
