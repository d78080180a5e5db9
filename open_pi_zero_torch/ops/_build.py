"""Build the port's CUDA source at first use and load it with ctypes.

``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
alone (no PyTorch headers, so a build takes seconds) into
``lib<name>-<hash>.so`` under ``BUILD_DIR``, where the hash covers the
source and the flags: an edited source is rebuilt, an unchanged one is
reused. ``BUILD_DIR`` is ``build/torch_kernels/`` at the root of the
checkout, or ``build/`` inside the package when it is installed outside
one. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

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


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    raises with the compiler's output if the build fails."""
    path = library_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    (BUILD_DIR / f"{name}.log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc={proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, path)  # atomic: concurrent builders never see half a file
    return path


def build_log(name: str) -> str:
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib
