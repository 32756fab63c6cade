"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``kernels/csrc/<name>.cu`` has a plain C interface (no PyTorch
headers), so ``nvcc`` compiles it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o lib<name>-<hash>.so <name>.cu

The library is built at first use into ``kernels/_build/`` (listed in
``.gitignore``), named by a hash of its source, the shared headers
(``csrc/*.cuh``) and its flags, so an edited source is rebuilt and an
unchanged one is reused.  :func:`build_all` starts one ``nvcc`` per
source at once.  Pointers are passed as ``c_void_p``, and each C entry
point returns ``cudaGetLastError()`` after its launch; :func:`launch`
calls it on the tensors' card and stream and raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: flags for one source on top of NVCC_FLAGS.  The bf16 attention
#: kernels keep their output accumulator in registers, and the scans their
#: state, so ptxas refuses a build of them that spills.
_NO_SPILLS = ("-Xptxas", "-warn-spills,-Werror")
SOURCE_FLAGS = {name: _NO_SPILLS for name in (
    "flash_attention", "paged_attention", "rglru_scan", "rwkv6_scan")}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ``nvcc``'s output (``-Xptxas -v``: registers, shared memory, spills)
#: for each library built by this process
build_logs: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """A kernel library could not be built or loaded."""


def find_nvcc() -> Optional[str]:
    """``nvcc`` from ``CUDA_HOME``/``CUDA_PATH``, the PATH, or the
    toolkit's standard install prefix; None when there is none."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return shutil.which("nvcc")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _target(name: str) -> Path:
    # the shared headers (csrc/*.cuh) are part of every source
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str, nvcc: str) -> subprocess.Popen:
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    return subprocess.Popen(
        [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    build_logs[name] = log
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Build every missing library, one ``nvcc`` per source in parallel.

    Returns ``{name: library path}``.  Raises :class:`KernelBuildError`
    when there is no ``nvcc`` or a compile fails.
    """
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        todo = [n for n in names if not _target(n).exists()]
        if todo:
            nvcc = find_nvcc()
            if nvcc is None:
                raise KernelBuildError(
                    "no nvcc found (set CUDA_HOME); the CUDA kernels "
                    f"{todo} cannot be built")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs = {n: _start(n, nvcc) for n in todo}
            errors = []
            for n, proc in procs.items():
                try:
                    _finish(n, proc)
                except KernelBuildError as e:
                    errors.append(str(e))
            if errors:
                raise KernelBuildError("\n".join(errors))
    return {n: _target(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build_all([name])[name]
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            _libs[name] = lib
    return lib


def launch(fn, device, *args) -> None:
    """Call the C entry point ``fn(*args, stream)`` with ``device``'s
    current stream, on that card, and raise if the launch failed.  The
    stream is passed as its raw handle: ``torch.cuda.current_stream()``
    builds a Stream object on every call, several µs of host time."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):   # launch on the tensor's card
            err = fn(*args, stream)
    check(err, fn.__name__)


def refuse_grad(wrapper, *tensors) -> None:
    """Raise where autograd would record a kernel launch.  The kernels
    have no backward, and an output filled over ``ctypes`` carries no
    ``grad_fn``: a launch under grad mode on an input that requires grad
    would silently drop every gradient through it.  Under
    ``torch.no_grad()`` and in inference mode this passes."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{wrapper.__name__}: the CUDA kernel has no backward, and an "
            f"input requires grad; differentiate through the plain version "
            f"(attention_impl='reference') or launch under torch.no_grad()")


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``.  Wrappers are called from many
    client threads at once, so the read-modify-write holds a lock."""
    with _count_lock:
        wrapper.launches += 1
