"""Build the port's CUDA kernels with ``nvcc`` and its host libraries with the
host C++ compiler, and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``<name>-<hash>.so`` for ``sm_90a`` (Hopper). The hash covers every
source under ``csrc/`` and the flags, so an edited source builds anew and an
unchanged one is loaded from the build directory. Nothing is built when a
module is imported: the first launch of a kernel builds its library, and
:func:`build` builds several at once, one ``nvcc`` process each, in parallel.

The build directory is ``twinvoice_tpu_torch/_cuda_build/`` (listed in
``.gitignore``); ``TWINVOICE_TORCH_BUILD_DIR`` moves it.

Host libraries (the QR decoder, ``native/qrdecode.cpp``; the image codec,
``csrc/host_codec.cpp``) are plain C++ built by :func:`build_host` into the
same directory, each keyed by a hash of its one source and the flags.

``launches`` counts kernel launches by name: each op wrapper adds one where it
launches its kernel and nowhere else, so a caller can zero it, drive a path
and see which kernels that path really ran.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
NVCC_TIMEOUT_S = 600
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
CXX_TIMEOUT_S = 300

launches: collections.Counter = collections.Counter()

_libs: dict = {}
_lock = threading.Lock()


def build_dir() -> Path:
    default = Path(__file__).resolve().parent / "_cuda_build"
    return Path(os.environ.get("TWINVOICE_TORCH_BUILD_DIR", default))


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME`` or ``$CUDA_PATH``, else
    ``/usr/local/cuda/bin/nvcc``; raises naming every place it looked."""
    looked = ["PATH"]
    found = shutil.which("nvcc")
    if found:
        return found
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
        else:
            looked.append(f"${var} (unset)")
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        looked.append(path)
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise FileNotFoundError("nvcc not found; looked in: " + ", ".join(looked))


def sources() -> list:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"{name}-{_digest()}.so"


def build(names=None) -> dict:
    """Compile each named kernel (default: all of ``csrc/*.cu``) that is not
    built yet, one ``nvcc`` each, all started together. → {name: .so path}.
    Raises with the compiler's output if any build fails or times out."""
    names = sources() if names is None else list(names)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    out[todo[0]].parent.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = out[n].with_name(f"{out[n].stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            errors.append(f"{n}: nvcc timed out after {NVCC_TIMEOUT_S} s")
            continue
        if proc.returncode != 0:
            errors.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out[n])  # atomic: a concurrent loader sees all or nothing
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib


def find_cxx() -> str:
    """``$CXX``, else ``c++``, ``g++`` or ``clang++`` on ``PATH``."""
    cxx = os.environ.get("CXX")
    if cxx:
        return cxx
    for name in ("c++", "g++", "clang++"):
        found = shutil.which(name)
        if found:
            return found
    raise FileNotFoundError("no C++ compiler: $CXX is unset and none of c++, "
                            "g++, clang++ is on PATH")


def host_library_path(source: Path, stem: str) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(Path(source).read_bytes())
    return build_dir() / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build_host(source: Path, stem: str, what: str) -> Path:
    """Compile the host C++ ``source`` into ``lib<stem>-<hash>.so`` unless it
    is built already. → the library's path. Raises with the compiler's
    output (``"<what> build failed"``) if the build fails."""
    out = host_library_path(source, stem)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [find_cxx(), *CXX_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=CXX_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{what} build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out
