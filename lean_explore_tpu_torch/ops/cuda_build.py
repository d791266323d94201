"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``build/torch_kernels/lib<name>.so`` under the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/lib<name>.so csrc/<name>.cu

No PyTorch header is compiled, so a build takes seconds. A library is
rebuilt when a source in ``csrc/`` is newer than it. ``build`` starts one
nvcc per stale source, all at once.
"""

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}


def kernel_names() -> list[str]:
    """Every kernel source in csrc/, by stem."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the default
    toolkit location. Raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for candidate in candidates:
        if candidate.exists():
            return str(candidate)
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin on PATH"
    )


def _is_stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    sources = [CSRC_DIR / f"{name}.cu", *CSRC_DIR.glob("*.cuh")]
    return any(src.stat().st_mtime > built for src in sources)


def build(names: list[str] | None = None, *, force: bool = False) -> dict[str, str]:
    """Compile the named sources (default: all) that are stale, one nvcc
    process each, all started together. Returns {name: compiler output}
    for what was built; raises RuntimeError naming every failed build."""
    names = kernel_names() if names is None else names
    todo = [n for n in names if force or _is_stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.tmp.{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            tmp,
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
        )
    logs, failures = {}, []
    for name, (tmp, proc) in procs.items():
        output, _ = proc.communicate()
        logs[name] = output
        if proc.returncode != 0:
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failures:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failures))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first when stale."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libraries[name] = lib
        return lib
