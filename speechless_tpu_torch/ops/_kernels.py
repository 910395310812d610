"""Build-at-first-use loader for the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C entry point and is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``build/speechless_tpu_torch_kernels/<name>-<hash>.so`` beside the
package, then loaded with `ctypes` (each load is logged). The file name carries a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited kernel or
header is rebuilt and never confused with a stale library. Nothing is built or loaded at
import: the CPU tests import every module without a CUDA toolkit.
"""
import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SOURCE_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "speechless_tpu_torch_kernels"
# No --use_fast_math: expf/log1pf must match torch's CUDA logaddexp bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point of each source: argument types (pointers and the stream as c_void_p).
SIGNATURES = {
    "lm_beam_span": [_P] * 31 + [_I] * 15 + [_F] * 3 + [_P],
    "lm_beam_step": [_P] * 15 + [_I] * 10 + [_P],
    "beam_backtrace": [_P] * 5 + [_I] * 5 + [_P],
    "prefix_beam": [_P] * 7 + [_I] * 10 + [_F, _P],
    "ctc_alpha": [_P] * 7 + [_I] * 4 + [_P],
    "ctc_beta_grad": [_P] * 10 + [_I] * 4 + [_P],
    "stream_stitch": [_P] * 9 + [_I] * 4 + [_P],
    "conv_dgrad": [_P] * 4 + [_I] * 7 + [_P],
    "rel_attention": [_P] * 20 + [_I] * 4 + [_P],
}

_lock = threading.Lock()
_functions = {}
builds = {}  # name -> {"seconds": build time (0 when reused), "log": nvcc output, "path"}
_log = logging.getLogger(__name__)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for candidate in ((Path(cuda_home) / "bin" / "nvcc") if cuda_home else None,
                      shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if candidate and Path(candidate).exists():
            return str(candidate)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    """The library's path: its name carries a hash of the source, every header of
    ``csrc/`` it may include, and the flags."""
    digest = hashlib.sha1((SOURCE_DIR / (name + ".cu")).read_bytes())
    for header in sorted(SOURCE_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / "{}-{}.so".format(name, digest.hexdigest()[:16])


def _build_many(names) -> None:
    """Build every missing library of ``names``: one nvcc per source, all started
    together. Raises if any build fails."""
    started = {}
    for name in names:
        target = _target(name)
        if target.exists():
            builds[name] = {"seconds": 0.0, "log": "reused {}".format(target), "path": target}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        partial = target.with_name("{}.{}.tmp".format(target.name, os.getpid()))
        command = [_nvcc(), *NVCC_FLAGS, "-o", str(partial), str(SOURCE_DIR / (name + ".cu"))]
        started[name] = (target, partial, time.perf_counter(),
                         subprocess.Popen(command, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (target, partial, start, process) in started.items():
        log = process.communicate()[0]
        if process.returncode != 0:
            failures.append("nvcc failed to build {}:\n{}".format(name + ".cu", log))
            continue
        os.replace(partial, target)  # atomic: concurrent builders never load a partial file
        builds[name] = {"seconds": time.perf_counter() - start, "log": log, "path": target}
    if failures:
        raise RuntimeError("\n".join(failures))


def build_all() -> None:
    """Build (or find) every kernel's library in parallel, before the first call needs
    them."""
    with _lock:
        _build_many(list(SIGNATURES))


def function(name: str):
    """The ctypes entry point ``name`` of ``csrc/<name>.cu``, built on first use. Its C
    function returns the ``cudaError_t`` of the launch (0 on success)."""
    with _lock:
        if name not in _functions:
            _build_many([name])
            entry = getattr(ctypes.CDLL(str(builds[name]["path"])), name)
            entry.argtypes = SIGNATURES[name]
            entry.restype = ctypes.c_int
            _functions[name] = entry
            _log.info("loaded kernel %s from %s (built in %.2f s)", name,
                      Path(builds[name]["path"]).name, builds[name]["seconds"])
        return _functions[name]
