"""Build and load of the port's CUDA kernels (`edgerunner_tpu_torch/csrc`).

Each `csrc/*.cu` is compiled by its own `nvcc` process, all started
together, for `sm_90a`, and the objects are linked into one shared library
with a plain C interface, loaded with ctypes. The library lands in the
package's ignored build directory under a name keyed by a hash of the
sources and flags, at first use; nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_lib = None
# what nvcc reported for the last build: seconds and ptxas register lines
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, k, v, o, lse, q_len, kv_len, B, N, M, H, D, dtype, causal, stream
    "flash_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, out, part_o, part_m, part_l, B, L, H, D, index, chunk, dtype, stream
    "decode_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(out_dir: str) -> str:
    """nvcc every source into out_dir in parallel, link, return the .so."""
    import time

    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = os.path.join(out_dir, os.path.basename(src) + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        procs.append((obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    ptxas, objs, failed = [], [], []
    for obj, cmd, p in procs:
        out, err = p.communicate()
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}{err}")
        ptxas += [ln.strip() for ln in (out + err).splitlines()
                  if "registers" in ln or "spill" in ln]
        objs.append(obj)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    lib = os.path.join(out_dir, "libedgerunner_kernels.so")
    subprocess.run([nvcc, "-shared", "-o", lib, *objs], check=True,
                   capture_output=True, text=True)
    build_info.update(seconds=time.perf_counter() - t0, ptxas=ptxas)
    return lib


def load_library():
    """The kernels' ctypes library, built at first use."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        out_dir = os.path.join(BUILD_DIR, f"kernels-{_digest()}")
        lib_path = os.path.join(out_dir, "libedgerunner_kernels.so")
        if not os.path.exists(lib_path):
            tmp = f"{out_dir}.{os.getpid()}.tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            _compile(tmp)
            shutil.rmtree(out_dir, ignore_errors=True)
            os.replace(tmp, out_dir)
        lib = ctypes.CDLL(lib_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, name: str):
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
