"""Build of the metok C++ extension at first use.

g++ compiles the single source file into a shared library with a plain C
interface (consumed via ctypes). The library lands in the package's ignored
build directory, named by a hash of the source, so an edited source is
rebuilt and a stale binary is never loaded.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading

_SRC = os.path.join(os.path.dirname(__file__), "src", "metok.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "build")
_LOCK = threading.Lock()


def build_metok() -> str:
    """Compile metok.cpp into a shared library if needed; return its path."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"metok-{digest}.so")
    with _LOCK:
        if os.path.exists(lib):
            return lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-std=c++17", "-O3", "-fPIC", "-shared",
                        "-o", tmp, _SRC], check=True, capture_output=True,
                       text=True)
        os.replace(tmp, lib)
        return lib
