"""metok, the port's copy of the EdgeBreaker-family mesh <-> token codec.

`src/metok.cpp` is a copy of the JAX package's C++17 source (its code
unchanged), bound through ctypes (reference API: meto/meto/__init__.py:21-50):

    eng = Engine(discrete_bins=512, backend="LR_ABSCO")
    tokens, face_order, face_type = eng.encode(vertices, faces)
    vertices, faces, face_type = eng.decode(tokens)

Vocabulary layout (before the +3 model-level special-token offset):
    LR_ABSCO: {L=0, R=1, BOM=2} ++ absolute coords in [3, 3+bins)
    LR:       {L=0, R=1, BOM=2} ++ residual coords in [3, 3+2*bins)
    CLERS:    {C..EOM=0..6}     ++ residual coords in [7, 7+4*bins)
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from .build import build_metok

_BACKENDS = {"LR_ABSCO": 0, "LR": 1, "CLERS": 2}
_LIB_LOCK = threading.Lock()
_lib = None


def _load():
    global _lib
    with _LIB_LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build_metok())
        ip = ctypes.POINTER(ctypes.c_int)
        fp = ctypes.POINTER(ctypes.c_float)
        lib.metok_encode.restype = ctypes.c_void_p
        lib.metok_encode.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     fp, ctypes.c_int, ip, ctypes.c_int]
        lib.metok_decode.restype = ctypes.c_void_p
        lib.metok_decode.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ip, ctypes.c_int]
        for name, rtype in [("metok_get_tokens", ip),
                            ("metok_get_face_order", ip),
                            ("metok_get_face_type", ip),
                            ("metok_get_faces", ip),
                            ("metok_get_verts", fp)]:
            fn = getattr(lib, name)
            fn.restype = rtype
            fn.argtypes = [ctypes.c_void_p, ip]
        lib.metok_decimate.restype = ctypes.c_void_p
        lib.metok_decimate.argtypes = [fp, ctypes.c_int, ip, ctypes.c_int, ctypes.c_int]
        lib.metok_free.restype = None
        lib.metok_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _read_ints(fn, handle):
    n = ctypes.c_int(0)
    ptr = fn(handle, ctypes.byref(n))
    if n.value == 0:
        return np.empty((0,), dtype=np.int64)
    return np.ctypeslib.as_array(ptr, shape=(n.value,)).astype(np.int64)


class Engine:
    """Mesh <-> token codec (reference: meto/meto/__init__.py:21-50)."""

    def __init__(self, discrete_bins: int, verbose: bool = False,
                 backend: str = "LR_ABSCO"):
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.discrete_bins = int(discrete_bins)
        self.verbose = bool(verbose)
        self.backend = backend
        self._backend_id = _BACKENDS[backend]
        if backend == "LR_ABSCO":
            self.num_base_tokens = self.discrete_bins
            self.num_special_tokens = 3
        elif backend == "LR":
            self.num_base_tokens = self.discrete_bins * 2
            self.num_special_tokens = 3
        else:  # CLERS: residuals offset by +2*bins reach 4*bins
            self.num_base_tokens = self.discrete_bins * 4
            self.num_special_tokens = 7
        self.num_tokens = self.num_base_tokens + self.num_special_tokens

    def encode(self, vertices, faces):
        """vertices: [N,3] float in [-1,1]; faces: [M,3] int.

        Returns (tokens, face_order, face_type) int64 arrays.
        """
        lib = _load()
        v = np.ascontiguousarray(vertices, dtype=np.float32)
        f = np.ascontiguousarray(faces, dtype=np.int32)
        if v.ndim != 2 or v.shape[1] != 3:
            raise ValueError(f"bad vertices shape {v.shape}")
        if f.ndim != 2 or f.shape[1] != 3:
            raise ValueError(f"bad faces shape {f.shape}")
        handle = lib.metok_encode(
            self._backend_id, self.discrete_bins, int(self.verbose),
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), v.shape[0],
            f.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), f.shape[0])
        try:
            tokens = _read_ints(lib.metok_get_tokens, handle)
            face_order = _read_ints(lib.metok_get_face_order, handle)
            face_type = _read_ints(lib.metok_get_face_type, handle)
        finally:
            lib.metok_free(handle)
        return tokens, face_order, face_type

    def decode(self, tokens):
        """tokens: [T] int. Returns (vertices [N,3] f32, faces [M,3] i64,
        face_type)."""
        lib = _load()
        t = np.ascontiguousarray(tokens, dtype=np.int32)
        handle = lib.metok_decode(
            self._backend_id, self.discrete_bins, int(self.verbose),
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), t.shape[0])
        try:
            verts, faces = _read_mesh(lib, handle)
            face_type = _read_ints(lib.metok_get_face_type, handle)
        finally:
            lib.metok_free(handle)
        return verts, faces, face_type


def _read_mesh(lib, handle):
    """(vertices [N,3] f32, faces [M,3] i64) held by a metok handle."""
    nv = ctypes.c_int(0)
    vp = lib.metok_get_verts(handle, ctypes.byref(nv))
    verts = (np.ctypeslib.as_array(vp, shape=(nv.value, 3)).astype(np.float32)
             if nv.value else np.empty((0, 3), np.float32))
    nf = ctypes.c_int(0)
    fp = lib.metok_get_faces(handle, ctypes.byref(nf))
    faces = (np.ctypeslib.as_array(fp, shape=(nf.value, 3)).astype(np.int64)
             if nf.value else np.empty((0, 3), np.int64))
    return verts, faces


def decimate(vertices, faces, target_faces: int):
    """Quadric-error-metric edge-collapse decimation (C++), the counterpart
    of edgerunner_tpu/tokenizer/__init__.py:152-180: greedy collapses ordered
    by Garland-Heckbert quadric cost until the face count reaches
    target_faces. Returns (vertices f32, faces i64)."""
    lib = _load()
    v = np.ascontiguousarray(vertices, dtype=np.float32)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"bad mesh shapes {v.shape}, {f.shape}")
    handle = lib.metok_decimate(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), v.shape[0],
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), f.shape[0], int(target_faces))
    try:
        return _read_mesh(lib, handle)
    finally:
        lib.metok_free(handle)


__all__ = ["Engine", "build_metok", "decimate"]
