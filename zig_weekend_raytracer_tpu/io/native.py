"""ctypes bindings to the native C++ runtime pieces (``native/``).

The reference ships native components for exactly two jobs: parallel mmap'd
file output (src/writer/writer.zig + src/writer/mmap.zig) and stb-based
image decode (libs/zstbi).  Their equivalents here are ``libzwrt_native.so``
(built from native/ with g++ at first use, into native/build/ under a
name that hashes the sources) exposing:

  * zwrt_write_ppm(path, u8* pixels, w, h, n_threads) -> int
  * zwrt_decode_image(bytes, len, out_w, out_h, out_c) -> u8*  (stb_image)
  * zwrt_free(ptr)

Binding is via ctypes (no pybind11 in the environment).  Everything degrades
gracefully to pure-Python fallbacks when the library hasn't been built;
``python -m zig_weekend_raytracer_tpu.io.native`` builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

log = logging.getLogger("zwrt")

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native")
)
_SOURCES = (
    os.path.join(_NATIVE_DIR, "zwrt_native.cpp"),
    os.path.join(_NATIVE_DIR, "third_party", "stb", "stb_image.h"),
)
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _source_hash() -> str:
    """Hash of the compiler flags and every source file: the library's
    name, so an edited source always builds a new library."""
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    for path in _SOURCES:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def lib_path() -> str:
    """Path of the library built from the current sources."""
    return os.path.join(_BUILD_DIR, f"libzwrt_native-{_source_hash()}.so")


def build(force: bool = False) -> bool:
    """Compile the native library with g++ unless the library for the
    current sources exists.  The compiler writes a temporary file that is
    renamed into place, so concurrent builders never load a partial one."""
    out = lib_path()
    if not force and os.path.exists(out):
        return True
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *_CXX_FLAGS, "-o", tmp, _SOURCES[0]]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        msg = getattr(e, "stderr", str(e))
        log.warning("native build failed, using Python fallbacks: %s", msg)
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not build():
            return None
        try:
            lib = ctypes.CDLL(lib_path(), use_errno=True)
        except OSError as e:
            log.warning("failed to load native lib: %s", e)
            return None
        lib.zwrt_write_ppm.restype = ctypes.c_int
        lib.zwrt_write_ppm.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ]
        lib.zwrt_decode_image.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.zwrt_decode_image.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.zwrt_free.restype = None
        lib.zwrt_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def write_ppm(path: str, pixels_u8: np.ndarray, n_threads: int = 0) -> None:
    lib = _load()
    assert lib is not None
    h, w, c = pixels_u8.shape
    assert c == 3
    buf = np.ascontiguousarray(pixels_u8)
    ctypes.set_errno(0)
    rc = lib.zwrt_write_ppm(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w, h, n_threads,
    )
    if rc != 0:
        # rc identifies the failing stage (native/zwrt_native.cpp); errno
        # carries the underlying syscall failure
        stage = {-1: "open", -2: "ftruncate", -3: "mmap"}.get(rc, "write")
        err = ctypes.get_errno()
        detail = f": {os.strerror(err)}" if err else ""
        raise OSError(
            err, f"native PPM write failed at {stage} (rc={rc}){detail}: "
            f"{path}"
        )


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """Decode JPG/PNG bytes to (H, W, 3) u8 via the vendored stb_image."""
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    arr = np.frombuffer(data, np.uint8)
    ptr = lib.zwrt_decode_image(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        arr.size, ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
    )
    if not ptr:
        return None
    try:
        n = w.value * h.value * 3
        out = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
        return out.reshape(h.value, w.value, 3)
    finally:
        lib.zwrt_free(ptr)


if __name__ == "__main__":
    ok = build(force=True)
    print("native build:", "ok" if ok else "FAILED", "->", lib_path())
