"""Native (C++) runtime components, bound via ctypes.

The compute path is JAX/XLA; the runtime around it uses native code
where the reference does: here, an asynchronous snapshot writer replaces
the reference's MPI-IO collective output (src/polargrid.cpp:135-186) so
disk I/O overlaps with device compute.

The shared library is built on first use with the system g++; when no
compiler is available, callers fall back to synchronous numpy writes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

_HERE = Path(__file__).parent
_LIB_PATH = _HERE / "libasyncwriter.so"
_lib = None


def _stale() -> bool:
    """True when the library is missing or older than its source (a
    library left from another tree or an older source is rebuilt)."""
    src = _HERE / "async_writer.cpp"
    return (not _LIB_PATH.exists()
            or src.stat().st_mtime > _LIB_PATH.stat().st_mtime)


def _build() -> bool:
    src = _HERE / "async_writer.cpp"
    # build beside the target and rename into place, so concurrent
    # processes never load a half-written library
    tmp = _LIB_PATH.with_name(f".{_LIB_PATH.name}.{os.getpid()}")
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-pthread", str(src),
             "-o", str(tmp)],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return False


def load_library():
    """Load (building if missing or stale) the native library, or return
    None."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.awriter_create.restype = ctypes.c_void_p
    lib.awriter_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_void_p, ctypes.c_size_t]
    lib.awriter_flush.argtypes = [ctypes.c_void_p]
    lib.awriter_errors.argtypes = [ctypes.c_void_p]
    lib.awriter_errors.restype = ctypes.c_long
    lib.awriter_bytes_written.argtypes = [ctypes.c_void_p]
    lib.awriter_bytes_written.restype = ctypes.c_longlong
    lib.awriter_pending.argtypes = [ctypes.c_void_p]
    lib.awriter_pending.restype = ctypes.c_size_t
    lib.awriter_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class AsyncFileWriter:
    """Background-thread file writer; falls back to synchronous writes when
    the native library is unavailable."""

    def __init__(self):
        self._lib = load_library()
        self._handle = self._lib.awriter_create() if self._lib else None

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def write(self, path, array):
        import numpy as np
        data = np.ascontiguousarray(array, dtype=np.float64)
        if self._handle is None:
            data.tofile(path)
            return
        buf = data.tobytes()   # snapshot copy; the C++ side copies again
        self._lib.awriter_submit(self._handle, str(path).encode(),
                                 buf, len(buf))

    def flush(self):
        if self._handle is not None:
            self._lib.awriter_flush(self._handle)

    @property
    def errors(self) -> int:
        if self._handle is None:
            return 0
        return int(self._lib.awriter_errors(self._handle))

    def close(self):
        if self._handle is not None:
            self._lib.awriter_flush(self._handle)
            self._lib.awriter_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
