"""Native batched JPEG ingest (``mickey_tpu/data/native.py``).

``csrc/mickey_io.cpp`` decodes a batch of JPEGs with libjpeg, resizes each
bilinearly with half-pixel centres and scales it to [0, 1] float32, into one
(B, H, W, 3) buffer, on a pool of threads: the arithmetic of
``mickey_tpu``'s ingest, so the two give the same bits. It is the loader's
default decode backend (``TRAINING.NATIVE_LOADER``, ``data/loader.py``).

The library has a plain C interface loaded with ``ctypes`` (which releases
the interpreter lock during the call) and is built at first use with
``g++ -O3 -shared -fPIC ... -ljpeg -lpthread`` into ``mickey_tpu_torch/build/``,
named by a hash of the source and the flags. A lock keeps threads from
building it twice, and the build writes a temporary file that ``os.replace``
moves into place, so processes started together (data-parallel ranks) never
load a half-written library. Where it cannot be built (no ``g++``, no
libjpeg) ``ensure_built`` returns None, warns once with the reason, and
``unavailable_reason`` keeps it: the loader then decodes with ``cv2``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "mickey_io.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")

_lib = None
_reason: Optional[str] = None
# the loader's prefetch threads race into ensure_built on first use
_build_lock = threading.Lock()


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmickey_io_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *FLAGS, str(SOURCE), *LIBS, "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {proc.stderr.strip()[-2000:]}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def ensure_built(auto_build: bool = True):
    """The loaded library (building it if needed), or None where it cannot
    be built; the first failure warns with its reason."""
    global _lib, _reason
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None or _reason is not None:
            return _lib
        so = _library_path()
        try:
            if not so.exists():
                if not auto_build:
                    return None
                _build(so)
            lib = ctypes.CDLL(str(so))
        except (OSError, RuntimeError) as e:
            _reason = f"{type(e).__name__}: {e}"
            warnings.warn(f"native JPEG ingest unavailable, decoding with cv2 instead ({_reason})",
                          RuntimeWarning, stacklevel=2)
            return None
        lib.mk_decode_resize_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.mk_decode_resize_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def unavailable_reason() -> Optional[str]:
    """Why the library could not be built, or None (built, or not tried)."""
    return _reason


def decode_resize_batch(jpeg_bytes: List[bytes], width: int, height: int, num_threads: int = 8,
                        out=None) -> Optional[np.ndarray]:
    """Decode, resize and scale a list of JPEG blobs: (B, height, width, 3)
    float32 in [0, 1], an undecodable blob all zeros (with a warning). None
    where the library is unavailable. ``out``, if given, is the caller's
    C-contiguous float32 buffer of that shape (a numpy array or a CPU
    tensor, pinned or not); it is filled and returned."""
    lib = ensure_built()
    if lib is None:
        return None
    n = len(jpeg_bytes)
    shape = (n, int(height), int(width), 3)
    arr = np.empty(shape, np.float32) if out is None else out
    if not isinstance(arr, np.ndarray):
        arr = arr.numpy()  # a CPU tensor's memory; a device tensor raises here
    if arr.shape != shape or arr.dtype != np.float32 or not arr.flags["C_CONTIGUOUS"]:
        raise ValueError(f"out: expected a C-contiguous float32 buffer of shape {shape}, got "
                         f"{arr.dtype} {arr.shape}")
    blobs = list(jpeg_bytes)
    data = (ctypes.c_char_p * n)(*blobs)  # pointers into the bytes objects, which `blobs` keeps alive
    sizes = (ctypes.c_size_t * n)(*(len(b) for b in blobs))
    failures = lib.mk_decode_resize_batch(data, sizes, n, int(width), int(height), int(num_threads),
                                         arr.ctypes.data)
    if failures:
        warnings.warn(f"failed to decode {failures} image(s)", RuntimeWarning, stacklevel=2)
    return arr if out is None else out


def read_batch(paths, width: int, height: int, num_threads: int = 8, out=None) -> Optional[np.ndarray]:
    """Read, decode, resize and scale a batch of JPEG files; (B, H, W, 3)
    float32, or None where the library is unavailable.

    ``num_threads`` is clamped to the host's CPU count: oversubscribing a
    small host is pathological, not just wasteful (on a 1-core VM, 8 decode
    threads measured 15-100x slower than 1 in the JAX package's ingest)."""
    if ensure_built() is None:
        return None
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    threads = max(1, min(num_threads, os.cpu_count() or 1))
    return decode_resize_batch(blobs, width, height, num_threads=threads, out=out)
