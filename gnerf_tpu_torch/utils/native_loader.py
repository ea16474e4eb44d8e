"""ctypes binding for the native C++ image-loading runtime.

A copy of `gnerf_tpu/utils/native_loader.py` (ctypes and numpy only), so
both packages decode and resize a photo to the same pixels.
`native/libgnerf_loader.so` (built by `make -C native`) provides a
thread-pool JPEG/PNG decoder + resizer writing CHW uint8 batches directly
into numpy buffers: a box average when it shrinks, a bilinear with its own
rounding when it enlarges. Without the library, the JAX package's PIL
fallback (bilinear) is the behaviour of both."""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "libgnerf_loader.so",
)


def _load_lib():
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.loader_get_batch.restype = ctypes.c_int64
    lib.loader_get_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.decode_image.restype = ctypes.c_int
    lib.decode_image.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib


_LIB = _load_lib()


def native_available() -> bool:
    return _LIB is not None


class NativeImageLoader:
    """Decode batches of image files to [N, 3, H, W] uint8 with a C++
    thread pool; PIL fallback when the native library is absent."""

    def __init__(self, paths: Sequence[str], out_h: int, out_w: int,
                 threads: int = 4):
        self.paths = [os.fspath(p) for p in paths]
        self.out_h = out_h
        self.out_w = out_w
        self._handle = None
        if _LIB is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths]
            )
            self._keepalive = arr
            self._handle = _LIB.loader_create(
                arr, len(self.paths), threads, out_h, out_w
            )

    def get_batch(self, indices: Sequence[int],
                  flips: Optional[Sequence[bool]] = None) -> np.ndarray:
        n = len(indices)
        out = np.empty((n, 3, self.out_h, self.out_w), dtype=np.uint8)
        if self._handle is not None:
            idx = (ctypes.c_int64 * n)(*[int(i) for i in indices])
            fl = None
            if flips is not None:
                fl = (ctypes.c_uint8 * n)(*[1 if f else 0 for f in flips])
            _LIB.loader_get_batch(
                self._handle, idx, fl, n,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
            return out
        # PIL fallback.
        from PIL import Image

        for j, i in enumerate(indices):
            img = Image.open(self.paths[i % len(self.paths)]).convert("RGB")
            if img.size != (self.out_w, self.out_h):
                img = img.resize((self.out_w, self.out_h), Image.BILINEAR)
            a = np.asarray(img)
            if flips is not None and flips[j]:
                a = a[:, ::-1]
            out[j] = a.transpose(2, 0, 1)
        return out

    def __del__(self):
        if self._handle is not None and _LIB is not None:
            _LIB.loader_destroy(self._handle)
            self._handle = None


def decode_image(path: str, out_h: int, out_w: int) -> np.ndarray:
    """One-shot native decode to [3, H, W] uint8 (PIL fallback)."""
    if _LIB is not None:
        out = np.empty((3, out_h, out_w), dtype=np.uint8)
        rc = _LIB.decode_image(
            path.encode(), out_h, out_w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc == 0:
            return out
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != (out_w, out_h):
        img = img.resize((out_w, out_h), Image.BILINEAR)
    return np.asarray(img).transpose(2, 0, 1).copy()
