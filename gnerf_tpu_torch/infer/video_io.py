"""Video output whose backend is chosen by what can be imported.

Port of `gnerf_tpu/infer/video_io.py`. The backend chain is

  1. imageio + ffmpeg -> H.264 .mp4,
  2. pure-python MJPEG -> .avi (needs PIL for the JPEG frames),
  3. numpy only -> one `.npy` array per frame in `<name>_frames/`.

Unlike the JAX package's writer, the choice is made at construction by
checking that the backend's imports work, so a machine without PIL or
imageio gets the numpy backend instead of failing at the first frame.
All backends share the imageio writer interface (append_data/close).
"""

from __future__ import annotations

import importlib
import os
import struct

import numpy as np

def _imports_work(*modules: str) -> bool:
    try:
        for m in modules:
            importlib.import_module(m)
    except ImportError:
        return False
    return True


def available_backends() -> tuple[str, ...]:
    """The backends whose imports work here, in order of preference."""
    found = []
    if _imports_work("imageio", "imageio_ffmpeg"):
        found.append("ffmpeg")
    if _imports_work("PIL.Image"):
        found.append("mjpeg")
    found.append("npy")
    return tuple(found)


class MJPEGWriter:
    """Motion-JPEG AVI writer in pure python (RIFF 'AVI ' container,
    'MJPG' fourcc, idx1 index). Frames are buffered as JPEG blobs and the
    container is emitted on close() so all chunk sizes are exact."""

    def __init__(self, path: str = None, fps: int = 30, quality: int = 92):
        from PIL import Image  # the backend's one dependency, checked now

        self._image = Image
        self.path = path
        self.fps = int(fps)
        self.quality = quality
        self._frames: list[bytes] = []
        self._size = None  # (w, h)

    def append_data(self, frame) -> None:
        import io

        arr = np.asarray(frame)
        h, w = arr.shape[:2]
        if self._size is None:
            self._size = (w, h)
        elif self._size != (w, h):
            raise ValueError(f"frame size changed: {self._size} -> {(w, h)}")
        buf = io.BytesIO()
        self._image.fromarray(arr).save(buf, format="JPEG", quality=self.quality)
        self._frames.append(buf.getvalue())

    def to_bytes(self) -> bytes:
        """The RIFF/AVI container, assembled in memory."""
        if self._size is None:
            return b""
        w, h = self._size
        n = len(self._frames)

        def chunk(fourcc: bytes, payload: bytes) -> bytes:
            pad = b"\x00" if len(payload) % 2 else b""
            return fourcc + struct.pack("<I", len(payload)) + payload + pad

        def lst(kind: bytes, payload: bytes) -> bytes:
            return chunk(b"LIST", kind + payload)

        max_bytes = max((len(f) for f in self._frames), default=0)
        avih = struct.pack(
            "<14I",
            int(1e6 / max(self.fps, 1)),  # dwMicroSecPerFrame
            max_bytes * self.fps,         # dwMaxBytesPerSec
            0,                            # dwPaddingGranularity
            0x10,                         # dwFlags: AVIF_HASINDEX
            n, 0, 1,                      # frames, initial, streams
            max_bytes, w, h, 0, 0, 0, 0,
        )
        strh = struct.pack(
            "<4s4sIHHIIIIIIIi4H",
            b"vids", b"MJPG", 0, 0, 0, 0,
            1, self.fps,                  # dwScale / dwRate
            0, n, max_bytes, 10000, 0,
            0, 0, w, h,                   # rcFrame
        )
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
        hdrl = lst(b"hdrl", chunk(b"avih", avih)
                   + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
        movi_payload = b""
        index = b""
        for f in self._frames:
            offset = 4 + len(movi_payload)  # relative to the 'movi' fourcc
            movi_payload += chunk(b"00dc", f)
            index += struct.pack("<4sIII", b"00dc", 0x10, offset, len(f))
        riff_payload = b"AVI " + hdrl + lst(b"movi", movi_payload) + chunk(b"idx1", index)
        return b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload

    def close(self) -> None:
        blob = self.to_bytes()
        if blob and self.path is not None:
            with open(self.path, "wb") as fh:
                fh.write(blob)
        self._frames = []
        self._size = None


class NpyFramesWriter:
    """Numpy-only backend: frame i goes to `<dir>/<i:05d>.npy` (HxWx3 uint8)."""

    def __init__(self, frame_dir: str):
        self.frame_dir = frame_dir
        os.makedirs(frame_dir, exist_ok=True)
        self._count = 0

    def append_data(self, frame) -> None:
        np.save(os.path.join(self.frame_dir, f"{self._count:05d}.npy"), np.asarray(frame))
        self._count += 1

    def close(self) -> None:
        pass


class VideoWriter:
    """Writes `path` with the first backend of `available_backends()`."""

    def __init__(self, path: str, fps: int = 30):
        self.path = path
        stem = path.rsplit(".", 1)[0]
        self.backend = available_backends()[0]
        if self.backend == "ffmpeg":
            import imageio

            self._writer = imageio.get_writer(path, mode="I", fps=fps, codec="libx264")
            self.output_path = path
        elif self.backend == "mjpeg":
            self.output_path = stem + ".avi"
            self._writer = MJPEGWriter(self.output_path, fps=fps)
        else:
            self.output_path = stem + "_frames"
            self._writer = NpyFramesWriter(self.output_path)

    def append_data(self, frame) -> None:
        self._writer.append_data(frame)

    def close(self) -> None:
        self._writer.close()
