"""FFHQ face alignment: landmark-driven quad-warp crop (no dlib).

The port's copy of `gnerf_tpu/utils/alignment.py` (numpy, scipy and PIL
only; kept here because the JAX package's `utils` imports JAX). It
reimplements the reference's ``utils/alignment.py:29-114`` (``align_face``)
geometry with the landmark *detection* step factored out: landmarks are an
input, from a file, any detector, or a service. Everything downstream of the
landmarks matches the reference:

- quad construction:        reference ``alignment.py:37-64``
- shrink / crop / pad:      reference ``alignment.py:72-106``
- PIL.Image.QUAD warp:      reference ``alignment.py:109`` — reproduced by
  :func:`quad_warp` (numpy bilinear, calibrated against PIL: output pixel
  ``(x, y)`` maps to the quad-bilinear point at ``u=(x+0.5)/size``, sampled
  at ``src-0.5`` in array-index space, zero fill outside).

The output is the FFHQ-aligned crop the identity encoder E expects; it feeds
`infer/gen_videos.py --align_lm` and the server's `/encode` endpoint.
"""

from __future__ import annotations

import json

import numpy as np

__all__ = [
    "ffhq_quad",
    "quad_warp",
    "align_face",
    "load_landmarks",
    "align_folder",
]


def load_landmarks(path: str) -> np.ndarray:
    """Load a 68x2 landmark array from .json ([[x,y],...]), .npy, or
    whitespace text. Landmarks are in source-image pixel coordinates."""
    if path.endswith(".npy"):
        lm = np.load(path)
    elif path.endswith(".json"):
        with open(path) as f:
            lm = np.asarray(json.load(f), dtype=np.float64)
    else:
        lm = np.loadtxt(path)
    lm = np.asarray(lm, dtype=np.float64)
    if lm.shape != (68, 2):
        raise ValueError(f"expected (68, 2) landmarks, got {lm.shape}")
    return lm


def ffhq_quad(lm: np.ndarray) -> tuple[np.ndarray, float]:
    """Oriented crop rectangle from 68-point landmarks.

    Returns (quad [4,2] float64 — NW, SW, SE, NE corners in source pixel
    coords — and qsize, the quad edge length). Math from the reference
    ``alignment.py:47-64``: the x axis blends the eye-to-eye direction with
    the perpendicular of eye-to-mouth; scale is the max of 2.0x the
    inter-ocular distance and 1.8x the eye-to-mouth distance; the center
    sits 0.1 of the way from the eye midpoint toward the mouth.
    """
    lm = np.asarray(lm, dtype=np.float64)
    if lm.shape != (68, 2):
        raise ValueError(f"expected (68, 2) landmarks, got {lm.shape}")
    eye_left = lm[36:42].mean(axis=0)
    eye_right = lm[42:48].mean(axis=0)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (lm[48] + lm[54]) * 0.5  # outer mouth corners
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    qsize = float(np.hypot(*x) * 2)
    return quad, qsize


def _bilinear_at(img: np.ndarray, sx: np.ndarray, sy: np.ndarray
                 ) -> np.ndarray:
    """Bilinear sample of HxWxC float `img` at fractional array indices
    (sx, sy); points outside [0, W-1]x[0, H-1] fill with 0 (PIL's black
    fill for out-of-quad pixels)."""
    h, w = img.shape[:2]
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    valid = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    x0c = np.clip(x0, 0, w - 1)
    y0c = np.clip(y0, 0, h - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    top = img[y0c, x0c] * (1 - fx) + img[y0c, x1c] * fx
    bot = img[y1c, x0c] * (1 - fx) + img[y1c, x1c] * fx
    out = top * (1 - fy) + bot * fy
    return out * valid[..., None]


def quad_warp(img: np.ndarray, quad: np.ndarray, size: int) -> np.ndarray:
    """PIL ``Image.transform(QUAD, quad + 0.5, BILINEAR)`` equivalent
    (reference ``alignment.py:109``) on an HxWxC float array.

    `quad` is [NW, SW, SE, NE] in source pixel-index coordinates (the
    reference's +0.5 shift is applied internally to match its call site).
    Output pixel (x, y) maps to the bilinear blend of the quad corners at
    (u, v) = ((x+0.5)/size, (y+0.5)/size), sampled at src-0.5 in array
    indices — calibrated against PIL's C implementation.
    """
    q = np.asarray(quad, dtype=np.float64) + 0.5
    nw, sw, se, ne = q
    xs = (np.arange(size, dtype=np.float64) + 0.5) / size
    u, v = np.meshgrid(xs, xs, indexing="xy")  # u along x, v along y
    top = nw[None, None] * (1 - u)[..., None] + ne[None, None] * u[..., None]
    bot = sw[None, None] * (1 - u)[..., None] + se[None, None] * u[..., None]
    src = top * (1 - v)[..., None] + bot * v[..., None]
    return _bilinear_at(np.asarray(img, np.float64),
                        src[..., 0] - 0.5, src[..., 1] - 0.5)


def _pil_resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    import PIL.Image

    pil = PIL.Image.fromarray(np.asarray(img, np.uint8))
    return np.asarray(pil.resize((w, h), PIL.Image.LANCZOS), np.float64)


def align_face(img: np.ndarray, lm: np.ndarray, output_size: int = 512,
               enable_padding: bool = True) -> np.ndarray:
    """FFHQ-align an HxWx3 uint8 image given its 68 landmarks.

    Returns the output_size x output_size x 3 uint8 aligned crop. Follows
    the reference ``align_face`` (``alignment.py:29-114``) step for step:
    shrink (when the quad is >2x oversampled), bordered crop, reflect-pad
    with Gaussian-blur + median feathering when the quad exits the image,
    then the bilinear quad warp. transform_size == output_size, as in the
    reference (``alignment.py:69``)."""
    import scipy.ndimage

    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    quad, qsize = ffhq_quad(lm)
    quad = quad.copy()
    imgf = np.asarray(img, np.float64)

    # Shrink (reference :72-78): antialiased downsize when the quad covers
    # >2x the output resolution, to bound warp cost.
    shrink = int(np.floor(qsize / output_size * 0.5))
    if shrink > 1:
        rw = int(np.rint(img.shape[1] / shrink))
        rh = int(np.rint(img.shape[0] / shrink))
        imgf = _pil_resize(img, rw, rh)
        quad /= shrink
        qsize /= shrink

    # Crop (reference :80-88): tight bordered crop around the quad.
    border = max(int(np.rint(qsize * 0.1)), 3)
    h, w = imgf.shape[:2]
    crop = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
            int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    crop = (max(crop[0] - border, 0), max(crop[1] - border, 0),
            min(crop[2] + border, w), min(crop[3] + border, h))
    if crop[2] - crop[0] < w or crop[3] - crop[1] < h:
        imgf = imgf[crop[1]:crop[3], crop[0]:crop[2]]
        quad -= crop[0:2]

    # Pad (reference :90-106): reflect-pad when the quad leaves the image,
    # feathering the padded band with a Gaussian blur and the median color.
    h, w = imgf.shape[:2]
    pad = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
           int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    pad = (max(-pad[0] + border, 0), max(-pad[1] + border, 0),
           max(pad[2] - w + border, 0), max(pad[3] - h + border, 0))
    if enable_padding and max(pad) > border - 4:
        pad = np.maximum(pad, int(np.rint(qsize * 0.3)))
        imgf = np.pad(imgf, ((pad[1], pad[3]), (pad[0], pad[2]), (0, 0)),
                      "reflect")
        h, w = imgf.shape[:2]
        yy, xx = np.ogrid[:h, :w]
        with np.errstate(divide="ignore", invalid="ignore"):
            mask = np.maximum(
                1.0 - np.minimum(xx / pad[0], (w - 1 - xx) / pad[2]),
                1.0 - np.minimum(yy / pad[1], (h - 1 - yy) / pad[3]))
        mask = np.nan_to_num(mask, posinf=1.0)[..., None]
        blur = qsize * 0.02
        blurred = scipy.ndimage.gaussian_filter(imgf, [blur, blur, 0])
        imgf = imgf + (blurred - imgf) * np.clip(mask * 3.0 + 1.0, 0.0, 1.0)
        imgf = imgf + (np.median(imgf, axis=(0, 1)) - imgf) * np.clip(
            mask, 0.0, 1.0)
        imgf = np.clip(np.rint(imgf), 0, 255)
        quad += pad[:2]

    out = quad_warp(imgf, quad, output_size)
    return np.uint8(np.clip(np.rint(out), 0, 255))


def align_folder(data_dir: str, lm_dir: str, out_dir: str,
                 output_size: int = 512) -> list[str]:
    """Align every image in `data_dir` that has a landmark file of the same
    stem (`<stem>.json|.npy|.txt`) in `lm_dir`; write PNGs to `out_dir`.
    Returns the written paths. The batch analog of the reference's
    ``utils/align_data.py`` pre-processing step, with landmarks supplied
    from files instead of dlib."""
    import os

    import PIL.Image

    os.makedirs(out_dir, exist_ok=True)
    exts = (".png", ".jpg", ".jpeg", ".webp")
    written = []
    for name in sorted(os.listdir(data_dir)):
        stem, ext = os.path.splitext(name)
        if ext.lower() not in exts:
            continue
        lm_path = next(
            (p for p in (os.path.join(lm_dir, stem + e)
                         for e in (".json", ".npy", ".txt"))
             if os.path.exists(p)), None)
        if lm_path is None:
            continue
        img = np.asarray(
            PIL.Image.open(os.path.join(data_dir, name)).convert("RGB"))
        aligned = align_face(img, load_landmarks(lm_path), output_size)
        out_path = os.path.join(out_dir, stem + ".png")
        PIL.Image.fromarray(aligned).save(out_path)
        written.append(out_path)
    return written
