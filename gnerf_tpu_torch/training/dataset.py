"""Datasets: paired condition/loss views, depth maps and pose labels.

Port of `gnerf_tpu/training/dataset.py`, numpy and PIL only, with the same
on-disk layouts, item dicts and batches for the same seed:

  FFHQGenDataset  — synthesized identity pairs (`<id>/<id>_f.jpg` condition
    view, `_s.jpg` loss view, `pose_labels.json`, `depth_images.npy`) mixed
    50/50 with real FFHQ crops (`cropped_image/*.jpg`, `label/labels.json`);
    real items randomly get an angle swap with factor 0.
  Afhqv2Dataset / ShapeNetDataset — the same pairs with those real sets.
  TestDataset and its AFHQ / ShapeNet forms — held-out real crops
    (`held_out_partition`).
  ImageFolderDataset — an EG3D-style folder or zip with `dataset.json`.
  SyntheticDataset — procedural items with valid orbit poses; no files.

Paired-dataset images decode and resize through the native loader
(`utils/native_loader.py`, PIL bilinear without the library), folder
images with PIL LANCZOS, as in the JAX package. `data_iterator` shards
indices across hosts with InfiniteSampler and prefetches batches on a
thread.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import queue
import threading
from typing import Iterator, Mapping, Optional, Sequence

import numpy as np

from ..utils.misc import InfiniteSampler
from ..utils.profiling import span


def held_out_partition(
    fnames: Sequence[str], held_out: int, manifest: Optional[str] = None,
) -> tuple[list[str], list[str]]:
    """Deterministic (train, held_out) partition of the real-crop file list.

    The reference pins its eval set by slicing a sorted listing — train takes
    `[:-8000]`, test takes `[-8000:]`
    (`training/dataset.py:954-957,1114-1177`) — which
    silently shifts whenever files are added or the listing changes. Here the
    side a file lands on is a pure function of its BASENAME: files are ranked
    by md5(basename) and the first `held_out` ranks are held out, so the
    partition is stable across re-listings and machines, and train/test are
    disjoint by construction. An explicit `manifest` (text file, one basename
    per line) overrides the hash rule for exact reference-comparable splits.
    """
    if manifest:
        with open(manifest) as fh:
            held_names = {ln.strip() for ln in fh if ln.strip()}
        train = [f for f in sorted(fnames)
                 if os.path.basename(f) not in held_names]
        held = [f for f in sorted(fnames) if os.path.basename(f) in held_names]
        return train, held
    ranked = sorted(
        fnames,
        key=lambda f: (hashlib.md5(os.path.basename(f).encode()).hexdigest(), f),
    )
    held_set = set(ranked[:held_out])
    train = [f for f in sorted(fnames) if f not in held_set]
    held = [f for f in sorted(fnames) if f in held_set]
    return train, held

BatchDict = Mapping[str, np.ndarray]


def _imread_rgb_chw(path: str, resolution: Optional[int] = None) -> np.ndarray:
    """File -> CHW uint8. With `resolution`, the native loader decodes it and
    resizes an image of another size to it (`native_loader.decode_image`,
    as the JAX package does); without, PIL decodes it at its file size."""
    if resolution is not None:
        from ..utils.native_loader import decode_image

        return decode_image(path, resolution, resolution)
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img).transpose(2, 0, 1).copy()  # HWC -> CHW uint8


class ImageFolderDataset:
    """Generic EG3D-style image dataset: a directory tree OR a .zip archive
    of images with optional `dataset.json` camera labels.

    Capability equivalent of the reference base `ImageFolderDataset`
    (`dataset.py:167-247`): this is the on-disk format EG3D training data
    ships in (zip of images + {"labels": [[fname, [...25 floats]], ...]}),
    consumed here by the EG3D adversarial objective
    (`train.py --objective eg3d`) and evaluation. Items use the framework's
    dict contract (image mirrored into condition/loss slots, factor=1) so
    every consumer of `data_iterator` works unchanged.

    xflip=True appends horizontally-flipped copies with the reference's
    label adjustment-free convention (reference `dataset.py:56-60` flips
    only the raw image; pose labels are reused as-is there too)."""

    _EXTS = (".png", ".jpg", ".jpeg")

    def __init__(self, path: str, resolution: int = 512,
                 max_size: Optional[int] = None, xflip: bool = False):
        self.resolution = resolution
        self._zip = None
        self._path = path
        if path.endswith(".zip"):
            import zipfile

            self._zip = zipfile.ZipFile(path)
            names = [n for n in self._zip.namelist()
                     if n.lower().endswith(self._EXTS)]
        else:
            names = []
            for root, _dirs, files in os.walk(path):
                for fn in files:
                    if fn.lower().endswith(self._EXTS):
                        rel = os.path.relpath(os.path.join(root, fn), path)
                        names.append(rel)
        self._names = sorted(names)
        if not self._names:
            raise IOError(f"No images found in {path}")

        self._labels = {}
        raw = self._read_file("dataset.json")
        if raw is not None:
            entries = json.loads(raw.decode("utf-8")).get("labels") or []
            self._labels = {fname.replace("\\", "/"): np.asarray(lab, np.float32)
                            for fname, lab in entries}

        if max_size is not None:
            self._names = self._names[:max_size]
        self._xflip = xflip
        self._base = len(self._names)

    def _read_file(self, name: str) -> Optional[bytes]:
        if self._zip is not None:
            try:
                return self._zip.read(name)
            except KeyError:
                return None
        p = os.path.join(self._path, name)
        if os.path.isfile(p):
            with open(p, "rb") as f:
                return f.read()
        return None

    def _load_image(self, name: str) -> np.ndarray:
        import io

        from PIL import Image

        raw = self._read_file(name)
        img = Image.open(io.BytesIO(raw)).convert("RGB")
        if img.size != (self.resolution, self.resolution):
            img = img.resize((self.resolution, self.resolution),
                             Image.LANCZOS)
        return np.asarray(img).transpose(2, 0, 1)  # CHW uint8

    def __len__(self) -> int:
        return self._base * (2 if self._xflip else 1)

    @property
    def label_dim(self) -> int:
        return 25

    def get_label(self, idx: int) -> np.ndarray:
        name = self._names[idx % self._base].replace("\\", "/")
        lab = self._labels.get(name)
        if lab is None:
            lab = np.zeros((25,), np.float32)
        return lab

    def get_label_std(self) -> np.ndarray:
        """Per-dim std of all labels (reference `Dataset.get_label_std`,
        `dataset.py:120` — used for disc_c_noise)."""
        labs = np.stack([self.get_label(i) for i in range(self._base)])
        return labs.std(axis=0).astype(np.float32)

    def __getitem__(self, idx: int) -> dict:
        flip = self._xflip and idx >= self._base
        img = self._load_image(self._names[idx % self._base])
        if flip:
            img = img[:, :, ::-1].copy()
        c = self.get_label(idx)
        depth = np.zeros((1, 64, 64), np.float32)
        return {
            "condition_image": img,
            "condition_c": c,
            "loss_image": img,
            "loss_c": c,
            "random_image": img,
            "random_c": c,
            "c_depth_image": depth,
            "l_depth_image": depth,
            "flip_image": img[:, :, ::-1].copy(),
            "factor": np.float32(1.0),
        }


class FFHQGenDataset:
    """Paired synth + real FFHQ training set (reference FFHQ_GEN_Dataset,
    `dataset.py:945-1112`)."""

    ITEM_KEYS = (
        "condition_image", "condition_c", "loss_image", "loss_c",
        "random_image", "random_c", "c_depth_image", "l_depth_image",
        "flip_image", "factor",
    )

    def __init__(
        self,
        path: str,                       # synthesized-pairs root
        real_path: Optional[str] = None, # FFHQ-in-the-wild root
        resolution: int = 512,
        max_size: Optional[int] = 60000,
        max_gen: int = 6000,
        held_out: int = 8000,
        held_out_manifest: Optional[str] = None,
        seed: int = 0,
    ):
        self.resolution = resolution
        self._rnd = np.random.RandomState(seed)

        self._gen_fnames = self._scan_gen(path)[:max_gen]
        if not self._gen_fnames:
            raise IOError(f"No synthesized pairs found under {path}")
        with open(os.path.join(path, "pose_labels.json")) as f:
            self._pose_labels = json.load(f)
        self._depth_images = np.load(
            os.path.join(path, "depth_images.npy"), allow_pickle=True
        ).item()

        self._real_fnames = []
        self._real_labels = {}
        if real_path is not None and os.path.isdir(real_path):
            self._real_fnames, _ = held_out_partition(
                glob.glob(os.path.join(real_path, "cropped_image", "*.jpg")),
                held_out, held_out_manifest,
            )
            with open(os.path.join(real_path, "label", "labels.json")) as f:
                self._real_labels = json.load(f)
        if max_size is not None:
            self._real_fnames = self._real_fnames[:max_size]

        self._size = max(len(self._real_fnames), len(self._gen_fnames))

    def _scan_gen(self, path: str) -> list[str]:
        """Per-identity dirs: `<id>/<id>_f.jpg` (FFHQ layout)."""
        out = []
        for entry in sorted(os.scandir(path), key=lambda e: e.name):
            cand = os.path.join(path, entry.name, entry.name + "_f.jpg")
            if os.path.isfile(cand):
                out.append(cand)
        return out

    def __len__(self) -> int:
        return self._size

    @property
    def label_dim(self) -> int:
        return 25

    def _pose(self, fname: str, suffix_swap: Optional[tuple[str, str]] = None):
        key = os.path.basename(fname).replace(".jpg", ".json")
        if suffix_swap:
            key = key.replace(*suffix_swap)
        return np.asarray(self._pose_labels[key], dtype=np.float32)

    def _depth(self, fname: str, suffix_swap: Optional[tuple[str, str]] = None):
        key = os.path.basename(fname).replace(".jpg", "")
        if suffix_swap:
            key = key.replace(*suffix_swap)
        return np.asarray(self._depth_images[key], dtype=np.float32)

    def _load_gen(self, idx: int) -> dict:
        fname = self._gen_fnames[idx % len(self._gen_fnames)]
        cond = _imread_rgb_chw(fname, self.resolution)
        loss = _imread_rgb_chw(fname.replace("f.jpg", "s.jpg"), self.resolution)
        flip = loss[:, :, ::-1].copy()
        rnd_idx = self._rnd.randint(len(self._gen_fnames))
        rnd = _imread_rgb_chw(self._gen_fnames[rnd_idx], self.resolution)
        return {
            "condition_image": cond,
            "condition_c": self._pose(fname),
            "loss_image": loss,
            "loss_c": self._pose(fname, ("f", "s")),
            "random_image": rnd,
            "random_c": self._pose(self._gen_fnames[rnd_idx]),
            "c_depth_image": self._depth(fname),
            "l_depth_image": self._depth(fname, ("f", "s")),
            "flip_image": flip,
            "factor": np.float32(1.0),
        }

    def _real_label(self, fname: str):
        key = os.path.basename(fname).replace(".jpg", ".png")
        return np.asarray(self._real_labels[key], dtype=np.float32)

    def _load_real(self, idx: int) -> dict:
        fname = self._real_fnames[idx % len(self._real_fnames)]
        img = _imread_rgb_chw(fname, self.resolution)
        flip = img[:, :, ::-1].copy()
        label = self._real_label(fname)
        factor = np.float32(1.0)
        # Angle swap: replace the loss pose with another image's pose and
        # mask the reconstruction loss (reference `dataset.py:1072-1083`).
        if self._rnd.rand() > 0.5:
            factor = np.float32(0.0)
            other = self._real_fnames[self._rnd.randint(len(self._real_fnames))]
            label = self._real_label(other)
        rnd_name = self._real_fnames[self._rnd.randint(len(self._real_fnames))]
        rnd = _imread_rgb_chw(rnd_name, self.resolution)
        # Condition pose/depth borrowed from a random synth item (the real
        # branch has no depth supervision of its own).
        gen_name = self._gen_fnames[self._rnd.randint(len(self._gen_fnames))]
        return {
            "condition_image": img,
            "condition_c": self._pose(gen_name),
            "loss_image": img,
            "loss_c": label,
            "random_image": rnd,
            "random_c": self._real_label(rnd_name),
            "c_depth_image": self._depth(gen_name),
            "l_depth_image": self._depth(gen_name, ("f", "s")),
            "flip_image": flip,
            "factor": factor,
        }

    def __getitem__(self, idx: int) -> dict:
        if self._real_fnames and self._rnd.rand() > 0.5:
            return self._load_real(idx)
        return self._load_gen(idx)


class Afhqv2Dataset(FFHQGenDataset):
    """AFHQ-v2 paired training set (reference Afhqv2_Dataset,
    `dataset.py:1179-1386`): real cat crops `train/cat/*.png` with
    `train/label/labels.json`, plus the same synthesized-pair layout. The
    reference's hardcoded machine path becomes `real_path`."""

    def __init__(self, path: str, real_path: Optional[str] = None,
                 resolution: int = 512, max_size: Optional[int] = 4000,
                 max_gen: int = 6000, seed: int = 0):
        # Reuse the FFHQGen synth-pair machinery; swap the real-file listing.
        super().__init__(path=path, real_path=None, resolution=resolution,
                         max_size=max_size, max_gen=max_gen, seed=seed)
        if real_path is not None and os.path.isdir(real_path):
            self._real_fnames = sorted(
                glob.glob(os.path.join(real_path, "train", "cat", "*.png"))
            )
            if max_size is not None:
                self._real_fnames = self._real_fnames[:max_size]
            with open(os.path.join(real_path, "train", "label", "labels.json")) as f:
                self._real_labels = json.load(f)
        self._size = max(len(self._real_fnames), len(self._gen_fnames))

    def _scan_gen(self, path: str) -> list[str]:
        # AFHQ synth dirs use a flat `*/*_f.jpg` glob.
        return sorted(glob.glob(os.path.join(path, "*", "*_f.jpg")))

    def _real_label(self, fname: str):
        # AFHQ label keys keep the original extension.
        return np.asarray(self._real_labels[os.path.basename(fname)],
                          dtype=np.float32)


class ShapeNetDataset(FFHQGenDataset):
    """SRN chairs/cars paired set (reference ShapeNet_Dataset,
    `dataset.py:1389-1611`): real views listed in `train_up_sphere.txt` with
    `label/labels.json` keyed by the listed relative path. The reference's
    `_load_all_ShapeNet` stub (`dataset.py:1520-1523`, broken) is fixed: the
    real branch is fully implemented."""

    def __init__(self, path: str, real_path: Optional[str] = None,
                 resolution: int = 128, max_size: Optional[int] = 100000,
                 max_gen: int = 100000, seed: int = 0):
        super().__init__(path=path, real_path=None, resolution=resolution,
                         max_size=max_size, max_gen=max_gen, seed=seed)
        self._real_root = real_path
        if real_path is not None and os.path.isdir(real_path):
            with open(os.path.join(real_path, "train_up_sphere.txt")) as f:
                rel = [line.strip() for line in f if line.strip()]
            self._real_fnames = sorted(
                os.path.join(real_path, r) for r in rel
            )
            if max_size is not None:
                self._real_fnames = self._real_fnames[:max_size]
            with open(os.path.join(real_path, "label", "labels.json")) as f:
                self._real_labels = json.load(f)
        self._size = max(len(self._real_fnames), len(self._gen_fnames))

    def _scan_gen(self, path: str) -> list[str]:
        return sorted(glob.glob(os.path.join(path, "*", "*_f.jpg")))

    def _real_label(self, fname: str):
        key = os.path.relpath(fname, self._real_root)
        return np.asarray(self._real_labels[key], dtype=np.float32)


class TestDataset:
    """Held-out real FFHQ crops (reference Test_Dataset,
    `dataset.py:1114-1177`)."""

    def __init__(self, real_path: str, resolution: int = 512, held_out: int = 8000,
                 held_out_manifest: Optional[str] = None,
                 max_size: Optional[int] = None):
        self.resolution = resolution
        _, self._fnames = held_out_partition(
            glob.glob(os.path.join(real_path, "cropped_image", "*.jpg")),
            held_out, held_out_manifest,
        )
        if max_size:
            self._fnames = self._fnames[:max_size]
        with open(os.path.join(real_path, "label", "labels.json")) as f:
            self._labels = json.load(f)

    def __len__(self):
        return len(self._fnames)

    def __getitem__(self, idx: int) -> dict:
        fname = self._fnames[idx]
        img = _imread_rgb_chw(fname, self.resolution)
        label = np.asarray(
            self._labels[os.path.basename(fname).replace(".jpg", ".png")],
            dtype=np.float32,
        )
        return {"condition_image": img, "condition_c": label,
                "loss_image": img, "loss_c": label, "factor": np.float32(1.0)}


class Afhqv2TestDataset:
    """Held-out AFHQ-v2 cat crops (reference Afhqv2_Test_Dataset,
    `dataset.py:1330-1388`): the tail of the SORTED train/cat listing
    beyond the train slice — the reference trains on sorted[:4000] and
    tests on sorted[4000:], so `train_size` must match Afhqv2Dataset's
    `max_size` for the split to be complementary. Items mirror the image
    into condition/loss slots (eval contract)."""

    def __init__(self, real_path: str, resolution: int = 512,
                 train_size: int = 4000, max_size: Optional[int] = None):
        self.resolution = resolution
        fnames = sorted(
            glob.glob(os.path.join(real_path, "train", "cat", "*.png")))
        self._fnames = fnames[train_size:]
        if max_size:
            self._fnames = self._fnames[:max_size]
        with open(os.path.join(real_path, "train", "label", "labels.json")) as f:
            self._labels = json.load(f)

    def __len__(self):
        return len(self._fnames)

    def __getitem__(self, idx: int) -> dict:
        fname = self._fnames[idx]
        img = _imread_rgb_chw(fname, self.resolution)
        label = np.asarray(self._labels[os.path.basename(fname)], np.float32)
        return {"condition_image": img, "condition_c": label,
                "loss_image": img, "loss_c": label, "factor": np.float32(1.0)}


class ShapeNetTestDataset:
    """Held-out SRN chair/car views (reference ShapeNet_Test_Dataset,
    `dataset.py:1532-1611`): a SEPARATE test root (e.g. chairs_test/) with
    a `train.txt` listing of relative view paths and `label/labels.json`
    keyed by those paths. The reference's hardcoded machine path becomes
    `real_path`."""

    def __init__(self, real_path: str, resolution: int = 128,
                 max_size: Optional[int] = None):
        self.resolution = resolution
        self._root = real_path
        with open(os.path.join(real_path, "train.txt")) as f:
            rel = sorted(line.strip() for line in f if line.strip())
        self._fnames = [os.path.join(real_path, r) for r in rel]
        if max_size:
            self._fnames = self._fnames[:max_size]
        with open(os.path.join(real_path, "label", "labels.json")) as f:
            self._labels = json.load(f)

    def __len__(self):
        return len(self._fnames)

    def __getitem__(self, idx: int) -> dict:
        fname = self._fnames[idx]
        img = _imread_rgb_chw(fname, self.resolution)
        key = os.path.relpath(fname, self._root)
        label = np.asarray(self._labels[key], np.float32)
        return {"condition_image": img, "condition_c": label,
                "loss_image": img, "loss_c": label, "factor": np.float32(1.0)}


class SyntheticDataset:
    """Procedural stand-in with the FFHQGen item contract: random images,
    valid FFHQ orbit poses, plausible depth. Lets the full train step run
    without any data on disk (smoke tests, benchmarks, CI)."""

    def __init__(self, resolution: int = 512, depth_resolution: int = 64,
                 size: int = 1024, seed: int = 0):
        self.resolution = resolution
        self.depth_resolution = depth_resolution
        self._size = size
        self._seed = seed

    def __len__(self):
        return self._size

    @property
    def label_dim(self) -> int:
        return 25

    def _label(self, rnd) -> np.ndarray:
        # Build an orbit pose in numpy.
        theta = np.pi / 2 + 0.7 * (rnd.rand() * 2 - 1)
        phi = np.pi / 2 - 0.05 + 0.3 * (rnd.rand() * 2 - 1)
        r = 2.7
        origin = np.array([
            r * np.sin(phi) * np.cos(np.pi - theta),
            r * np.cos(phi),
            r * np.sin(phi) * np.sin(np.pi - theta),
        ])
        forward = -origin / np.linalg.norm(origin)
        up = np.array([0.0, 1.0, 0.0])
        right = -np.cross(up, forward)
        right /= np.linalg.norm(right)
        up2 = np.cross(forward, right)
        up2 /= np.linalg.norm(up2)
        m = np.eye(4)
        m[:3, :3] = np.stack([right, up2, forward], axis=-1)
        m[:3, 3] = origin
        intr = np.array([[4.2647, 0, 0.5], [0, 4.2647, 0.5], [0, 0, 1]])
        return np.concatenate([m.reshape(16), intr.reshape(9)]).astype(np.float32)

    def __getitem__(self, idx: int) -> dict:
        rnd = np.random.RandomState(self._seed * 100003 + idx)
        res = self.resolution
        img = rnd.randint(0, 256, (3, res, res), dtype=np.uint8)
        depth = (2.25 + rnd.rand(1, self.depth_resolution, self.depth_resolution)
                 * (3.3 - 2.25)).astype(np.float32)
        c = self._label(rnd)
        return {
            "condition_image": img,
            "condition_c": c,
            "loss_image": img,
            "loss_c": self._label(rnd),
            "random_image": img,
            "random_c": self._label(rnd),
            "c_depth_image": depth,
            "l_depth_image": depth,
            "flip_image": img[:, :, ::-1].copy(),
            "factor": np.float32(1.0),
        }


def collate(items: list[Mapping[str, np.ndarray]]) -> dict:
    keys = items[0].keys()
    return {k: np.stack([np.asarray(it[k]) for it in items]) for k in keys}


def data_iterator(
    dataset,
    batch_size: int,
    rank: int = 0,
    num_replicas: int = 1,
    seed: int = 0,
    prefetch: int = 2,
) -> Iterator[dict]:
    """Endless prefetched batch iterator, sharded across hosts."""
    sampler = InfiniteSampler(len(dataset), rank=rank, num_replicas=num_replicas,
                              seed=seed)
    q: queue.Queue = queue.Queue(maxsize=prefetch)

    def worker():
        indices = iter(sampler)
        while True:
            with span("data.batch"):
                batch = collate([dataset[next(indices)] for _ in range(batch_size)])
            q.put(batch)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        with span("data.next"):
            batch = q.get()
        yield batch
