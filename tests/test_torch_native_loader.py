"""The port's native image loader (gnerf_tpu_torch.utils.native_loader, a
copy of gnerf_tpu.utils.native_loader) with `native/libgnerf_loader.so`
built: the port's photo loading (`infer.gen_videos._load_images`) and
dataset decoding (`training.dataset._imread_rgb_chw`) equal the JAX
package's bit for bit, for a downscaled and an upscaled photo, and folder
datasets keep PIL LANCZOS in both. Each resize case records, as the junit
property `max_abs_uint8_gap`, how far the native resize is from PIL's
bilinear (the port's resize before it went through the native loader)."""

import numpy as np
import pytest
from PIL import Image

from _torch_port import load_native_loader, one_torch_thread  # noqa: F401
from gnerf_tpu.infer import gen_videos as jgv
from gnerf_tpu.training import dataset as jds
from gnerf_tpu.utils import native_loader as jnative
from gnerf_tpu_torch.infer import gen_videos as gv
from gnerf_tpu_torch.training import dataset as tds
from gnerf_tpu_torch.utils import native_loader as tnative

# (source height, width, format) -> resized to SIZE x SIZE
CASES = {"down": (96, 136, "jpg"), "up": (40, 30, "png"), "same": (64, 64, "png")}
SIZE = 64


@pytest.fixture
def native(monkeypatch):
    load_native_loader(monkeypatch)
    assert jnative.native_available() and tnative.native_available()


def _photo(tmp_path, case):
    h, w, fmt = CASES[case]
    rs = np.random.RandomState(h + w)
    small = rs.randint(0, 256, (h // 8 + 2, w // 8 + 2, 3), np.uint8)
    img = Image.fromarray(small).resize((w, h), Image.BICUBIC)
    path = str(tmp_path / f"{case}.{fmt}")
    img.save(path, quality=92)
    return path


def _pil_bilinear(path):
    img = Image.open(path).convert("RGB").resize((SIZE, SIZE), Image.BILINEAR)
    return np.asarray(img).transpose(2, 0, 1)


def test_port_module_is_the_jax_module():
    assert tnative._LIB_PATH == jnative._LIB_PATH
    for name in ("decode_image", "NativeImageLoader", "native_available"):
        assert hasattr(tnative, name), name


@pytest.mark.parametrize("case", ["down", "up"])
def test_load_images_match_jax_with_native_library(native, tmp_path, case, record_property):
    path = _photo(tmp_path, case)
    got = gv._load_images(path, None, size=SIZE)
    want = jgv._load_images(path, None, size=SIZE)
    assert got.shape == (1, 3, SIZE, SIZE) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    gap = int(np.abs(got[0].astype(int) - _pil_bilinear(path).astype(int)).max())
    record_property("max_abs_uint8_gap", gap)
    print(f"{case}: native vs PIL bilinear max abs uint8 gap {gap}")
    assert gap > 0  # the two resizers differ: what the port used to get wrong


@pytest.mark.parametrize("case", ["down", "up", "same"])
def test_imread_rgb_chw_matches_jax_with_native_library(native, tmp_path, case):
    path = _photo(tmp_path, case)
    got = tds._imread_rgb_chw(path, SIZE)
    np.testing.assert_array_equal(got, jds._imread_rgb_chw(path, SIZE))
    assert got.shape == (3, SIZE, SIZE) and got.dtype == np.uint8
    h, w, _ = CASES[case]
    full = tds._imread_rgb_chw(path)
    np.testing.assert_array_equal(full, jds._imread_rgb_chw(path))
    assert full.shape == (3, h, w)


def test_image_folder_dataset_keeps_lanczos(native, tmp_path):
    """The folder dataset resizes with PIL LANCZOS in both packages, native
    library or not."""
    root = tmp_path / "folder"
    root.mkdir()
    for case in ("down", "up"):
        Image.open(_photo(tmp_path, case)).save(root / f"{case}.png")
    got = tds.ImageFolderDataset(str(root), resolution=SIZE)
    want = jds.ImageFolderDataset(str(root), resolution=SIZE)
    for name in ("down.png", "up.png"):
        img = got._load_image(name)
        np.testing.assert_array_equal(img, want._load_image(name))
        lanczos = Image.open(root / name).convert("RGB").resize((SIZE, SIZE), Image.LANCZOS)
        np.testing.assert_array_equal(img, np.asarray(lanczos).transpose(2, 0, 1))
