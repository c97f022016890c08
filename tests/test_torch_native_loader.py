"""The port's native image decode and resize (`adaptersis_tpu_torch/runtime/
image_io.cc` through `data/native.py`), built by g++ at first use, against
PIL, which is what the reference reads its datasets with: decode (`.convert
("RGB")` for frames, the stored values for gray and palette masks) and the
BILINEAR and NEAREST resizes, bit for bit, from a 960 × 540 frame (Robust-
MIS's size) to (16, 16), (37, 53) and (588, 588); a batch load equals single
loads; lossy mask formats are refused."""

import numpy as np
import pytest
from PIL import Image

from adaptersis_tpu_torch.data import native


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    assert native.available(), f"the native library did not build: {native.build_error}"
    assert native.decoder() == "native"
    d = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    # a smooth frame with noise, as an endoscope's: the resize's weights matter
    yy, xx = np.mgrid[0:540, 0:960]
    base = np.stack([(xx * 0.2 + yy * 0.1) % 256, (xx * 0.05 + 40) % 256, yy * 0.4 % 256], -1)
    frame = np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)
    out = {}
    Image.fromarray(frame).save(d / "frame.png")
    out["rgb_png"] = d / "frame.png"
    Image.fromarray(frame).save(d / "frame.jpg", quality=90)
    out["rgb_jpg"] = d / "frame.jpg"
    mask = np.where(rng.uniform(size=(540, 960)) < 0.3, 255, 0).astype(np.uint8)
    Image.fromarray(mask, "L").save(d / "mask.png")
    out["gray_png"] = d / "mask.png"
    pal = Image.fromarray(rng.integers(0, 5, (540, 960)).astype(np.uint8), "P")
    pal.putpalette([c for i in range(256) for c in ((i * 50) % 256, (i * 40) % 256, i)])
    pal.save(d / "pal.png")
    out["pal_png"] = d / "pal.png"
    Image.fromarray(rng.integers(0, 65536, (54, 96)).astype(np.uint16), "I;16").save(d / "g16.png")
    out["g16_png"] = d / "g16.png"
    return {k: str(v) for k, v in out.items()}


def _pil(path, size, mode):
    with open(path, "rb") as f:
        im = Image.open(f)
        im.load()
        if mode == "rgb":
            im = im.convert("RGB")
        if size is not None:
            im = im.resize(size[::-1], resample=Image.BILINEAR if mode == "rgb"
                           else Image.NEAREST)
        return np.asarray(im, np.uint8)


def test_decode_is_bit_exact(files):
    for key in ("rgb_png", "rgb_jpg", "gray_png", "pal_png"):
        mode = "rgb" if key.startswith("rgb") else "gray"
        got = native.load_image(files[key], (540, 960), mode)
        np.testing.assert_array_equal(got, _pil(files[key], None, mode), err_msg=key)


@pytest.mark.parametrize("size", [(16, 16), (37, 53), (588, 588)])
def test_resizes_are_bit_exact(files, size):
    for key in ("rgb_png", "rgb_jpg"):
        got = native.load_image(files[key], size, "rgb", "bilinear")
        np.testing.assert_array_equal(got, _pil(files[key], size, "rgb"), err_msg=key)
    for key in ("gray_png", "pal_png"):
        got = native.load_image(files[key], size, "gray", "nearest")
        np.testing.assert_array_equal(got, _pil(files[key], size, "gray"), err_msg=key)


def test_batch_load_equals_single_loads(files):
    paths = [files["rgb_png"], files["rgb_jpg"]] * 3
    batch = native.load_batch(paths, (37, 53), "rgb", "bilinear", n_threads=4)
    assert batch is not None and batch.shape == (6, 37, 53, 3)
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(batch[i], native.load_image(p, (37, 53)))
    masks = native.load_batch([files["gray_png"]] * 2, (16, 16), "gray", "nearest")
    np.testing.assert_array_equal(masks[1, :, :, 0], _pil(files["gray_png"], (16, 16), "gray"))


def test_lossy_mask_formats_are_refused(files):
    """16-bit gray and colour files read as masks return None: the dataset
    then reads them with PIL, never a changed label."""
    for key in ("g16_png", "rgb_png", "rgb_jpg"):
        assert native.load_image(files[key], (16, 16), "gray") is None, key
    assert native.load_batch([files["gray_png"], files["g16_png"]], (16, 16), "gray") is None
