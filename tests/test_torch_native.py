"""The port's native image pipeline (``zsgnet_tpu_torch/data/native.py``,
its own build of ``zsgnet_tpu_torch/csrc/zsg_image.cpp``) against the JAX
package's (``zsgnet_tpu/data/native.py`` over ``csrc/``): every output
byte-identical on the same bytes, malformed files refused alike and never
crashing, and the datasets of both packages giving equal items through it
— uint8 exactly, host-normalized float32 within 1e-6."""

import io

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from zsgnet_tpu.config import Config as JConfig
from zsgnet_tpu.data import native as j_native
from zsgnet_tpu.data.dataset import ImgQuDataset as JImgQuDataset
from zsgnet_tpu.data.vocab import Vocab as JVocab
from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.data import dataset, native, synthetic
from zsgnet_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD, ImgQuDataset
from zsgnet_tpu_torch.data.vocab import Vocab

pytestmark = pytest.mark.skipif(
    not (native.available() and j_native.available()), reason="a native library is unavailable (no compiler?)"
)

SHAPES = [(97, 121), (64, 64), (300, 200)]
OUT_HW = [(64, 64), (48, 80)]


def _encode(arr: np.ndarray, mode: str, fmt: str = "PNG") -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def _image(rng, shape, mode):
    channels = {"RGB": (3,), "L": (), "RGBA": (4,)}[mode]
    return rng.integers(0, 256, size=(*shape, *channels)).astype(np.uint8)


def _assert_same(got, want):
    """Both None, or equal arrays and original sizes."""
    assert (got is None) == (want is None)
    if got is not None:
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("out_hw", OUT_HW, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
def test_png_outputs_byte_identical(mode, shape, out_hw):
    png = _encode(_image(np.random.default_rng(sum(shape)), shape, mode), mode)
    for name in ("image_load_u8", "png_load_u8"):
        got = getattr(native, name)(png, out_hw)
        assert got is not None and got[1] == shape and got[0].shape == (*out_hw, 3)
        _assert_same(got, getattr(j_native, name)(png, out_hw))
    for name in ("image_load", "png_load"):
        got = getattr(native, name)(png, out_hw, IMAGENET_MEAN, IMAGENET_STD)
        assert got is not None and got[0].dtype == np.float32
        _assert_same(got, getattr(j_native, name)(png, out_hw, IMAGENET_MEAN, IMAGENET_STD))


@pytest.mark.parametrize("out_hw", OUT_HW, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_jpeg_outputs_byte_identical(mode, shape, out_hw):
    if not (native.has_jpeg() and j_native.has_jpeg()):
        pytest.skip("native libjpeg decode unavailable")
    rng = np.random.default_rng(sum(shape) + 1)
    arr = (rng.normal(0.5, 0.2, size=(*shape, 3) if mode == "RGB" else shape).clip(0, 1) * 255).astype(np.uint8)
    jpg = _encode(arr, mode, "JPEG")
    got = native.image_load_u8(jpg, out_hw)
    assert got is not None and got[1] == shape
    _assert_same(got, j_native.image_load_u8(jpg, out_hw))
    _assert_same(native.image_load(jpg, out_hw, IMAGENET_MEAN, IMAGENET_STD),
                 j_native.image_load(jpg, out_hw, IMAGENET_MEAN, IMAGENET_STD))


@pytest.mark.parametrize("out_hw", OUT_HW, ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_stages_byte_identical(out_hw):
    arr = _image(np.random.default_rng(5), (50, 70), "RGB")
    np.testing.assert_array_equal(native.resize_u8(arr, out_hw), j_native.resize_u8(arr, out_hw))
    np.testing.assert_array_equal(native.resize_normalize_rgb(arr, out_hw, IMAGENET_MEAN, IMAGENET_STD),
                                  j_native.resize_normalize_rgb(arr, out_hw, IMAGENET_MEAN, IMAGENET_STD))
    with pytest.raises(ValueError, match=r"\(h, w, 3\)"):
        native.resize_u8(arr[..., 0], out_hw)  # a gray (h, w) array would be read out of bounds
    # Within Pillow's fixed-point resample, ≤ 2/255 (tests/test_native.py's bound).
    pil = np.asarray(Image.fromarray(arr).resize(out_hw[::-1], Image.BILINEAR), np.int32)
    assert np.abs(native.resize_u8(arr, out_hw).astype(np.int32) - pil).max() <= 2


def _blobs(rng) -> list[bytes]:
    arr = rng.integers(0, 256, size=(48, 60, 3)).astype(np.uint8)
    blobs = [_encode(arr, "RGB")]
    if native.has_jpeg():
        blobs.append(_encode(arr, "RGB", "JPEG"))
    return blobs


@pytest.mark.parametrize("case", ["garbage", "truncated", "bitflipped", "magic_plus_noise"])
def test_malformed_inputs_refused_alike_and_never_crash(case):
    """The JAX package's fuzz cases: each input gives None or a well-formed
    image, and the same answer from both libraries."""
    rng = np.random.default_rng(7)
    if case == "garbage":
        inputs = [b"", b"not an image at all", bytes(rng.integers(0, 256, 4096, dtype=np.uint8))]
    elif case == "truncated":
        inputs = [b[: max(int(len(b) * f), 1)] for b in _blobs(rng) for f in np.linspace(0.02, 0.98, 25)]
    elif case == "bitflipped":
        inputs = []
        for blob in _blobs(rng):
            for _ in range(60):
                b = bytearray(blob)
                b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
                inputs.append(bytes(b))
    else:
        inputs = [sig + bytes(rng.integers(0, 256, size=n, dtype=np.uint8))
                  for sig in (b"\x89PNG\r\n\x1a\n", b"\xff\xd8\xff\xe0") for n in (0, 1, 7, 64, 1024, 65536)]
    for data in inputs:
        got = native.image_load_u8(data, (24, 24))
        if got is not None:
            assert got[0].shape == (24, 24, 3) and got[0].dtype == np.uint8 and len(got[1]) == 2
        _assert_same(got, j_native.image_load_u8(data, (24, 24)))
    assert native.image_load_u8(b"not an image at all", (8, 8)) is None


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    synthetic.generate(root, n_train=8, n_val=2, n_test=2, img_size=64)
    return root / "synthetic"


def _datasets(root, **kw):
    args = dict(resize_img=(48, 48), max_qlen=6, **kw)
    csv = root / "csv_dir" / "train.csv"
    queries = pd.read_csv(csv)["query"].astype(str)
    return (ImgQuDataset(csv, root / "images", Vocab.build(queries), Config(**args)),
            JImgQuDataset(csv, root / "images", JVocab.build(queries), JConfig(**args)))


def test_dataset_items_equal_jax_u8(synth_root):
    """Fault 1: with PIL decode the port's 48² items differed from JAX's
    native ones by 1/255 in many sub-pixels; now every item is equal, and
    every image went through the native path."""
    t_ds, j_ds = _datasets(synth_root)
    native.reset_counts()
    for i in range(len(t_ds)):
        t, j = t_ds[i], j_ds[i]
        assert t["img"].dtype == np.uint8 and set(t) == set(j)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert native.counts() == {"native": len(t_ds), "pil": 0}


def test_dataset_items_equal_jax_host_normalized(synth_root):
    """Fault 2: ``normalize_on_device=False`` gives float32 images normalized
    on the host, JAX's within 1e-6 (the port used to ignore the flag)."""
    t_ds, j_ds = _datasets(synth_root, normalize_on_device=False)
    for i in range(len(t_ds)):
        t, j = t_ds[i], j_ds[i]
        assert t["img"].dtype == np.float32 and t["img"].shape == (48, 48, 3)
        np.testing.assert_allclose(t["img"], j["img"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(t["annot"], j["annot"])


@pytest.mark.parametrize("loader", ["u8", "float"])
def test_pil_fallback_for_other_formats(tmp_path, loader):
    """A BMP decodes with PIL (counted as such), resized by the native
    stage, equal to the JAX package's path."""
    from zsgnet_tpu.data import dataset as j_dataset

    path = tmp_path / "img.bmp"
    Image.fromarray(_image(np.random.default_rng(3), (40, 52), "RGB")).save(path)
    native.reset_counts()
    if loader == "u8":
        got, want = dataset._load_image_u8(path, (32, 32)), j_dataset._load_image_u8(path, (32, 32))
    else:
        got, want = dataset._load_image(path, (32, 32)), j_dataset._load_image(path, (32, 32))
    _assert_same(got, want)
    assert native.counts() == {"native": 0, "pil": 1}


def test_failed_build_is_reported_and_pil_decodes(tmp_path, monkeypatch, capsys):
    """A compiler that fails leaves its reason in ``status()`` (printed once)
    and the dataset decodes with PIL alone."""
    monkeypatch.setattr(native, "_status", None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", "false")
    status = native.status()
    assert status.startswith("unavailable:") and "false" in status
    assert native.status() == status and capsys.readouterr().err.count("unavailable") == 1
    assert not native.available() and native.image_load_u8(b"x", (8, 8)) is None
    arr = _image(np.random.default_rng(4), (20, 30), "RGB")
    got, orig = dataset.load_image_bytes_u8(_encode(arr, "RGB"), (20, 30))
    assert orig == (20, 30)
    np.testing.assert_array_equal(got, arr)


def test_library_builds_from_the_ports_source():
    """Built from zsgnet_tpu_torch/csrc into build/native, apart from the
    JAX package's csrc/libzsgimage.so."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    assert native.SOURCE == root / "zsgnet_tpu_torch" / "csrc" / "zsg_image.cpp"
    assert native.lib_path().parent == root / "build" / "native"
    assert str(native.SOURCE) in native.build_command(native.lib_path())
    assert not any("/csrc/libzsgimage" in a or a == str(root / "csrc") for a in native.build_command(native.lib_path()))
    assert native.status().startswith(f"loaded {native.lib_path()}")
