"""Native C++ component tests: stb image decode and the ctypes boundary."""

import numpy as np
import pytest

from zig_weekend_raytracer_tpu.io import native
from zig_weekend_raytracer_tpu.io.image import load_image
from zig_weekend_raytracer_tpu.models import DEFAULT_ASSET_DIR

import os


@pytest.mark.skipif(not native.available(), reason="native lib not built")
class TestNativeDecode:
    def test_decode_matches_pil(self):
        path = os.path.join(DEFAULT_ASSET_DIR, "wap.jpg")
        if not os.path.exists(path):
            pytest.skip("asset missing")
        data = open(path, "rb").read()
        img_native = native.decode_image(data)
        assert img_native is not None

        import io as _io

        from PIL import Image

        with Image.open(_io.BytesIO(data)) as im:
            img_pil = np.asarray(im.convert("RGB"), np.uint8)
        assert img_native.shape == img_pil.shape
        # JPEG decoders may differ by a few LSBs (IDCT variants)
        diff = np.abs(
            img_native.astype(np.int16) - img_pil.astype(np.int16)
        )
        assert diff.mean() < 2.0
        assert (diff <= 16).mean() > 0.999

    def test_decode_png_exact(self):
        path = os.path.join(DEFAULT_ASSET_DIR, "earth.png")
        if not os.path.exists(path):
            pytest.skip("asset missing")
        data = open(path, "rb").read()
        img_native = native.decode_image(data)

        import io as _io

        from PIL import Image

        with Image.open(_io.BytesIO(data)) as im:
            img_pil = np.asarray(im.convert("RGB"), np.uint8)
        # PNG is lossless: decoders must agree exactly
        np.testing.assert_array_equal(img_native, img_pil)

    def test_decode_garbage_returns_none(self):
        assert native.decode_image(b"not an image at all") is None


def test_load_image_uses_native_or_fallback(tmp_path):
    img = load_image(os.path.join(DEFAULT_ASSET_DIR, "wap.jpg"))
    assert img.ndim == 3 and img.shape[2] == 3
    assert img.dtype == np.uint8
    assert img.shape[0] > 100 and img.shape[1] > 100


def test_library_name_follows_source_hash(tmp_path, monkeypatch):
    """The built library's name hashes the sources, so an edited source
    builds a new library instead of loading a stale one."""
    import shutil

    srcs = []
    for src in native._SOURCES:
        dst = tmp_path / os.path.basename(src)
        shutil.copy(src, dst)
        srcs.append(str(dst))
    monkeypatch.setattr(native, "_SOURCES", tuple(srcs))
    before = native.lib_path()
    assert os.path.dirname(before) == native._BUILD_DIR
    with open(srcs[0], "a") as f:
        f.write("\n// edited\n")
    assert native.lib_path() != before


def test_build_is_cached(tmp_path, monkeypatch):
    """build() compiles into the build directory once; a second call finds
    the library for the same sources and does not rebuild it."""
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    assert native.build()
    path = native.lib_path()
    assert os.path.exists(path)
    mtime = os.path.getmtime(path)
    assert native.build()
    assert os.path.getmtime(path) == mtime
    assert [p for p in os.listdir(tmp_path) if p.endswith(".so")] == [
        os.path.basename(path)
    ]
