"""``read_image``'s last resort in the PyTorch port: a frame in a format
other than PPM/PGM/PNM or PNG goes through PIL, converted to RGB, as in
``eppm_tpu/io/__init__.py::read_image``.  Tolerance: none, both packages
return the same array."""

import numpy as np
import pytest

from eppm_tpu.io import read_image as j_read_image

from eppm_tpu_torch.io import read_image

Image = pytest.importorskip("PIL.Image")


@pytest.mark.parametrize("name,mode", [("f.bmp", "RGB"), ("f.tif", "RGB"),
                                       ("g.tif", "L")])
def test_pil_fallback_matches_jax_package(tmp_path, name, mode):
    rng = np.random.default_rng(3)
    shape = (17, 23, 3) if mode == "RGB" else (17, 23)
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / name)
    kw = {"compression": "tiff_lzw"} if name.endswith(".tif") else {}
    Image.fromarray(arr, mode).save(path, **kw)   # lossless formats
    got = read_image(path)
    assert got.dtype == np.uint8 and got.shape == (17, 23, 3)
    np.testing.assert_array_equal(got, j_read_image(path))
    want = arr if mode == "RGB" else np.repeat(arr[..., None], 3, axis=2)
    np.testing.assert_array_equal(got, want)


def test_without_pil_other_formats_raise(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ValueError, match="without PIL"):
        read_image(str(tmp_path / "frame.bmp"))
