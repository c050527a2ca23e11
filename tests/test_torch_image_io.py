"""The port's image decoder (``dafne_torch/data/image_io.py``) against
``cv2.imread(path, cv2.IMREAD_COLOR)``, the JAX package's reader, and PIL's
sizes.

Tolerance: none.  Every decoded image equals cv2's bit for bit, in BGR and
in RGB; the native unfilter equals its NumPy version byte for byte; every
size equals PIL's.  Files are written here by cv2, by PIL and by
``chip_smoke.write_png`` (which forces each of the five filter types).
"""

import os
import struct
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from dafne_tpu.data.mapper import read_image as jax_read_image

from dafne_torch.data import image_io as io

from chip_smoke import write_png, write_tile

torch.set_num_threads(1)

WIDTHS = (1, 3, 1023)


def _image(seed, h, w, smooth=False):
    """A random BGR image; `smooth` gives runs that the adaptive filters
    of cv2 and PIL pick Sub, Up, Average and Paeth for."""
    rng = np.random.RandomState(seed)
    if not smooth:
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 3 + yy * 5)[:, :, None] + np.array([0, 40, 80])
    return ((base + rng.randint(0, 4, (h, w, 3))) % 256).astype(np.uint8)


def _assert_like_cv2(path):
    want = cv2.imread(path, cv2.IMREAD_COLOR)  # what the JAX package's read_image calls
    assert want is not None
    got = io.read_image(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(io.read_image(path, "RGB"), jax_read_image(path, "RGB"))
    assert io.image_size(path) == Image.open(path).size
    return got


def _filters_of(path):
    """The filter byte of each row of an 8-bit PNG."""
    header, _, idat = io.png_chunks(path, open(path, "rb").read())
    raw = io.inflate(path, idat, header)
    step = header.rowbytes + 1
    return {raw[i] for i in range(0, len(raw), step)}


# ------------------------------------------------------------------ PNG


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("smooth", [False, True])
def test_png_from_cv2(tmp_path, width, smooth):
    img = _image(width, 17, width, smooth)
    path = str(tmp_path / "cv.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(_assert_like_cv2(path), img)


@pytest.mark.parametrize("mode", ["RGB", "L", "LA", "RGBA", "P256", "P5", "P5-tRNS", "1"])
@pytest.mark.parametrize("width", WIDTHS)
def test_png_from_pil(tmp_path, mode, width):
    """Gray, gray+alpha, RGBA, palette (8-bit, and 4-bit with 5 colors,
    with and without tRNS) and 1-bit gray."""
    rgb = Image.fromarray(_image(width + 7, 13, width, smooth=True)[:, :, ::-1])
    path = str(tmp_path / "pil.png")
    if mode == "P256":
        rgb.convert("P", palette=Image.ADAPTIVE, colors=256).save(path)
    elif mode.startswith("P5"):
        img = rgb.convert("P", palette=Image.ADAPTIVE, colors=5)
        img.save(path, **({"transparency": 2} if mode.endswith("tRNS") else {}))
    else:
        rgb.convert(mode).save(path)
    _assert_like_cv2(path)


@pytest.mark.parametrize("kind", ["rgb", "gray", "rgba", "palette"])
@pytest.mark.parametrize("width", WIDTHS)
def test_png_each_filter_type(tmp_path, kind, width):
    """Rows filtered None, Sub, Up, Average and Paeth in turn (and each
    filter alone), through chip_smoke's writer: equal to cv2 and to the
    array written."""
    img = _image(width, 11, width)
    for filters in ((0, 1, 2, 3, 4), (3,), (4,)):
        path = str(tmp_path / f"{kind}.png")
        want = write_tile(path, img, kind, np.random.RandomState(0), filters)
        assert _filters_of(path) <= set(filters)
        np.testing.assert_array_equal(_assert_like_cv2(path), want)


def test_png_writers_cover_every_filter(tmp_path):
    path = str(tmp_path / "five.png")
    write_png(path, _image(0, 10, 6)[:, :, ::-1].copy(), 2)
    assert _filters_of(path) == {0, 1, 2, 3, 4}
    cv2.imwrite(path, _image(1, 64, 64, smooth=True))
    assert len(_filters_of(path)) >= 1


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("rowbytes_extra", [0, 1, 5])
def test_native_unfilter_equals_plain(bpp, rowbytes_extra):
    rng = np.random.RandomState(bpp * 10 + rowbytes_extra)
    h, rowbytes = 9, bpp * 7 + rowbytes_extra
    rows = rng.randint(0, 256, (h, rowbytes + 1)).astype(np.uint8)
    rows[:, 0] = np.arange(h) % 5
    raw = rows.tobytes()
    got = io.unfilter(raw, h, rowbytes, bpp)
    np.testing.assert_array_equal(got, io.unfilter_plain(raw, h, rowbytes, bpp))
    for f in range(5):  # every row with one filter, the first row included
        rows[:, 0] = f
        np.testing.assert_array_equal(io.unfilter(rows.tobytes(), h, rowbytes, bpp),
                                      io.unfilter_plain(rows.tobytes(), h, rowbytes, bpp))


def test_unfilter_counts_its_calls_and_rejects_a_bad_filter_byte():
    io.reset_launch_counts()
    raw = bytes([0, 1, 2, 9, 3, 4])
    with pytest.raises(io.ImageDecodeError, match="row 1"):
        io.unfilter(raw, 2, 2, 1)
    with pytest.raises(io.ImageDecodeError, match="row 1"):
        io.unfilter_plain(raw, 2, 2, 1)
    io.unfilter(bytes([1, 5, 6]), 1, 2, 1)
    assert io.unfilter.launches == 2


def test_unfilter_count_is_exact_under_many_threads():
    """The loader's threads decode at once: no call is lost from the count."""
    io.unfilter(bytes([0, 1]), 1, 1, 1)  # build and load first
    io.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(32) as pool:
            results = list(pool.map(lambda i: io.unfilter(bytes([1, i % 256, 3]), 1, 2, 1),
                                    range(4000), timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert len(results) == 4000 and io.unfilter.launches == 4000


# ------------------------------------------------------------------ BMP


@pytest.mark.parametrize("channels", [3, 4, 1])
@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("width", WIDTHS)
def test_bmp_from_cv2(tmp_path, channels, top_down, width):
    """24- and 32-bit and 8-bit paletted (cv2 writes gray so) BMPs, with
    cv2's bottom-up rows and rewritten top-down (negative height)."""
    img = _image(width, 7, width)
    if channels == 4:
        img = np.concatenate([img, img[:, :, :1] // 2], axis=2)
    elif channels == 1:
        img = img[:, :, 1]
    path = str(tmp_path / "cv.bmp")
    cv2.imwrite(path, img)
    if top_down:
        data = bytearray(open(path, "rb").read())
        offset = struct.unpack("<I", data[10:14])[0]
        w, h = struct.unpack("<ii", data[18:26])
        bits = struct.unpack("<H", data[28:30])[0]
        stride = (w * bits + 31) // 32 * 4
        rows = [data[offset + i * stride: offset + (i + 1) * stride] for i in range(h)]
        data[offset: offset + h * stride] = b"".join(rows[::-1])
        data[22:26] = struct.pack("<i", -h)
        open(path, "wb").write(bytes(data))
    _assert_like_cv2(path)


# ---------------------------------------------------------- sizes, errors


def test_image_size_of_a_jpeg_equals_pil(tmp_path):
    path = str(tmp_path / "img.jpg")
    cv2.imwrite(path, _image(3, 37, 53, smooth=True))
    assert io.image_size(path) == Image.open(path).size == (53, 37)
    np.testing.assert_array_equal(io.read_image(path), cv2.imread(path, cv2.IMREAD_COLOR))


def _png_bytes(tmp_path, **kw):
    path = str(tmp_path / "base.png")
    cv2.imwrite(path, _image(5, 20, 30), **kw)
    return bytearray(open(path, "rb").read())


def _chunk_at(data, kind):
    return bytes(data).index(kind) - 4  # the chunk's length field


def test_sixteen_bit_and_interlaced_raise_not_implemented(tmp_path):
    path = str(tmp_path / "deep.png")
    cv2.imwrite(path, (_image(6, 8, 8).astype(np.uint16) * 257))
    with pytest.raises(NotImplementedError, match="deep.png"):
        io.read_image(path)
    data = _png_bytes(tmp_path)
    i = _chunk_at(data, b"IHDR")
    data[i + 8 + 12] = 1  # the interlace byte
    data[i + 21:i + 25] = struct.pack(">I", zlib.crc32(bytes(data[i + 4:i + 21])))
    path = str(tmp_path / "adam7.png")
    open(path, "wb").write(bytes(data))
    with pytest.raises(NotImplementedError, match="adam7.png"):
        io.read_image(path)


@pytest.mark.parametrize("cut", [0.3, 0.8, 0.999])
def test_truncated_png_raises_naming_the_file(tmp_path, cut):
    data = _png_bytes(tmp_path)
    path = str(tmp_path / "cut.png")
    open(path, "wb").write(bytes(data[:int(len(data) * cut)]))
    with pytest.raises(io.ImageDecodeError, match="cut.png"):
        io.read_image(path)


def test_bad_crc_critical_raises_ancillary_is_skipped(tmp_path):
    data = _png_bytes(tmp_path)
    i = _chunk_at(data, b"IDAT")
    bad = bytearray(data)
    bad[i + 8] ^= 0xFF  # a byte of the IDAT data: its CRC no longer holds
    path = str(tmp_path / "badcrc.png")
    open(path, "wb").write(bytes(bad))
    assert cv2.imread(path, cv2.IMREAD_COLOR) is None
    with pytest.raises(io.ImageDecodeError, match="badcrc.png.*CRC"):
        io.read_image(path)
    # an ancillary tEXt chunk with a wrong CRC: dropped, as libpng drops it
    text = b"Comment\x00x"
    chunk = struct.pack(">I", len(text)) + b"tEXt" + text + b"\x00\x00\x00\x00"
    j = _chunk_at(data, b"IDAT")
    path = str(tmp_path / "badtext.png")
    open(path, "wb").write(bytes(data[:j]) + chunk + bytes(data[j:]))
    np.testing.assert_array_equal(io.read_image(path), cv2.imread(path, cv2.IMREAD_COLOR))
    assert io.image_size(path) == (30, 20)  # PIL refuses the file


def test_missing_file_and_unknown_format(tmp_path):
    with pytest.raises(FileNotFoundError, match="nope.png"):
        io.read_image(str(tmp_path / "nope.png"))
    path = str(tmp_path / "x.gif")
    open(path, "wb").write(b"GIF89a" + bytes(20))
    with pytest.raises(NotImplementedError, match="x.gif"):
        io.read_image(path)
    with pytest.raises(NotImplementedError, match="x.gif"):
        io.image_size(path)


def test_truncated_bmp_raises(tmp_path):
    path = str(tmp_path / "cut.bmp")
    cv2.imwrite(path, _image(2, 9, 9))
    data = open(path, "rb").read()
    open(path, "wb").write(data[:len(data) - 30])
    with pytest.raises(io.ImageDecodeError, match="cut.bmp"):
        io.read_image(path)


def test_the_native_library_builds_into_the_build_dir():
    from dafne_torch.ops.kernels import build

    path = build.lib_path("png_unfilter")
    io.unfilter(bytes([0, 7]), 1, 1, 1)
    assert os.path.exists(path) and os.path.dirname(path) == build.BUILD_DIR
    assert os.path.basename(path).startswith("libpng_unfilter-")
