"""JPEG decoding of the port against cv2.imread.

``data/image_io.py::read_image`` of a JPEG goes through the host library
``csrc/jpeg_decode.cpp`` (``data/jpeg.py``); it must give byte for byte
the pixels ``cv2.imread(path, cv2.IMREAD_COLOR)`` gives (OpenCV's bundled
libjpeg-turbo), in every mode the decoder covers, for files written here
with cv2 and PIL: qualities 50-100, 4:4:4 / 4:2:2 / 4:2:0 / 4:4:0,
progressive, restart intervals, optimized tables, grayscale, extended
sequential (SOF1) with 16-bit tables, EXIF orientations, sizes from 1x1 to
1280x720; streams cut off or corrupted; the library against the plain
NumPy version at small sizes; what is not ported; the pixel cap; and the
committed fixtures of ``tests/data/jpeg`` against their hashes.
"""

import hashlib
import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from dafne_torch.data import image_io as IO
from dafne_torch.data import jpeg as J

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg")
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def _scene(h, w, seed):
    """Edges, gradients and noise: every DCT coefficient gets used."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 3 + y) % 256, (y * 5) % 256, ((x * y) // 7) % 256], -1).astype(np.float64)
    img += rng.normal(0, 20, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_write(path, img, quality=90, sampling="420", progressive=0, rst=0, optimize=0):
    assert cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                                   cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
                                   cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
                                   cv2.IMWRITE_JPEG_OPTIMIZE, optimize])
    return path


def _assert_like_cv2(path):
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    assert want is not None
    got = IO.read_image(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(IO.read_image(path, "RGB"), want[:, :, ::-1])
    return got


# ---------------------------------------------------------- modes and sizes

SIZES = [(1, 1), (2, 3), (7, 13), (13, 7), (9, 9), (17, 33), (64, 48)]


@pytest.mark.parametrize("sampling", ["444", "422", "420", "440"])
@pytest.mark.parametrize("progressive", [0, 1])
@pytest.mark.parametrize("rst", [0, 2])
def test_cv2_modes_and_sizes_equal_cv2(tmp_path, sampling, progressive, rst):
    for k, (h, w) in enumerate(SIZES):
        for quality in (50, 75, 100):
            path = _cv2_write(str(tmp_path / f"{h}x{w}_{quality}.jpg"), _scene(h, w, k), quality,
                              sampling, progressive, rst, optimize=int(quality == 75))
            _assert_like_cv2(path)


@pytest.mark.parametrize("sampling,progressive", [("420", 0), ("422", 1), ("444", 0)])
def test_1280x720_equals_cv2(tmp_path, sampling, progressive):
    for h, w in ((720, 1280), (721, 1279)):
        _assert_like_cv2(_cv2_write(str(tmp_path / f"{h}.jpg"), _scene(h, w, 7), 92, sampling,
                                    progressive))


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("progressive,optimize", [(False, False), (False, True), (True, True)])
def test_pil_encodings_equal_cv2(tmp_path, subsampling, progressive, optimize):
    path = str(tmp_path / "pil.jpg")
    Image.fromarray(_scene(37, 53, subsampling)).save(path, quality=60 + 10 * subsampling,
                                                      subsampling=subsampling,
                                                      progressive=progressive, optimize=optimize)
    _assert_like_cv2(path)


@pytest.mark.parametrize("h,w", [(1, 1), (7, 13), (100, 37)])
def test_grayscale_replicated_like_cv2(tmp_path, h, w):
    gray = _scene(h, w, 3)[:, :, 0]
    for k, progressive in enumerate((0, 1)):
        got = _assert_like_cv2(_cv2_write(str(tmp_path / f"g{k}.jpg"), gray, 85,
                                          progressive=progressive))
        assert (got[:, :, 0] == got[:, :, 1]).all() and (got[:, :, 1] == got[:, :, 2]).all()
    path = str(tmp_path / "pil_gray.jpg")
    Image.fromarray(gray).save(path, quality=80)
    _assert_like_cv2(path)


def _sof1(data):
    """The stream with SOF0 renamed SOF1 and 16-bit quantization tables."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("write_fixtures", os.path.join(FIXTURES, "write_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.as_sof1(data)


def test_extended_sequential_sof1_with_16bit_tables(tmp_path):
    base = open(_cv2_write(str(tmp_path / "b.jpg"), _scene(24, 40, 5), 70), "rb").read()
    data = _sof1(base)
    assert b"\xff\xc1" in data and b"\xff\xc0" not in data
    path = str(tmp_path / "sof1.jpg")
    open(path, "wb").write(data)
    np.testing.assert_array_equal(_assert_like_cv2(path), IO.read_image(str(tmp_path / "b.jpg")))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_applied_like_cv2_and_size_unturned_like_pil(tmp_path, orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    path = str(tmp_path / "exif.jpg")
    Image.fromarray(_scene(21, 34, orientation)).save(path, exif=exif.tobytes())
    got = _assert_like_cv2(path)
    assert got.shape[:2] == ((21, 34) if orientation < 5 else (34, 21))
    assert IO.image_size(path) == Image.open(path).size == (34, 21)  # the header's, not turned
    assert J.exif_orientation(open(path, "rb").read()) == orientation


def test_decode_image_bytes_equals_imdecode(tmp_path):
    img = _scene(33, 47, 9)
    for ext in (".jpg", ".png", ".bmp"):
        ok, buf = cv2.imencode(ext, img)
        data = buf.tobytes()
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(IO.decode_image_bytes(data), want)
        np.testing.assert_array_equal(IO.decode_image_bytes(data, "RGB"), want[:, :, ::-1])


# ---------------------------------------------------------- the plain version


@pytest.mark.parametrize("sampling", ["444", "422", "420", "440"])
def test_library_equals_plain_version(tmp_path, sampling):
    J.reset_launch_counts()
    for k, (h, w) in enumerate([(1, 1), (7, 13), (17, 33), (40, 24)]):
        for progressive, rst in ((0, 0), (1, 0), (0, 3), (1, 2)):
            path = _cv2_write(str(tmp_path / f"{k}_{progressive}_{rst}.jpg"), _scene(h, w, k),
                              60 + 10 * k, sampling, progressive, rst)
            data = open(path, "rb").read()
            np.testing.assert_array_equal(IO.decode_jpeg(path, data), IO.decode_jpeg_plain(path, data))
    assert J.decode.launches == 16
    gray = _cv2_write(str(tmp_path / "gray.jpg"), _scene(11, 19, 2)[:, :, 0], 80, progressive=1)
    data = open(gray, "rb").read()
    np.testing.assert_array_equal(IO.decode_jpeg(gray, data), IO.decode_jpeg_plain(gray, data))


def test_plain_idct_upsampling_and_colour_steps():
    """The plain version's pieces on hand-made inputs: a DC-only block is
    flat, the triangle filters' edge and bias rules, the YCbCr table's
    neutral grays."""
    coef = np.zeros((1, 64), np.int64)
    coef[0, 0] = 10
    block = J.idct_islow_plain(coef, np.full(64, 4))
    assert (block == 128 + 5).all()  # 10 * 4 / 8
    plane = np.array([[10, 20, 30]], np.uint8)
    up = J.upsample_plain(plane, 3, 1, 2, 1, 6, 1)
    assert up.tolist() == [[10, 13, 17, 23, 27, 30]]  # (3a + b + 1) >> 2 and (3a + b + 2) >> 2
    gray = np.array([[0, 77, 128, 255]], np.uint8)
    bgr = J.ycc_to_bgr_plain(gray, np.full_like(gray, 128), np.full_like(gray, 128))
    assert (bgr == gray[..., None]).all()


# ---------------------------------------------------------- cut off, corrupt, refused


@pytest.mark.parametrize("progressive,rst", [(0, 0), (0, 1), (1, 0), (1, 2)])
def test_cut_off_streams_behave_like_cv2(tmp_path, progressive, rst):
    """Every cut: where cv2 returns an image (the rest of a sequential scan
    gray, a progressive file block-smoothed), the same image; where it
    returns None, ImageDecodeError naming the file."""
    src = _cv2_write(str(tmp_path / "src.jpg"), _scene(41, 57, 1), 85, "420", progressive, rst)
    data = open(src, "rb").read()
    path = str(tmp_path / "cut.jpg")
    images = 0
    for cut in range(3, len(data), 11):  # from the 3-byte signature on: still a JPEG file
        open(path, "wb").write(data[:cut])
        want = cv2.imread(path, cv2.IMREAD_COLOR)
        if want is None:
            with pytest.raises(IO.ImageDecodeError, match="cut.jpg"):
                IO.read_image(path)
        else:
            np.testing.assert_array_equal(IO.read_image(path), want, err_msg=f"cut at {cut}")
            images += 1
    assert images > 10


@pytest.mark.parametrize("progressive,rst", [(0, 0), (0, 1), (1, 0), (1, 2)])
def test_corrupt_entropy_data_like_cv2(tmp_path, progressive, rst):
    """Bytes of the entropy-coded data replaced at random: bad Huffman codes,
    runs past coefficient 63, lost and misplaced restart markers, IDCT
    inputs out of range: the same pixels as cv2, or a refusal where it
    refuses."""
    src = _cv2_write(str(tmp_path / "src.jpg"), _scene(64, 80, 2), 90, "420", progressive, rst)
    data = open(src, "rb").read()
    rng = np.random.RandomState(progressive * 2 + rst)
    path = str(tmp_path / "bad.jpg")
    for _ in range(40):
        b = bytearray(data)
        for _ in range(rng.randint(1, 4)):
            b[rng.randint(len(b) // 3, len(b) - 2)] = rng.randint(256)
        open(path, "wb").write(bytes(b))
        want = cv2.imread(path, cv2.IMREAD_COLOR)
        if want is None:
            with pytest.raises(IO.ImageDecodeError):
                IO.read_image(path)
        else:
            np.testing.assert_array_equal(IO.read_image(path), want)


def _patched(tmp_path, name, data, offset, value):
    b = bytearray(data)
    b[offset:offset + len(value)] = value
    path = str(tmp_path / name)
    open(path, "wb").write(bytes(b))
    return path


def test_unported_modes_raise_naming_the_file(tmp_path):
    base = open(_cv2_write(str(tmp_path / "b.jpg"), _scene(16, 16, 0), 90), "rb").read()
    sof = base.index(b"\xff\xc0")
    cases = {
        "arith.jpg": (sof + 1, b"\xc9", "arithmetic"),
        "lossless.jpg": (sof + 1, b"\xc3", "lossless"),
        "twelve.jpg": (sof + 4, b"\x0c", "12-bit"),
    }
    for name, (offset, value, what) in cases.items():
        with pytest.raises(NotImplementedError, match=f"{name}.*{what}|{what}.*{name}|{name}"):
            IO.read_image(_patched(tmp_path, name, base, offset, value))
    cmyk = str(tmp_path / "cmyk.jpg")
    Image.fromarray(_scene(16, 16, 1)).convert("CMYK").save(cmyk)
    with pytest.raises(NotImplementedError, match="cmyk.jpg.*4 components"):
        IO.read_image(cmyk)
    h411 = str(tmp_path / "h411.jpg")
    cv2.imwrite(h411, _scene(16, 32, 2), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    with pytest.raises(NotImplementedError, match="h411.jpg.*sampling factors 4x1"):
        IO.read_image(h411)


def test_refused_streams_raise_like_cv2_returns_none(tmp_path):
    base = open(_cv2_write(str(tmp_path / "b.jpg"), _scene(16, 16, 0), 90), "rb").read()
    dht = base.index(b"\xff\xc4")
    sos = base.index(b"\xff\xda")
    cases = {
        "no_sos.jpg": base[:sos] + b"\xff\xd9",
        "bad_dht.jpg": base[:dht + 5] + b"\xff" * 16 + base[dht + 21:],  # more codes than fit
        "header_only.jpg": base[:20],
    }
    for name, data in cases.items():
        path = str(tmp_path / name)
        open(path, "wb").write(data)
        assert cv2.imread(path, cv2.IMREAD_COLOR) is None, name
        with pytest.raises(IO.ImageDecodeError, match=name):
            IO.read_image(path)


def test_pixel_cap_refuses_before_allocating(tmp_path, monkeypatch):
    """A tiny file that declares 60000 x 60000 pixels (3.6e9, 10.8 GB of
    BGR) is refused from its header, for JPEG, PNG and BMP alike; the cap
    follows OPENCV_IO_MAX_IMAGE_PIXELS."""
    base = open(_cv2_write(str(tmp_path / "b.jpg"), _scene(16, 16, 0), 90), "rb").read()
    sof = base.index(b"\xff\xc0")
    bomb = _patched(tmp_path, "bomb.jpg", base, sof + 5, struct.pack(">HH", 60000, 60000))
    with pytest.raises(IO.ImageDecodeError, match="bomb.jpg.*64000000-pixel cap"):
        IO.read_image(bomb)
    ok, png = cv2.imencode(".png", _scene(4, 4, 0))
    png = bytearray(png.tobytes())
    png[16:24] = struct.pack(">II", 60000, 60000)
    png[29:33] = struct.pack(">I", zlib.crc32(bytes(png[12:29])))  # IHDR's CRC
    with pytest.raises(IO.ImageDecodeError, match="pixel cap"):
        IO.decode_image_bytes(bytes(png))
    ok, bmp = cv2.imencode(".bmp", _scene(4, 4, 0))
    bmp = bytearray(bmp.tobytes())
    bmp[18:26] = struct.pack("<ii", 60000, 60000)
    with pytest.raises(IO.ImageDecodeError, match="pixel cap"):
        IO.decode_image_bytes(bytes(bmp))
    monkeypatch.setenv("OPENCV_IO_MAX_IMAGE_PIXELS", "100")
    small = _cv2_write(str(tmp_path / "small.jpg"), _scene(11, 10, 0), 90)
    with pytest.raises(IO.ImageDecodeError, match="100-pixel cap"):
        IO.read_image(small)
    monkeypatch.setenv("OPENCV_IO_MAX_IMAGE_PIXELS", "110")
    _assert_like_cv2(small)


# ---------------------------------------------------------- the committed fixtures


def test_committed_fixtures_hash_to_cv2_pixels():
    manifest = json.load(open(os.path.join(FIXTURES, "fixtures.json")))
    assert len(manifest["files"]) >= 20
    total = 0
    for name, entry in manifest["files"].items():
        path = os.path.join(FIXTURES, name)
        total += os.path.getsize(path)
        want = cv2.imread(path, cv2.IMREAD_COLOR)
        assert hashlib.sha256(want.tobytes()).hexdigest() == entry["sha256"], name
        got = IO.read_image(path)
        assert list(got.shape) == entry["shape"], name
        assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"], name
    assert total <= 1 << 20
    for name, lines in manifest["icdar"].items():
        assert manifest["files"][name]["shape"] == [720, 1280, 3]
        assert any(line["unreadable"] for line in lines) and len(lines) >= 4
