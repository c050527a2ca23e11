"""Image files to uint8 arrays, without cv2 or PIL.

Counterpart of ``dafne_tpu/data/mapper.py::read_image`` (``cv2.imread(path,
cv2.IMREAD_COLOR)``, flipped to RGB for ``fmt == "RGB"``), of
``tools/serve.py::decode_image_body``'s ``cv2.imdecode`` and of the PIL
size reads in ``dafne_tpu/data/datasets/ucas_aod.py`` and ``icdar15.py``:

- ``read_image(path, fmt)`` and ``decode_image_bytes(data, fmt)``: PNG,
  BMP and JPEG to [H, W, 3] uint8 in BGR (or RGB), converted as
  ``IMREAD_COLOR`` converts them: gray to three equal channels, alpha
  dropped, a palette looked up, a JPEG turned as its EXIF orientation
  says.
- ``image_size(path)``: (width, height) from the header alone (PNG IHDR,
  the BMP header, a JPEG's SOFn marker), as PIL's ``Image.size``: not
  turned by the EXIF orientation.

Every decoder reads the image's size from its header first and refuses an
image of more than ``max_image_pixels()`` pixels before it allocates
anything (``OPENCV_IO_MAX_IMAGE_PIXELS``, default 64 000 000, the cap of
``tools/serve.py``).

PNG: the chunks are parsed and their CRCs checked as libpng checks them (a
bad critical chunk is an error, a bad ancillary chunk is skipped), the IDAT
chunks are inflated with ``zlib`` and each scanline is unfiltered by
``unfilter``, the host library ``csrc/png_unfilter.cpp`` (built with g++
at first use; ``unfilter_plain`` is its NumPy version, for the tests).  Bit
depths 1, 2, 4 and 8, not interlaced.  BMP: 24- and 32-bit, and 8-bit
paletted, bottom-up or top-down.  JPEG: ``data/jpeg.py`` and the host
library ``csrc/jpeg_decode.cpp`` (libjpeg-turbo's arithmetic, which OpenCV
decodes with; ``decode_jpeg_plain`` is its NumPy version, for the tests).

What is not ported raises ``NotImplementedError`` naming the file: 16-bit
and interlaced PNGs, other BMP layouts, the JPEG modes ``data/jpeg.py``
lists.  A missing file raises ``FileNotFoundError``; a corrupt or truncated
one, or one over the pixel cap, ``ImageDecodeError`` (where ``cv2.imread``
returns None, and the JAX package then raises ``FileNotFoundError``).
Nothing decodes quietly with the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import struct
import threading
import zlib
from typing import Optional, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each PNG color type: gray, RGB, palette, gray+alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


_COUNT_LOCK = threading.Lock()  # the loader's threads decode at once
DEFAULT_MAX_IMAGE_PIXELS = 64_000_000


class ImageDecodeError(ValueError):
    """A corrupt or truncated image file, or one over the pixel cap."""


def max_image_pixels() -> int:
    """The pixel cap: ``OPENCV_IO_MAX_IMAGE_PIXELS`` when set, else
    64 000 000 (``tools/serve.py``), read at each decode."""
    return int(os.environ.get("OPENCV_IO_MAX_IMAGE_PIXELS", DEFAULT_MAX_IMAGE_PIXELS))


def check_pixels(path: str, width: int, height: int, max_pixels: Optional[int] = None) -> None:
    """Raise ImageDecodeError when a header's width x height is over the
    pixel cap."""
    cap = max_image_pixels() if max_pixels is None else max_pixels
    if width * height > cap:
        raise ImageDecodeError(f"{path}: image {width}x{height} exceeds the {cap}-pixel cap")


@dataclasses.dataclass(frozen=True)
class PngHeader:
    width: int
    height: int
    bit_depth: int
    color_type: int

    @property
    def channels(self) -> int:
        return _PNG_CHANNELS[self.color_type]

    @property
    def rowbytes(self) -> int:
        return (self.width * self.channels * self.bit_depth + 7) // 8

    @property
    def bpp(self) -> int:
        """Bytes per complete pixel, the filters' left distance (>= 1)."""
        return max(1, self.channels * self.bit_depth // 8)


def _read_bytes(path: str) -> bytes:
    try:
        with open(path, "rb") as f:
            return f.read()
    except FileNotFoundError:
        raise FileNotFoundError(path) from None


def read_image(path: str, fmt: str = "BGR") -> np.ndarray:
    """[H, W, 3] uint8 of the image file at `path`, in BGR, or in RGB for
    ``fmt == "RGB"``; the pixels ``cv2.imread(path, cv2.IMREAD_COLOR)``
    gives."""
    return decode_image_bytes(_read_bytes(path), fmt, path)


def decode_image_bytes(data: bytes, fmt: str = "BGR", name: str = "<image bytes>") -> np.ndarray:
    """[H, W, 3] uint8 of an encoded PNG, BMP or JPEG held in memory (a
    request body), as ``read_image`` decodes a file; `name` names it in the
    errors."""
    if data.startswith(PNG_SIGNATURE):
        img = decode_png(name, data)
    elif data[:2] == b"BM":
        img = decode_bmp(name, data)
    elif data[:3] == b"\xff\xd8\xff":
        img = decode_jpeg(name, data)
    else:
        raise NotImplementedError(f"{name}: not a PNG, BMP or JPEG file")
    if fmt == "RGB":
        img = np.ascontiguousarray(img[:, :, ::-1])
    return img


def decode_jpeg(path: str, data: bytes) -> np.ndarray:
    """A JPEG file's bytes to [H, W, 3] uint8 BGR, turned as its EXIF
    orientation says (``data/jpeg.py::decode``)."""
    from dafne_torch.data import jpeg

    return jpeg.decode(path, data, max_image_pixels())


def decode_jpeg_plain(path: str, data: bytes) -> np.ndarray:
    """``decode_jpeg`` in NumPy and Python (``data/jpeg.py::decode_plain``),
    for the tests at small sizes."""
    from dafne_torch.data import jpeg

    return jpeg.orient(jpeg.decode_plain(path, data), jpeg.exif_orientation(data))


# ---- PNG --------------------------------------------------------------------

def png_chunks(path: str, data: bytes) -> Tuple[PngHeader, Optional[np.ndarray], bytes]:
    """(header, palette [256, 3] RGB or None, the IDAT chunks concatenated)
    of a PNG file's bytes."""
    if not data.startswith(PNG_SIGNATURE):
        raise ImageDecodeError(f"{path}: not a PNG file")
    pos, header, palette, idat = len(PNG_SIGNATURE), None, None, []
    while True:
        if pos + 12 > len(data):
            raise ImageDecodeError(f"{path}: truncated PNG (no IEND chunk)")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise ImageDecodeError(f"{path}: truncated PNG ({kind!r} chunk cut short)")
        body = data[pos + 8:end - 4]
        crc_ok = zlib.crc32(data[pos + 4:end - 4]) == struct.unpack(">I", data[end - 4:end])[0]
        pos = end
        critical = not kind[0] & 0x20
        if not crc_ok:
            if critical:
                raise ImageDecodeError(f"{path}: CRC error in the {kind.decode('latin1')} chunk")
            continue  # libpng's default: an ancillary chunk with a bad CRC is dropped
        if header is None and kind != b"IHDR":
            raise ImageDecodeError(f"{path}: the first chunk is not IHDR")
        if kind == b"IHDR":
            w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
            if w == 0 or h == 0 or ctype not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[ctype] \
                    or comp != 0 or filt != 0 or interlace > 1:
                raise ImageDecodeError(
                    f"{path}: invalid IHDR {(w, h, depth, ctype, comp, filt, interlace)}")
            if depth == 16:
                raise NotImplementedError(f"{path}: 16-bit PNG decoding is not ported")
            if interlace:
                raise NotImplementedError(f"{path}: interlaced (Adam7) PNG decoding is not ported")
            header = PngHeader(w, h, depth, ctype)
        elif kind == b"PLTE":
            if length % 3 or not 0 < length <= 768:
                raise ImageDecodeError(f"{path}: invalid PLTE chunk of {length} bytes")
            palette = np.zeros((256, 3), np.uint8)  # indices past the palette read black
            palette[:length // 3] = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif critical:
            raise ImageDecodeError(f"{path}: unknown critical chunk {kind!r}")
    if not idat:
        raise ImageDecodeError(f"{path}: no IDAT chunk")
    if header.color_type == 3 and palette is None:
        raise ImageDecodeError(f"{path}: palette image without a PLTE chunk")
    return header, palette, b"".join(idat)


def inflate(path: str, idat: bytes, header: PngHeader) -> bytes:
    """The filtered scanlines, height * (1 + rowbytes) bytes, from the
    concatenated IDAT data."""
    need = header.height * (header.rowbytes + 1)
    d = zlib.decompressobj()
    try:
        raw = d.decompress(idat)
    except zlib.error as e:
        raise ImageDecodeError(f"{path}: corrupt PNG image data ({e})") from None
    if not d.eof or len(raw) < need:
        raise ImageDecodeError(f"{path}: truncated PNG image data ({len(raw)} of {need} bytes)")
    return raw[:need]


def reset_launch_counts() -> None:
    unfilter.launches = 0


def _lib():
    from dafne_torch.ops.kernels import build

    lib = build.load("png_unfilter")
    if not getattr(lib, "_dafne_typed", False):
        i = ctypes.c_int64
        lib.png_unfilter.argtypes = [ctypes.c_char_p, i, i, i, ctypes.c_void_p]
        lib.png_unfilter.restype = i
        lib._dafne_typed = True
    return lib


def unfilter(raw: bytes, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Unfilter PNG scanlines (each a filter byte and `rowbytes` bytes)
    into [height, rowbytes] uint8, in the host library
    ``csrc/png_unfilter.cpp``; a build failure raises."""
    fn = _lib().png_unfilter
    if len(raw) < height * (rowbytes + 1):
        raise ValueError(f"unfilter: {len(raw)} bytes for {height} rows of {rowbytes}")
    out = np.empty((height, rowbytes), np.uint8)
    bad = fn(raw, height, rowbytes, bpp, out.ctypes.data)  # ctypes drops the GIL here
    with _COUNT_LOCK:
        unfilter.launches += 1
    if bad:
        raise ImageDecodeError(f"invalid PNG filter type in row {bad - 1}")
    return out


unfilter.launches = 0


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter_plain(raw: bytes, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """``unfilter`` in NumPy and Python, row by row: the plain version the
    tests hold the library to (about a second per 1024^2 RGB image)."""
    rows = np.frombuffer(raw, np.uint8, count=height * (rowbytes + 1)).reshape(height, rowbytes + 1)
    out = np.empty((height, rowbytes), np.uint8)
    prior = np.zeros(rowbytes, np.uint8)
    for y in range(height):
        f, x = int(rows[y, 0]), rows[y, 1:]
        if f == 0:
            cur = x.copy()
        elif f == 1:  # Sub: a running sum mod 256 over each byte lane of a pixel
            lanes = np.zeros(-(-rowbytes // bpp) * bpp, np.int64)
            lanes[:rowbytes] = x
            cur = (np.cumsum(lanes.reshape(-1, bpp), axis=0) % 256).reshape(-1)[:rowbytes]
            cur = cur.astype(np.uint8)
        elif f == 2:
            cur = x + prior  # uint8 wraps mod 256
        elif f in (3, 4):
            xs, bs, cur_l = x.tolist(), prior.tolist(), [0] * rowbytes
            for i in range(rowbytes):
                a = cur_l[i - bpp] if i >= bpp else 0
                if f == 3:
                    pred = (a + bs[i]) >> 1
                else:
                    pred = _paeth(a, bs[i], bs[i - bpp] if i >= bpp else 0)
                cur_l[i] = (xs[i] + pred) & 0xFF
            cur = np.asarray(cur_l, np.uint8)
        else:
            raise ImageDecodeError(f"invalid PNG filter type in row {y}")
        out[y] = cur
        prior = out[y]
    return out


def png_to_bgr(header: PngHeader, palette: Optional[np.ndarray], rows: np.ndarray) -> np.ndarray:
    """Unfiltered rows [H, rowbytes] -> [H, W, 3] uint8 BGR, as
    ``IMREAD_COLOR`` converts: gray to three channels (depths below 8
    scaled to 0-255), RGB to BGR, alpha dropped, a palette looked up."""
    h, w, d, ch = header.height, header.width, header.bit_depth, header.channels
    if d < 8:  # one sample per pixel: unpack the bits, high bits first
        bits = np.unpackbits(rows, axis=1)[:, :w * d].reshape(h, w, d)
        samples = (bits.astype(np.uint8) << np.arange(d - 1, -1, -1, dtype=np.uint8)).sum(
            axis=2, dtype=np.uint8)[:, :, None]
    else:
        samples = rows[:, :w * ch].reshape(h, w, ch)
    if header.color_type == 3:
        return np.ascontiguousarray(palette[samples[:, :, 0]][:, :, ::-1])
    if header.color_type in (2, 6):
        return np.ascontiguousarray(samples[:, :, 2::-1])
    gray = samples[:, :, 0]
    if d < 8:
        gray = gray * np.uint8(255 // ((1 << d) - 1))
    return np.repeat(gray[:, :, None], 3, axis=2)


def decode_png(path: str, data: bytes) -> np.ndarray:
    header, palette, idat = png_chunks(path, data)
    check_pixels(path, header.width, header.height)
    raw = inflate(path, idat, header)
    try:
        rows = unfilter(raw, header.height, header.rowbytes, header.bpp)
    except ImageDecodeError as e:
        raise ImageDecodeError(f"{path}: {e}") from None
    return png_to_bgr(header, palette, rows)


# ---- BMP --------------------------------------------------------------------

def decode_bmp(path: str, data: bytes) -> np.ndarray:
    """24- and 32-bit (alpha dropped) and 8-bit paletted BMPs, bottom-up or
    top-down rows, to [H, W, 3] uint8 BGR."""
    if len(data) < 54:
        raise ImageDecodeError(f"{path}: truncated BMP header")
    offset, dib = struct.unpack("<I", data[10:14])[0], struct.unpack("<I", data[14:18])[0]
    if dib < 40:
        raise NotImplementedError(f"{path}: BMP header of {dib} bytes is not ported")
    width, height, _, bits, compression = struct.unpack("<iiHHI", data[18:34])
    colors_used = struct.unpack("<I", data[46:50])[0]
    if compression == 3 and bits == 32:  # BI_BITFIELDS: only the plain BGRX layout
        masks = struct.unpack("<III", data[54:66])
        if masks != (0xFF0000, 0xFF00, 0xFF):
            raise NotImplementedError(f"{path}: BMP bit masks {masks} are not ported")
    elif compression != 0 or bits not in (8, 24, 32):
        raise NotImplementedError(f"{path}: {bits}-bit BMP with compression {compression} "
                                  "is not ported")
    if width <= 0 or height == 0:
        raise ImageDecodeError(f"{path}: invalid BMP size {width} x {height}")
    h = abs(height)
    check_pixels(path, width, h)
    stride = (width * bits + 31) // 32 * 4
    if offset + stride * h > len(data):
        raise ImageDecodeError(f"{path}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, count=stride * h, offset=offset).reshape(h, stride)
    if height > 0:  # bottom-up
        rows = rows[::-1]
    if bits == 8:
        n = colors_used or 256
        table = np.zeros((256, 3), np.uint8)
        start = 14 + dib
        table[:n] = np.frombuffer(data, np.uint8, count=4 * n, offset=start).reshape(n, 4)[:, :3]
        return table[rows[:, :width]]
    px = bits // 8
    return np.ascontiguousarray(rows[:, :width * px].reshape(h, width, px)[:, :, :3])


# ---- sizes ------------------------------------------------------------------

_JPEG_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) of a PNG, BMP or JPEG file from its header, as PIL's
    ``Image.open(path).size``."""
    with open(path, "rb") as f:
        head = f.read(26)
        if head.startswith(PNG_SIGNATURE) and head[12:16] == b"IHDR":
            return struct.unpack(">II", head[16:24])
        if head[:2] == b"BM" and len(head) >= 26:
            dib = struct.unpack("<I", head[14:18])[0]
            if dib == 12:
                return struct.unpack("<HH", head[18:22])
            w, h = struct.unpack("<ii", head[18:26])
            return w, abs(h)
        if head[:2] == b"\xff\xd8":
            f.seek(2)
            while f.read(1) == b"\xff":
                b = f.read(1)
                while b == b"\xff":  # fill bytes before a marker
                    b = f.read(1)
                if not b:
                    break
                marker = b[0]
                if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
                    continue  # no length field
                seg = f.read(2)
                if len(seg) < 2:
                    break
                length = struct.unpack(">H", seg)[0]
                if marker in _JPEG_SOF:
                    sof = f.read(5)
                    if len(sof) < 5:
                        break
                    h, w = struct.unpack(">HH", sof[1:5])
                    return w, h
                f.seek(length - 2, 1)
            raise ImageDecodeError(f"{path}: no SOF marker in the JPEG file")
    raise NotImplementedError(f"{path}: not a PNG, BMP or JPEG file")
