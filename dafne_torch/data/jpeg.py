"""JPEG files to uint8 arrays, without cv2 or PIL.

The JPEG half of ``data/image_io.py``: what ``cv2.imread(path,
cv2.IMREAD_COLOR)`` gives for a JPEG file, byte for byte.  OpenCV decodes
with libjpeg-turbo (islow IDCT, fancy upsampling, its YCbCr tables) and
then turns the image as the EXIF orientation tag says; so does this
module:

- ``decode(path, data, max_pixels)``: the host library
  ``csrc/jpeg_decode.cpp`` (built with g++ at first use, called through
  ctypes, which drops the GIL) decodes into [H, W, 3] BGR, after the frame
  header has been read and the pixel cap checked, so that nothing is
  allocated for an image over the cap; then ``orient``.
- ``decode_plain(path, data)``: the same arithmetic spelled out in NumPy
  and Python (entropy decoding bit by bit, dequantization, the integer
  IDCT, upsampling, colour conversion), for the tests at small sizes.
  Nothing on the main path calls it.
- ``exif_orientation(data)``: the orientation OpenCV reads, from the
  first APP1 segment before the first scan (OpenCV's ``ExifReader``).

A stream the library refuses raises ``ImageDecodeError`` (where
``cv2.imread`` returns None); what it does not cover (arithmetic coding,
lossless, 12-bit, CMYK/YCCK, sampling factors above 2, a progressive file
cut off before its last scans) raises ``NotImplementedError``; both name
the file.  Data that runs out inside a scan decodes as libjpeg decodes it:
the rest of the segment as zeros, a flat gray.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Dict, List, Tuple

import numpy as np

from dafne_torch.data.image_io import ImageDecodeError, check_pixels

_COUNT_LOCK = threading.Lock()
_ERR_LEN = 256


def reset_launch_counts() -> None:
    decode.launches = 0


def _lib():
    from dafne_torch.ops.kernels import build

    lib = build.load("jpeg_decode")
    if not getattr(lib, "_dafne_typed", False):
        i, p = ctypes.c_int64, ctypes.c_void_p
        lib.jpeg_header.argtypes = [ctypes.c_char_p, i, p, ctypes.c_char_p, i]
        lib.jpeg_header.restype = i
        lib.jpeg_decode.argtypes = [ctypes.c_char_p, i, p, p, ctypes.c_char_p, i]
        lib.jpeg_decode.restype = i
        lib._dafne_typed = True
    return lib


def _raise(path: str, status: int, err) -> None:
    msg = f"{path}: {err.value.decode('utf-8', 'replace')}"
    if status == 2:
        raise NotImplementedError(msg)
    raise ImageDecodeError(msg)


def header(path: str, data: bytes) -> Tuple[int, int, int, int]:
    """(width, height, components, SOF marker) from the markers before the
    first scan."""
    info = np.zeros(4, np.int64)
    err = ctypes.create_string_buffer(_ERR_LEN)
    status = _lib().jpeg_header(data, len(data), info.ctypes.data, err, _ERR_LEN)
    if status:
        _raise(path, status, err)
    return tuple(int(v) for v in info)


def decode(path: str, data: bytes, max_pixels: int) -> np.ndarray:
    """[H, W, 3] uint8 BGR of a JPEG file's bytes, turned as its EXIF
    orientation says: ``cv2.imread(path, cv2.IMREAD_COLOR)``."""
    w, h, _, _ = header(path, data)
    check_pixels(path, w, h, max_pixels)
    out = np.empty((h, w, 3), np.uint8)
    info = np.zeros(1, np.int64)
    err = ctypes.create_string_buffer(_ERR_LEN)
    status = _lib().jpeg_decode(data, len(data), out.ctypes.data, info.ctypes.data, err, _ERR_LEN)
    with _COUNT_LOCK:
        decode.launches += 1
    if status:
        _raise(path, status, err)
    return orient(out, exif_orientation(data))


decode.launches = 0


# ---- EXIF orientation ---------------------------------------------------------

def exif_orientation(data: bytes) -> int:
    """The EXIF orientation (1-8; 1 when there is none or it cannot be
    read) of the first APP1 segment before the first scan, read as a TIFF
    header 6 bytes into the segment, as OpenCV reads it."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in (0xDA, 0xD9):
            return 1
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xE1:
            return _tiff_orientation(data[pos + 4 + 6:pos + 2 + length])
        pos += 2 + length
    return 1


def _tiff_orientation(tiff: bytes) -> int:
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    if struct.unpack(e + "H", tiff[2:4])[0] != 0x2A:
        return 1
    ifd = struct.unpack(e + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 1
    n = struct.unpack(e + "H", tiff[ifd:ifd + 2])[0]
    for k in range(n):
        entry = ifd + 2 + 12 * k
        if entry + 12 > len(tiff):
            return 1
        if struct.unpack(e + "H", tiff[entry:entry + 2])[0] == 0x0112:
            value = struct.unpack(e + "H", tiff[entry + 8:entry + 10])[0]
            return value if 1 <= value <= 8 else 1
    return 1


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """The decoded image turned to the EXIF orientation, as OpenCV's
    ``ApplyExifOrientation``: 2 flips left-right, 3 turns half way, 4 flips
    upside down, 5-8 transpose first and then flip as 1-4 do."""
    if orientation >= 5:
        img = img.transpose(1, 0, 2)
        orientation -= 4
    if orientation == 2:
        img = img[:, ::-1]
    elif orientation == 3:
        img = img[::-1, ::-1]
    elif orientation == 4:
        img = img[::-1]
    return np.ascontiguousarray(img)


# ---- the plain version ------------------------------------------------------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63] + [63] * 16)


class _Bits:
    """The entropy-coded bits of a scan: bytes up to the next marker with
    FF 00 read as FF, then zeros for ever (``insufficient`` says the zeros
    were reached)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos
        self.acc, self.n, self.marker, self.insufficient = 0, 0, None, False

    def _byte(self) -> int:  # past the end the stream reads FF D9, as libjpeg's source gives it
        b = self.data[self.pos] if self.pos < len(self.data) else (0xFF if (self.pos - len(self.data)) % 2 == 0 else 0xD9)
        self.pos += 1
        return b

    def _next(self):
        """The next data byte, or None at a marker."""
        if self.marker is not None:
            return None
        c = self._byte()
        if c != 0xFF:
            return c
        c = self._byte()
        while c == 0xFF:  # fill bytes
            c = self._byte()
        if c == 0:
            return 0xFF
        self.marker = c
        return None

    def bit(self) -> int:
        if self.n == 0:
            c = self._next()
            if c is None:
                self.insufficient, c = True, 0
            self.acc, self.n = c, 8
        self.n -= 1
        return (self.acc >> self.n) & 1

    def bits(self, k: int) -> int:
        v = 0
        for _ in range(k):
            v = (v << 1) | self.bit()
        return v

    def restart(self) -> None:  # the bits left in the byte are dropped; the RSTn marker read
        self.n = 0
        if self.marker is None:
            while True:
                c = self._byte()
                if c != 0xFF:
                    continue
                while c == 0xFF:
                    c = self._byte()
                if c:
                    self.marker = c
                    break
        self.marker, self.insufficient = None, False


def _huffman(counts: List[int], vals: List[int]) -> Dict[Tuple[int, int], int]:
    """{(length, code): symbol} of a canonical Huffman table."""
    table, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            table[(length, code)] = vals[k]
            code, k = code + 1, k + 1
        code <<= 1
    return table


def _decode_symbol(bits: _Bits, table) -> int:
    code = 0
    for length in range(1, 17):
        code = (code << 1) | bits.bit()
        if (length, code) in table:
            return table[(length, code)]
    return 0  # a bad code reads as 0, as in libjpeg


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _segments(path: str, data: bytes):
    """(marker, payload, end) of each marker segment up to each SOS, and
    the SOS's with the position of its entropy-coded data."""
    pos = 2
    while pos < len(data):
        while data[pos] != 0xFF:
            pos += 1
        while data[pos] == 0xFF:
            pos += 1
        marker = data[pos]
        pos += 1
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:
            return
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        yield marker, data[pos + 2:pos + length], pos + length
        pos += length
        if marker == 0xDA:  # skip the entropy-coded data up to the next marker
            while pos + 1 < len(data) and not (data[pos] == 0xFF and data[pos + 1] not in (0,) and not 0xD0 <= data[pos + 1] <= 0xD7):
                pos += 1
    raise ImageDecodeError(f"{path}: no EOI marker")


def decode_plain(path: str, data: bytes) -> np.ndarray:
    """``decode`` in NumPy and Python: Huffman-coded 8-bit JPEG, sequential
    or progressive, 1 or 3 components, sampling factors 1 or 2, restart
    intervals; libjpeg's arithmetic restated step by step."""
    qt, dc_tab, ac_tab = {}, {}, {}
    comps, restart, jfif, adobe = [], 0, False, None
    coef = None
    progressive = single = False
    for marker, p, end in _segments(path, data):
        if marker == 0xE0 and p[:5] == b"JFIF\0" and len(p) >= 14:
            jfif = True
        elif marker == 0xEE and p[:5] == b"Adobe" and len(p) >= 12:
            adobe = p[11]
        elif marker == 0xDB:
            k = 0
            while k < len(p):
                prec, t = p[k] >> 4, p[k] & 15
                n = 128 if prec else 64
                vals = np.frombuffer(p[k + 1:k + 1 + n], ">u2" if prec else np.uint8).astype(np.int64)
                q = np.zeros(64, np.int64)
                q[_ZIGZAG[:64]] = vals
                qt[t] = q
                k += 1 + n
        elif marker == 0xC4:
            k = 0
            while k < len(p):
                idx, counts = p[k], list(p[k + 1:k + 17])
                vals = list(p[k + 17:k + 17 + sum(counts)])
                (ac_tab if idx & 0x10 else dc_tab)[idx & 15] = _huffman(counts, vals)
                k += 17 + sum(counts)
        elif marker == 0xDD:
            restart = struct.unpack(">H", p[:2])[0]
        elif marker in (0xC0, 0xC1, 0xC2):
            progressive = marker == 0xC2
            prec, h, w, n = struct.unpack(">BHHB", p[:6])
            if prec != 8 or n not in (1, 3):
                raise NotImplementedError(f"{path}: {prec}-bit or {n}-component JPEG")
            for i in range(n):
                cid, hv, tq = p[6 + 3 * i:9 + 3 * i]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
            hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps:
                c["bw"], c["bh"] = -(-w * c["h"] // (8 * hmax)), -(-h * c["v"] // (8 * vmax))
                c["dw"], c["dh"] = -(-w * c["h"] // hmax), -(-h * c["v"] // vmax)
                c["coef"] = np.zeros((mcuy * c["v"], mcux * c["h"], 64), np.int64)
        elif marker == 0xDA:
            ns = p[0]
            scan = []
            for i in range(ns):
                c = next(c for c in comps if c["id"] == p[1 + 2 * i])
                c.setdefault("q", qt[c["tq"]])
                scan.append((c, p[2 + 2 * i] >> 4, p[2 + 2 * i] & 15))
            ss, se, ah, al = p[1 + 2 * ns], p[2 + 2 * ns], p[3 + 2 * ns] >> 4, p[3 + 2 * ns] & 15
            if not progressive and ns == len(comps):
                single = True
            _scan(_Bits(data, end), scan, ss, se, ah, al, progressive, restart, dc_tab, ac_tab,
                  (mcux, mcuy))
            if single:
                break
    return _render(comps, w, h, hmax, vmax, jfif, adobe)


def _scan(bits, scan, ss, se, ah, al, progressive, restart, dc_tab, ac_tab, mcus):
    if len(scan) == 1:
        c = scan[0][0]
        units = [[(0, by, bx)] for by in range(c["bh"]) for bx in range(c["bw"])]
    else:
        units = [[(i, my * c["v"] + y, mx * c["h"] + x)
                  for i, (c, _, _) in enumerate(scan) for y in range(c["v"]) for x in range(c["h"])]
                 for my in range(mcus[1]) for mx in range(mcus[0])]
    pred = [0] * len(scan)
    eobrun = 0
    for u, unit in enumerate(units):
        if restart and u and u % restart == 0:
            bits.restart()
            pred, eobrun = [0] * len(scan), 0
        if bits.insufficient and not (progressive and ss == 0 and ah):
            continue
        for i, by, bx in unit:
            c, td, ta = scan[i]
            blk = c["coef"][by, bx]
            if not progressive or (ss == 0 and ah == 0):
                s = _decode_symbol(bits, dc_tab[td])
                diff = _extend(bits.bits(s), s) if s else 0
                pred[i] += diff
                blk[0] = np.int16(pred[i] << al if progressive else pred[i])
                if progressive:
                    continue
                k = 1
                while k < 64:
                    rs = _decode_symbol(bits, ac_tab[ta])
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        blk[_ZIGZAG[k]] = _extend(bits.bits(s), s)
                    elif r != 15:
                        break
                    else:
                        k += 15
                    k += 1
            elif ss == 0:  # DC refinement
                if bits.bit():
                    blk[0] |= 1 << al
            elif ah == 0:  # AC first
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    rs = _decode_symbol(bits, ac_tab[ta])
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        blk[_ZIGZAG[k]] = np.int16(_extend(bits.bits(s), s) << al)
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = (1 << r) + (bits.bits(r) if r else 0) - 1
                        break
                    k += 1
            else:
                eobrun = _refine_ac(bits, blk, ss, se, al, eobrun, ac_tab[ta])


def _refine_ac(bits, blk, ss, se, al, eobrun, table) -> int:
    p1, m1 = 1 << al, -(1 << al)

    def correct(pos):
        if bits.bit() and blk[pos] & p1 == 0:
            blk[pos] += p1 if blk[pos] >= 0 else m1

    k = ss
    if eobrun == 0:
        while k <= se:
            rs = _decode_symbol(bits, table)
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if bits.bit() else m1
            elif r != 15:
                eobrun = (1 << r) + (bits.bits(r) if r else 0)
                break
            while k <= se:
                pos = _ZIGZAG[k]
                if blk[pos]:
                    correct(pos)
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                blk[_ZIGZAG[k]] = s
            k += 1
    if eobrun:
        for kk in range(k, se + 1):
            if blk[_ZIGZAG[kk]]:
                correct(_ZIGZAG[kk])
        eobrun -= 1
    return eobrun


def _w16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def idct_islow_plain(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's accurate integer IDCT as its AVX2 version computes it
    (the one OpenCV runs) over blocks [..., 64] (natural order) with the
    quantization table q [64]: uint8 samples [..., 8, 8].  16-bit wraps of
    the dequantized values and of in0 +- in4, in7 + in3, in5 + in1; 32-bit
    wraps of the sums; 16-bit saturation after each pass, 8-bit before the
    +128."""
    c = _w16(coef.astype(np.int64) * q.astype(np.int16).astype(np.int64))
    c = c.reshape(coef.shape[:-1] + (8, 8))

    def one_d(x, shift):  # along axis -2
        r = [x[..., i, :] for i in range(8)]
        tmp2 = r[2] * 4433 + r[6] * (4433 - 15137)
        tmp3 = r[2] * (4433 + 6270) + r[6] * 4433
        tmp0, tmp1 = _w16(r[0] + r[4]) * 8192, _w16(r[0] - r[4]) * 8192
        t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
        z3, z4 = _w16(r[7] + r[3]), _w16(r[5] + r[1])
        z3p = z3 * (9633 - 16069) + z4 * 9633
        z4p = z3 * 9633 + z4 * (9633 - 3196)
        o0 = r[7] * (2446 - 7373) - r[1] * 7373 + z3p
        o1 = r[5] * (16819 - 20995) - r[3] * 20995 + z4p
        o2 = -r[5] * 20995 + r[3] * (25172 - 20995) + z3p
        o3 = -r[7] * 7373 + r[1] * (12299 - 7373) + z4p
        rnd = 1 << (shift - 1)
        out = [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3]
        wrap32 = [((v + rnd + 2**31) & 0xFFFFFFFF) - 2**31 for v in out]
        return np.stack([np.clip(v >> shift, -32768, 32767) for v in wrap32], axis=-2)

    dc_only = ~np.any(coef.reshape(coef.shape[:-1] + (8, 8))[..., 1:, :] != 0, axis=(-1, -2))
    ws = np.where(dc_only[..., None, None], _w16(c[..., :1, :] * 4), one_d(c, 11))
    x = np.swapaxes(one_d(np.swapaxes(ws, -1, -2), 18), -1, -2)  # pass 2 over the rows
    return (np.clip(x, -128, 127) + 128).astype(np.uint8)


def upsample_plain(plane: np.ndarray, dw: int, dh: int, rx: int, ry: int, w: int, h: int) -> np.ndarray:
    """A component's samples [dh.., dw..] to [h, w], as jdsample.c: the
    triangle filters where a factor is 2 (box filters for a component at
    most 2 samples wide where h is 2), edges replicated."""
    p = plane[:dh, :dw].astype(np.int64)
    ys, xs = np.arange(h), np.arange(w)
    if ry == 2:  # the nearer and the farther row of each output row
        near = ys >> 1
        far = np.where(ys & 1, np.minimum(near + 1, dh - 1), np.maximum(near - 1, 0))
    if rx == 1 and ry == 1:
        return p[:h, :w].astype(np.uint8)
    if rx == 1:
        bias = np.where(ys & 1, 2, 1)[:, None]
        return ((3 * p[near][:, :w] + p[far][:, :w] + bias) >> 2).astype(np.uint8)
    i = xs >> 1
    if dw <= 2:
        return p[(ys >> (ry - 1))][:, i].astype(np.uint8)
    left, right = np.maximum(i - 1, 0), np.minimum(i + 1, dw - 1)
    odd = (xs & 1).astype(bool)
    if ry == 1:
        rows = p[:h]
        return np.where(odd, (3 * rows[:, i] + rows[:, right] + 2) >> 2,
                        (3 * rows[:, i] + rows[:, left] + 1) >> 2).astype(np.uint8)
    col = 3 * p[near] + p[far]
    return np.where(odd, (3 * col[:, i] + col[:, right] + 7) >> 4,
                    (3 * col[:, i] + col[:, left] + 8) >> 4).astype(np.uint8)


def ycc_to_bgr_plain(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's YCbCr -> RGB in 16-bit fixed point, as BGR."""
    def fix(v):
        return int(v * 65536.0 + 0.5)

    half = 1 << 15
    y, cb, cr = (a.astype(np.int64) for a in (y, cb, cr))
    cb, cr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * cr + half) >> 16)
    g = y + ((-fix(0.34414) * cb + half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


def _render(comps, w, h, hmax, vmax, jfif, adobe) -> np.ndarray:
    planes = []
    for c in comps:
        if "q" in c:
            blocks = idct_islow_plain(c["coef"][:c["bh"], :c["bw"]], c["q"])  # [bh, bw, 8, 8]
            plane = blocks.transpose(0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)
        else:
            plane = np.full((c["bh"] * 8, c["bw"] * 8), 128, np.uint8)
        planes.append(upsample_plain(plane, c["dw"], c["dh"], hmax // c["h"], vmax // c["v"], w, h))
    if len(planes) == 1:
        return np.repeat(planes[0][:, :, None], 3, axis=2)
    ids = [c["id"] for c in comps]
    rgb = (adobe == 0) if (not jfif and adobe is not None) else (not jfif and ids == [82, 71, 66])
    if rgb:
        return np.stack(planes[::-1], axis=-1)
    return ycc_to_bgr_plain(*planes)
