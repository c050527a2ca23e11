"""Write the JPEG fixtures of this folder and their manifest.

    python tests/data/jpeg/write_fixtures.py

Each fixture is encoded with OpenCV or PIL in one of the modes the port's
decoder covers (``dafne_torch/csrc/jpeg_decode.cpp``), and
``fixtures.json`` records, for each, the SHA-256 and shape of the pixels
``cv2.imread(path, cv2.IMREAD_COLOR)`` gives, so that a machine without
OpenCV can hold the port's decode to them (``chip_smoke.py``'s JPEG
phase).  The four 1280x720 images carry dark rotated "text lines" whose
corners (and a "###" mark on the unreadable ones) the manifest lists, for
an ICDAR-2015 tree written from them.  The pixels are drawn from a fixed
seed; the encoders' output is what the installed OpenCV and PIL write.
"""

import hashlib
import io
import json
import os
import struct

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))


def scene(h, w, rng):
    """A smooth colour gradient with mild noise."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 90 * np.sin(x / 37.0 + y / 53.0), 100 + 0.1 * x + 0.05 * y,
                    160 - 80 * np.cos(y / 29.0)], -1)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def text_scene(rng, n=6):
    """A 1280x720 scene with n dark rotated text lines; (image, [(corners,
    unreadable)])."""
    img = scene(720, 1280, rng)
    lines = []
    for i in range(n):
        cx, cy = rng.uniform(200, 1080), rng.uniform(120, 600)
        w, h, ang = rng.uniform(120, 320), rng.uniform(24, 48), rng.uniform(-0.4, 0.4)
        c, s = np.cos(ang), np.sin(ang)
        quad = np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]])
        quad = quad @ np.array([[c, s], [-s, c]]) + [cx, cy]
        pts = np.round(quad).astype(np.int32)
        cv2.fillPoly(img, [pts], (20, 20, 30))
        for k in range(1, 8):  # light strokes across the line, text-like
            t = k / 8.0
            a = (pts[0] * (1 - t) + pts[1] * t).astype(int)
            b = (pts[3] * (1 - t) + pts[2] * t).astype(int)
            cv2.line(img, tuple(map(int, a)), tuple(map(int, b)), (220, 220, 210), 3)
        lines.append((pts.reshape(8).tolist(), i % 3 == 2))
    return img, lines


def cv2_jpeg(img, **kw):
    params = []
    for key, value in kw.items():
        params += [getattr(cv2, f"IMWRITE_JPEG_{key.upper()}"), value]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def pil_jpeg(img, **kw):
    out = io.BytesIO()
    Image.fromarray(img[:, :, ::-1] if img.ndim == 3 else img).save(out, "JPEG", **kw)
    return out.getvalue()


def as_sof1(data):
    """The same stream with its SOF0 marker renamed SOF1 (extended
    sequential) and its quantization tables written with 16-bit entries."""
    out, pos = bytearray(data[:2]), 2
    while pos < len(data):
        marker, length = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos:pos + 2 + length]
        if marker == 0xC0:
            seg = b"\xff\xc1" + seg[2:]
        elif marker == 0xDB:
            body, tables = seg[4:], b""
            while body:
                tables += bytes([0x10 | body[0] & 15]) + np.frombuffer(body[1:65], np.uint8).astype(">u2").tobytes()
                body = body[65:]
            seg = b"\xff\xdb" + struct.pack(">H", len(tables) + 2) + tables
        out += seg
        pos += 2 + length
        if marker == 0xDA:
            out += data[pos:]
            break
    return bytes(out)


def main():
    rng = np.random.RandomState(2015)
    exif = Image.Exif()
    exif[0x0112] = 6
    files = {
        "base_444_q95.jpg": ("baseline 4:4:4, quality 95", cv2_jpeg(scene(61, 97, rng), quality=95, sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)),
        "base_422_q75.jpg": ("baseline 4:2:2, quality 75", cv2_jpeg(scene(43, 61, rng), quality=75, sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)),
        "base_420_q50.jpg": ("baseline 4:2:0, quality 50", cv2_jpeg(scene(17, 33, rng), quality=50, sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)),
        "base_440_q85.jpg": ("baseline 4:4:0, quality 85", cv2_jpeg(scene(29, 45, rng), quality=85, sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)),
        "prog_420.jpg": ("progressive 4:2:0", cv2_jpeg(scene(53, 77, rng), progressive=1)),
        "rst_420.jpg": ("baseline 4:2:0, restart interval 3", cv2_jpeg(scene(40, 64, rng), rst_interval=3)),
        "opt_pil_420.jpg": ("optimized Huffman tables (PIL), 4:2:0", pil_jpeg(scene(35, 50, rng), quality=80, optimize=True, subsampling=2)),
        "prog_pil_422.jpg": ("progressive 4:2:2 (PIL)", pil_jpeg(scene(30, 41, rng), quality=70, progressive=True, subsampling=1)),
        "gray.jpg": ("grayscale", cv2_jpeg(scene(23, 31, rng)[:, :, 1])),
        "gray_prog.jpg": ("grayscale progressive", cv2_jpeg(scene(19, 27, rng)[:, :, 0], progressive=1)),
        "one_pixel.jpg": ("1x1, 4:2:0", cv2_jpeg(scene(1, 1, rng))),
        "odd_7x13.jpg": ("7x13, 4:2:0", cv2_jpeg(scene(7, 13, rng))),
        "exif6.jpg": ("EXIF orientation 6 (turned on decode)", pil_jpeg(scene(21, 34, rng), exif=exif.tobytes())),
        "sof1.jpg": ("extended sequential (SOF1), 16-bit quantization tables", as_sof1(cv2_jpeg(scene(24, 40, rng)))),
    }
    prog = cv2_jpeg(scene(48, 64, rng), progressive=1)
    files["prog_cut.jpg"] = ("progressive cut off in its 4th scan (block smoothing)", prog[: len(prog) // 2])
    base = cv2_jpeg(scene(48, 64, rng))
    files["base_cut.jpg"] = ("baseline cut off mid-scan (the rest gray)", base[: len(base) * 2 // 3])
    icdar = {}
    for i, (mode, kw) in enumerate([
            ("baseline 4:2:0, quality 90", dict(quality=90)),
            ("progressive 4:2:0, quality 85", dict(quality=85, progressive=1)),
            ("baseline 4:4:4, restart interval 8, quality 80",
             dict(quality=80, sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, rst_interval=8)),
            ("optimized 4:2:2 (PIL), quality 85", None)], start=1):
        img, lines = text_scene(rng)
        data = cv2_jpeg(img, **kw) if kw is not None else pil_jpeg(img, quality=85, optimize=True, subsampling=1)
        name = f"text_{i}.jpg"
        files[name] = (f"1280x720 {mode}", data)
        icdar[name] = [{"corners": c, "unreadable": u} for c, u in lines]
    manifest = {"files": {}, "icdar": icdar}
    for name, (mode, data) in files.items():
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        pixels = cv2.imread(path, cv2.IMREAD_COLOR)
        assert pixels is not None, name
        manifest["files"][name] = {"mode": mode, "shape": list(pixels.shape),
                                   "sha256": hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()}
    with open(os.path.join(HERE, "fixtures.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    total = sum(len(d) for _, d in files.values())
    print(f"{len(files)} fixtures, {total} bytes")


if __name__ == "__main__":
    main()
