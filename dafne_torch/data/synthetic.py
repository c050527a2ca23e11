"""Procedural rotated-object scenes, numpy only.

Two families, registered with the JAX package's names, sizes and metadata:

- ``synthetic_{train,val,test}`` (64, 16 and 16 scenes at 256^2, 3
  classes): the data-free smoke recipe's set (``configs/synthetic/
  base.yaml``), a copy of ``dafne_tpu/data/datasets/synthetic.py``
  :21-78.  The same random draws in the same order, and the quads filled
  by ``data/raster.py::fill_poly``, which draws what ``cv2.fillPoly``
  draws: the same records and the same pixels for every seed.
- ``synthetic_gen_{train,val,test}`` (256^2) and
  ``synthetic_gen1024_{train,val,test}`` (1024^2, up to 96 objects): a
  copy of ``_make_gen_record`` for traffic on machines without OpenCV: the
  same random draws (so the same annotations for a seed), with shapes
  filled by point-in-polygon and point-in-ellipse tests on pixel centers
  instead of cv2.  Pixels need not match cv2's rasterizer.

Each registers ``sized``: with DEBUG.OVERFIT_NUM_IMAGES n only the first n
scenes are made.
"""

from __future__ import annotations

from typing import List

import numpy as np

from dafne_torch.data.raster import fill_poly
from dafne_torch.data.registry import DatasetCatalog, MetadataCatalog

CLASSES = ["disk", "square", "stripe"]


def _make_record(seed: int, hw: int = 256, max_boxes: int = 6) -> dict:
    """One scene: noise below 60 and 1 to `max_boxes` rotated rectangles,
    each a gray level that names its class."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(hw, hw, 3) * 60).astype(np.uint8)
    n = rng.randint(1, max_boxes + 1)
    annos = []
    for _ in range(n):
        cls = rng.randint(len(CLASSES))
        cx, cy = rng.uniform(40, hw - 40, 2)
        w = rng.uniform(20, 60)
        h = rng.uniform(12, 40)
        ang = rng.uniform(0, np.pi)
        quad = _rot_rect(cx, cy, w, h, ang)
        color = [int(60 + 60 * cls + rng.randint(40)) % 255] * 3
        fill_poly(img, quad.astype(np.int32), color)
        xs, ys = quad[:, 0], quad[:, 1]
        annos.append({
            "corners": quad.reshape(8).tolist(),
            "bbox": [xs.min(), ys.min(), xs.max(), ys.max()],
            "category_id": int(cls),
            "difficult": False,
            "area": float(w * h),
        })
    return {
        "image": img,
        "file_name": f"synthetic_{seed}.png",
        "image_id": f"syn{seed}",
        "height": hw,
        "width": hw,
        "annotations": annos,
    }


def load_synthetic(split: str, n: int = 64, hw: int = 256) -> List[dict]:
    """The first n scenes of a split."""
    base = {"train": 0, "val": 10_000, "test": 20_000}[split]
    return [_make_record(base + i, hw=hw) for i in range(n)]


def register_synthetic(cfg) -> None:
    """synthetic_{train,val,test}: 64, 16 and 16 scenes at 256^2 (with
    DEBUG.OVERFIT_NUM_IMAGES n only the first n are made), then the
    generator families."""
    for split, n in [("train", 64), ("val", 16), ("test", 16)]:
        name = f"synthetic_{split}"
        DatasetCatalog.register(name, lambda limit=None, s=split, k=n:
                                load_synthetic(s, min(k, limit or k)), sized=True)
        MetadataCatalog[name] = {
            "evaluator_type": "synthetic",
            "thing_classes": CLASSES,
            "split": split,
            "is_test": False,
        }
    register_synthetic_gen(cfg)


GEN_CLASSES = ["stripe", "square", "ellipse", "ring", "smallrect", "wedge"]

#: per-class (aspect_lo, aspect_hi, long_side_lo, long_side_hi, base_intensity)
_GEN_SPECS = {
    0: (3.5, 6.0, 48, 96, 205),
    1: (1.0, 1.25, 26, 52, 125),
    2: (1.6, 2.6, 34, 68, 170),
    3: (1.0, 1.6, 36, 64, 150),
    4: (1.5, 2.5, 15, 26, 235),
    5: (1.4, 2.2, 30, 60, 85),
}


def _rot_rect(cx, cy, w, h, ang):
    base = np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]])
    rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    return base @ rot.T + [cx, cy]


def _window(img, pts, pad=0):
    """Integer pixel window covering pts (clipped to the image) and the
    pixel-center grid over it."""
    hw = img.shape[0]
    x0 = int(max(np.floor(pts[:, 0].min()) - pad, 0))
    x1 = int(min(np.ceil(pts[:, 0].max()) + pad + 1, hw))
    y0 = int(max(np.floor(pts[:, 1].min()) - pad, 0))
    y1 = int(min(np.ceil(pts[:, 1].max()) + pad + 1, hw))
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    return (slice(y0, y1), slice(x0, x1)), xx, yy


def _in_convex(poly, xx, yy):
    """Pixels inside a convex polygon (either winding)."""
    n = len(poly)
    cr = [
        (poly[(k + 1) % n, 0] - poly[k, 0]) * (yy - poly[k, 1])
        - (poly[(k + 1) % n, 1] - poly[k, 1]) * (xx - poly[k, 0])
        for k in range(n)
    ]
    return np.all([c >= 0 for c in cr], 0) | np.all([c <= 0 for c in cr], 0)


def _fill(img, mask, win, color):
    img[win][mask] = color


def _make_gen_record(seed: int, hw: int = 256, max_boxes: int = 10) -> dict:
    rng = np.random.RandomState(seed)
    img = (rng.rand(hw, hw, 3) * 55).astype(np.float32)
    gdir = rng.uniform(0, 2 * np.pi)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    img += ((np.cos(gdir) * xx + np.sin(gdir) * yy) * rng.uniform(0, 45))[..., None]

    n = rng.randint(3, max_boxes + 1)
    centers: List[np.ndarray] = []
    annos = []
    for _ in range(n):
        cls = rng.randint(len(GEN_CLASSES))
        a_lo, a_hi, s_lo, s_hi, inten = _GEN_SPECS[cls]
        w = rng.uniform(s_lo, s_hi)
        h = w / rng.uniform(a_lo, a_hi)
        margin = max(w, h) / 2 + 4
        for _try in range(12):
            c = rng.uniform(margin, hw - margin, 2)
            if all(np.hypot(*(c - p)) > 22 for p in centers):
                break
        centers.append(c)
        ang = rng.uniform(0, np.pi)
        quad = _rot_rect(c[0], c[1], w, h, ang)
        tint = np.clip(inten + rng.uniform(-22, 22) + rng.uniform(-28, 28, 3), 0, 255)
        win, gx, gy = _window(img, quad)
        if cls == 2:  # ellipse inscribed in the rotated rect
            u = (gx - c[0]) * np.cos(ang) + (gy - c[1]) * np.sin(ang)
            v = -(gx - c[0]) * np.sin(ang) + (gy - c[1]) * np.cos(ang)
            mask = (u / (w / 2)) ** 2 + (v / (h / 2)) ** 2 <= 1.0
        elif cls == 3:  # rectangular ring: the rect minus an inset rect
            t = max(3, int(min(w, h) / 4))
            inner = _rot_rect(c[0], c[1], max(w - t, 0), max(h - t, 0), ang)
            win, gx, gy = _window(img, quad, pad=t // 2 + 1)
            outer = _rot_rect(c[0], c[1], w + t, h + t, ang)
            mask = _in_convex(outer, gx, gy) & ~_in_convex(inner, gx, gy)
        elif cls == 5:  # wedge: the triangle over three of the corners
            mask = _in_convex(quad[:3], gx, gy)
        else:
            mask = _in_convex(quad, gx, gy)
        _fill(img, mask, win, tint)
        xs, ys = quad[:, 0], quad[:, 1]
        annos.append({
            "corners": quad.reshape(8).tolist(),
            "bbox": [xs.min(), ys.min(), xs.max(), ys.max()],
            "category_id": int(cls),
            "difficult": False,
            "area": float(w * h),
        })
    # unannotated clutter: small speckles that must not be detected
    for _ in range(rng.randint(0, 6)):
        p = rng.uniform(4, hw - 4, 2).astype(int)
        r = rng.randint(1, 4)
        color = rng.uniform(0, 255, 3)
        win, gx, gy = _window(img, np.array([p - r, p + r], np.float64))
        _fill(img, (gx - p[0]) ** 2 + (gy - p[1]) ** 2 <= r * r, win, color)

    return {
        "image": np.clip(img, 0, 255).astype(np.uint8),
        "image_id": f"syngen{seed}",
        "height": hw,
        "width": hw,
        "annotations": annos,
    }


def load_synthetic_gen(split: str, n: int, hw: int = 256, max_boxes: int = 10) -> List[dict]:
    """n scenes of a split; train/val/test seed spaces are disjoint."""
    base = {"train": 0, "val": 500_000, "test": 600_000}[split]
    return [_make_gen_record(base + i, hw=hw, max_boxes=max_boxes) for i in range(n)]


def register_synthetic_gen(cfg) -> None:
    """synthetic_gen_{train,val,test}: 2048, 64 and 64 scenes at 256^2;
    DEBUG.OVERFIT_NUM_IMAGES truncates them downstream like any dataset."""
    for split, n in [("train", 2048), ("val", 64), ("test", 64)]:
        name = f"synthetic_gen_{split}"
        DatasetCatalog.register(name, lambda limit=None, s=split, k=n:
                                load_synthetic_gen(s, min(k, limit or k)), sized=True)
        MetadataCatalog[name] = {
            "evaluator_type": "synthetic",
            "thing_classes": GEN_CLASSES,
            "split": split,
            "is_test": False,
        }
    register_synthetic_gen1024(cfg)


#: memo of the 1024^2 scenes: the pipeline treats records as read-only
_GEN1024_CACHE: dict = {}


def _load_synthetic_gen1024(split: str, n: int) -> List[dict]:
    key = (split, n)
    if key not in _GEN1024_CACHE:
        _GEN1024_CACHE[key] = load_synthetic_gen(split, n, hw=1024, max_boxes=96)
    return _GEN1024_CACHE[key]


def register_synthetic_gen1024(cfg) -> None:
    """synthetic_gen1024_{train,val,test}: 512, 64 and 64 scenes at 1024^2
    with up to 96 objects, the deployment-scale canvas; with
    DEBUG.OVERFIT_NUM_IMAGES n only the first n are made."""
    for split, n in [("train", 512), ("val", 64), ("test", 64)]:
        name = f"synthetic_gen1024_{split}"
        DatasetCatalog.register(name, lambda limit=None, s=split, k=n:
                                _load_synthetic_gen1024(s, min(k, limit or k)), sized=True)
        MetadataCatalog[name] = {
            "evaluator_type": "synthetic",
            "thing_classes": GEN_CLASSES,
            "split": split,
            "is_test": False,
        }
