"""Dataset mapper: record dict -> static-shape example, train or eval.

Counterpart of ``dafne_tpu/data/mapper.py`` (``DatasetMapper.__call__``
:113-262 with its device-aug branch :87-110, :144-210, :265-301,
``_sort_quad_np`` :26, ``_shoelace`` :68, ``device_aug_base_hw`` :304,
``eval_pad_hw`` :335-362):

  augmentation (``data/transforms.py``: the random train map, or the
  test-time resize) -> corners transformed exactly -> degenerate instances
  dropped -> canonical corner sort (SORT_CORNERS_DATALOADER) -> shoelace
  area -> gts padded to MAX_INSTANCES, the image placed top-left on a zero
  (pad_h, pad_w) canvas, with the record's image_id, its original and
  resized sizes and the resized-to-original scale.

With ``device_aug`` (``TPU.TRAIN_DEVICE_AUG``) a train example carries the
unwarped base image ("image_base", transposed on the host when the draw
is anti-diagonal) and the draw's separable-warp taps ("aug_*", and the
color-jitter draws with INPUT.USE_COLOR_AUGMENTATIONS) instead of a
rendered "image"; the train step renders it on the device.  Corners still
transform exactly on the host.

A record carries its image as a uint8 array (``record["image"]``), or
names its file (``record["file_name"]``), decoded with
``data/image_io.py::read_image`` in INPUT.FORMAT by the thread that maps
it (:135).  The decoded image's own size drives the augmentation, as in the
JAX package; a rendered image larger than the canvas (a record whose
width and height disagree with its file) is cropped with one warning.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np

from dafne_torch.data import transforms as T
from dafne_torch.data.image_io import read_image
from dafne_torch.ops.device_warp import WARP_KEYS, draw_color_params, separable_warp_params


def _sort_quad_np(corners: np.ndarray) -> np.ndarray:
    """Canonical corner order of quads [N, 8], the numpy mirror of
    ``geometry.quads.sort_quadrilateral``."""
    c = corners.reshape(-1, 4, 2)
    n = c.shape[0]
    if n == 0:
        return corners
    ar4 = np.arange(4)
    left_idx = np.argmin(c[:, :, 0], axis=1)
    p1 = c[np.arange(n), left_idx]
    keep = ar4[None, :] != left_idx[:, None]
    rem_idx = np.sort(np.where(keep, ar4[None, :], 99), axis=1)[:, :3]
    rem = np.take_along_axis(c, rem_idx[:, :, None], axis=1)  # [N, 3, 2]
    v = rem - p1[:, None, :]

    def cr(a, b):
        return a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]

    conds = np.stack(
        [
            cr(v[:, 0], v[:, 1]) * cr(v[:, 0], v[:, 2]) < 0,
            cr(v[:, 1], v[:, 0]) * cr(v[:, 1], v[:, 2]) < 0,
            cr(v[:, 2], v[:, 0]) * cr(v[:, 2], v[:, 1]) < 0,
        ],
        axis=1,
    )
    first = np.argmax(conds, axis=1)
    p3 = rem[np.arange(n), first]
    sa = rem[np.arange(n), np.where(first == 0, 1, 0)]
    sb = rem[np.arange(n), np.where(first == 2, 1, 2)]
    diag = p3 - p1
    ca = cr(diag, sa - p1)
    cb = cr(diag, sb - p1)
    take_a = (ca > 0) | ((ca <= 0) & (cb <= 0))
    p2 = np.where(take_a[:, None], sa, sb)
    p4 = np.where(take_a[:, None], sb, sa)
    return np.stack([p1, p2, p3, p4], axis=1).reshape(-1, 8)


def _shoelace(corners: np.ndarray) -> np.ndarray:
    x = corners[:, 0::2]
    y = corners[:, 1::2]
    return 0.5 * np.abs((x * np.roll(y, -1, axis=1)).sum(1) - (y * np.roll(x, -1, axis=1)).sum(1))


class DatasetMapper:
    """Callable record -> train or eval example (numpy arrays); with
    `device_aug` (train only) the example is a device-aug one."""

    def __init__(self, cfg, pad_hw: Tuple[int, int], train: bool = True,
                 device_aug: bool = False):
        self.cfg = cfg
        self.train = train
        self.pad_h, self.pad_w = pad_hw
        self.max_inst = cfg.TPU.MAX_INSTANCES
        self.sort_corners = cfg.MODEL.DAFNE.SORT_CORNERS_DATALOADER
        self.fmt = cfg.INPUT.FORMAT
        self.color_aug = cfg.INPUT.USE_COLOR_AUGMENTATIONS and train
        self.device_aug = device_aug and train
        # cache decoded uint8 images on the record dicts (small datasets;
        # DOTA-scale train sets should leave this off)
        self.cache_images = cfg.DATALOADER.CACHE_IMAGES
        self._crop_warned = False

    def __call__(self, record: Dict, rng: Optional[np.random.RandomState] = None,
                 image_out: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """`rng` draws the train augmentation (unused at eval).  `image_out`:
        an optional zeroed uint8 buffer (a slice of the batch) to render
        into, [pad_h, pad_w, 3], or with device aug a base canvas that holds
        the base image; the example's "image" (or "image_base") is it."""
        rng = rng or np.random.RandomState()
        if "image" in record:  # in-memory records, or cached
            img = record["image"]
        else:
            img = read_image(record["file_name"], self.fmt)
            if self.cache_images:
                record["image"] = img
        h, w = img.shape[:2]
        if self.train:
            aug = T.build_train_augmentations(self.cfg, w, h, rng)
        else:
            aug = T.build_test_augmentation(self.cfg, w, h)
        if self.device_aug:
            transpose, aug_params = self._device_aug_params(aug, w, h, rng)
        else:
            img = aug.apply_image(img)
            if self.color_aug:
                img = T.apply_color_augmentations(img, rng)

        annos = record.get("annotations", [])
        corners = np.asarray([a["corners"] for a in annos], dtype=np.float64).reshape(-1, 8)
        classes = np.asarray([a["category_id"] for a in annos], dtype=np.int32)
        difficult = np.asarray([a.get("difficult", False) for a in annos], dtype=bool)
        if len(corners):
            corners = aug.apply_coords(corners.reshape(-1, 4, 2)).reshape(-1, 8)
            # filter_empty_instances: the enclosing hbox must not be degenerate
            xs, ys = corners[:, 0::2], corners[:, 1::2]
            keep = (xs.max(1) - xs.min(1) > 1e-3) & (ys.max(1) - ys.min(1) > 1e-3)
            corners, classes, difficult = corners[keep], classes[keep], difficult[keep]
        if len(corners) and self.sort_corners:
            corners = _sort_quad_np(corners)

        n = min(len(corners), self.max_inst)
        gt_corners = np.zeros((self.max_inst, 8), np.float32)
        gt_hbox = np.zeros((self.max_inst, 4), np.float32)
        gt_classes = np.zeros((self.max_inst,), np.int32)
        gt_area = np.zeros((self.max_inst,), np.float32)
        gt_valid = np.zeros((self.max_inst,), bool)
        gt_difficult = np.zeros((self.max_inst,), bool)
        if n:
            c = corners[:n].astype(np.float32)
            gt_corners[:n] = c
            xs, ys = c[:, 0::2], c[:, 1::2]
            gt_hbox[:n] = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], axis=1)
            gt_classes[:n] = classes[:n]
            gt_area[:n] = _shoelace(c)
            gt_valid[:n] = True
            gt_difficult[:n] = difficult[:n]
        gts = {"gt_corners": gt_corners, "gt_hbox": gt_hbox, "gt_classes": gt_classes,
               "gt_area": gt_area, "gt_valid": gt_valid, "gt_difficult": gt_difficult}

        if self.device_aug:
            rh, rw = aug.out_h, aug.out_w
            base = np.ascontiguousarray(img.transpose(1, 0, 2)) if transpose else img
            bh, bw = base.shape[:2]
            canvas = image_out if image_out is not None else np.zeros((bh, bw, 3), np.uint8)
            if bh > canvas.shape[0] or bw > canvas.shape[1]:
                raise ValueError(f"base image ({bh}, {bw}) exceeds the device-aug base canvas "
                                 f"{canvas.shape[:2]}")
            canvas[:bh, :bw] = base
            return {"image_base": canvas, **aug_params, **gts, **self._meta(record, h, w, rh, rw)}

        rh, rw = img.shape[:2]
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        if (rh > self.pad_h or rw > self.pad_w) and not self._crop_warned:
            # the canvas is sized from the records' width and height
            self._crop_warned = True
            logging.getLogger("dafne_torch").warning(
                "resized image (%d, %d) exceeds the static canvas (%d, %d) and is cropped: a "
                "record's width/height likely disagrees with its file", rh, rw, self.pad_h,
                self.pad_w)
        canvas = image_out if image_out is not None else np.zeros(
            (self.pad_h, self.pad_w, 3), np.uint8)
        canvas[:rh, :rw] = img[:self.pad_h, :self.pad_w]
        return {"image": canvas, **gts, **self._meta(record, h, w, rh, rw)}

    @staticmethod
    def _meta(record, h, w, rh, rw) -> Dict:
        return {
            "image_id": record.get("image_id", ""),
            "orig_hw": np.asarray([h, w], np.int32),
            "resized_hw": np.asarray([rh, rw], np.int32),
            # resized -> original scale, to rescale predictions at eval
            "scale_xy": np.asarray([w / rw, h / rh], np.float32),
        }

    def _device_aug_params(self, aug, w, h, rng) -> Tuple[bool, Dict]:
        """(whether the base is transposed, the example's vectors): this
        draw's warp taps onto the (pad_h, pad_w) canvas, its output extent
        and, with color aug, the jitter draws (taken from `rng` where the
        host path's ``apply_color_augmentations`` takes them)."""
        warp = separable_warp_params(aug, w, h, (self.pad_h, self.pad_w))
        if warp is None:
            raise RuntimeError("TPU.TRAIN_DEVICE_AUG drew a non-separable augmentation; "
                               "transforms.train_geometric_augs_separable should have refused it")
        out = {"aug_out_hw": np.asarray([warp.out_h, warp.out_w], np.int32)}
        out.update({"aug_" + k: getattr(warp, k) for k in WARP_KEYS})
        if self.color_aug:
            out.update(draw_color_params(rng))
        return warp.transpose, out


def device_aug_base_hw(records) -> Optional[Tuple[int, int]]:
    """The static base canvas of device aug: the largest source side over
    the records, squared (square because anti-diagonal draws transpose the
    base).  None when a record has neither its size nor its image."""
    s = 0
    for r in records:
        w, h = r.get("width"), r.get("height")
        if (not w or not h) and "image" in r:
            h, w = r["image"].shape[:2]
        if not w or not h:
            return None
        s = max(s, int(w), int(h))
    return (s, s) if s else None


def pad_target_hw(cfg, train: bool) -> Tuple[int, int]:
    """The static canvas of a config: the largest resize, rounded up to
    TPU.IMAGE_SIZE_DIVISIBILITY."""
    div = cfg.TPU.IMAGE_SIZE_DIVISIBILITY
    if cfg.INPUT.RESIZE_TYPE == "both":
        h = cfg.INPUT.RESIZE_HEIGHT_TRAIN if train else cfg.INPUT.RESIZE_HEIGHT_TEST
        w = cfg.INPUT.RESIZE_WIDTH_TRAIN if train else cfg.INPUT.RESIZE_WIDTH_TEST
    else:
        h = w = cfg.INPUT.MAX_SIZE_TRAIN if train else cfg.INPUT.MAX_SIZE_TEST
    return int(-(-h // div) * div), int(-(-w // div) * div)


def eval_pad_hw(cfg, records) -> Tuple[int, int]:
    """The tight static eval canvas: the largest resized extent over the
    records (from their width and height), rounded up to
    TPU.IMAGE_SIZE_DIVISIBILITY and capped at ``pad_target_hw``; that
    worst case when a record carries neither its size nor its image."""
    worst = pad_target_hw(cfg, train=False)
    div = cfg.TPU.IMAGE_SIZE_DIVISIBILITY
    mh = mw = 0
    for r in records:
        w, h = r.get("width"), r.get("height")
        if not w or not h:
            if "image" not in r:
                return worst
            h, w = r["image"].shape[:2]
        aug = T.build_test_augmentation(cfg, int(w), int(h))
        mh = max(mh, aug.out_h)
        mw = max(mw, aug.out_w)
    if mh == 0:
        return worst
    return min(-(-mh // div) * div, worst[0]), min(-(-mw // div) * div, worst[1])
