"""Host-side train augmentations as composable affine maps, numpy only.

Counterpart of ``dafne_tpu/data/transforms.py``: ``AffineAug``,
``identity``, ``hflip``, ``vflip``, ``rotation``, ``resize``,
``shortest_edge_resize``, ``build_train_augmentations`` (:187, the same rng
draws in the same order), ``train_geometric_augs_separable`` (:248),
``build_test_augmentation`` (:264) and ``apply_color_augmentations``
(:284).  Every geometric augmentation is an affine map; the pipeline
composes into one matrix, corners transform exactly (and map back with
``AffineAug.invert_coords``), and the image is transformed once.

Images on the host (``AffineAug.apply_image``, JAX :61-130): a signed
permutation matrix (flips, 90-degree rotations, resizes) renders as a
transpose, ``data/image_warp.py::resize_linear`` and flips; any other
matrix (an arbitrary rotation) through ``warp_affine_linear``.  Both are
byte for byte cv2's INTER_LINEAR, so a host canvas equals the JAX
package's.  Separable draws may also render on the device
(``ops/device_warp.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from dafne_torch.data import image_warp as IW


@dataclasses.dataclass
class AffineAug:
    """An affine coordinate map (y = M @ [x, 1]) and the output image size."""

    matrix: np.ndarray  # [2, 3] float64
    out_w: int
    out_h: int

    def apply_coords(self, pts: np.ndarray) -> np.ndarray:
        """pts [..., 2] -> transformed [..., 2] (float64)."""
        shape = pts.shape
        p = pts.reshape(-1, 2).astype(np.float64)
        return (p @ self.matrix[:, :2].T + self.matrix[:, 2]).reshape(shape)

    def invert_coords(self, pts: np.ndarray) -> np.ndarray:
        """The inverse map: transformed pts [..., 2] -> source (float64)."""
        inv = np.linalg.inv(np.vstack([self.matrix, [0, 0, 1]]))[:2]
        shape = pts.shape
        p = pts.reshape(-1, 2).astype(np.float64)
        return (p @ inv[:, :2].T + inv[:, 2]).reshape(shape)

    def compose(self, other: "AffineAug") -> "AffineAug":
        """self followed by other."""
        a = np.vstack([self.matrix, [0, 0, 1]])
        b = np.vstack([other.matrix, [0, 0, 1]])
        return AffineAug((b @ a)[:2], other.out_w, other.out_h)

    def _axis_aligned_fast(self, img: np.ndarray) -> Optional[np.ndarray]:
        """The image under a signed-permutation matrix (flips, 90-degree
        rotations, per-axis scales) as transpose, resize and flips, or None
        when the linear part is not a signed (anti)diagonal, the scales do
        not map the source's extent exactly onto the output, or the
        translation is not the canonical flip offset (JAX :61-110)."""
        lin, t = self.matrix[:, :2], self.matrix[:, 2]
        eps = 1e-9
        swapped = abs(lin[0, 0]) < eps and abs(lin[1, 1]) < eps
        if swapped:
            sx, sy = lin[0, 1], lin[1, 0]
        elif abs(lin[0, 1]) < eps and abs(lin[1, 0]) < eps:
            sx, sy = lin[0, 0], lin[1, 1]
        else:
            return None
        src_h, src_w = img.shape[:2]
        if src_w == 0 or src_h == 0:
            return None
        if swapped:
            src_h, src_w = src_w, src_h
        if abs(abs(sx) * src_w - self.out_w) > 1e-6 * max(self.out_w, 1):
            return None
        if abs(abs(sy) * src_h - self.out_h) > 1e-6 * max(self.out_h, 1):
            return None
        want_tx = self.out_w if sx < 0 else 0.0
        want_ty = self.out_h if sy < 0 else 0.0
        if abs(t[0] - want_tx) > 1e-6 or abs(t[1] - want_ty) > 1e-6:
            return None
        if swapped:
            img = img.transpose(1, 0, 2)
        if (src_w, src_h) != (self.out_w, self.out_h):
            img = IW.resize_linear(img, self.out_w, self.out_h)
        if sx < 0:
            img = img[:, ::-1]
        if sy < 0:
            img = img[::-1]
        return np.ascontiguousarray(img)

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        """The uint8 [H, W, 3] image under the map, [out_h, out_w, 3], as
        the JAX package renders it with cv2: the axis-aligned path above,
        else ``warp_affine_linear`` (cv2.warpAffine) on the pixel-center
        matrix A(x) = M(x + 0.5) - 0.5 in float32."""
        if img.dtype != np.uint8:
            raise ValueError(f"AffineAug.apply_image takes uint8 images (the mapper's and the "
                             f"server's), got {img.dtype}")
        fast = self._axis_aligned_fast(img)
        if fast is not None:
            return fast
        lin = self.matrix[:, :2]
        a_img = np.hstack([lin, (lin @ np.array([0.5, 0.5]) + self.matrix[:, 2] - 0.5)[:, None]])
        return IW.warp_affine_linear(img, a_img.astype(np.float32), self.out_w, self.out_h)


def identity(w: int, h: int) -> AffineAug:
    return AffineAug(np.asarray([[1.0, 0, 0], [0, 1, 0]]), w, h)


def hflip(w: int, h: int) -> AffineAug:
    return AffineAug(np.asarray([[-1.0, 0, w], [0, 1, 0]]), w, h)


def vflip(w: int, h: int) -> AffineAug:
    return AffineAug(np.asarray([[1.0, 0, 0], [0, -1, h]]), w, h)


def rotation(w: int, h: int, angle_deg: float) -> AffineAug:
    """Counter-clockwise rotation about the image center, same output size
    (the coordinate matrix of cv2.getRotationMatrix2D((w/2, h/2), angle, 1))."""
    angle = np.deg2rad(angle_deg)
    c, s = np.cos(angle), np.sin(angle)
    cx, cy = w / 2, h / 2
    rot = np.asarray([[c, s], [-s, c]])
    t = np.asarray([cx, cy]) - rot @ np.asarray([cx, cy])
    return AffineAug(np.hstack([rot, t[:, None]]), w, h)


def resize(w: int, h: int, new_w: int, new_h: int) -> AffineAug:
    return AffineAug(
        np.asarray([[new_w / w, 0, 0], [0, new_h / h, 0]], dtype=np.float64), new_w, new_h
    )


def shortest_edge_resize(w: int, h: int, min_size: int, max_size: int) -> AffineAug:
    """Detectron2 ResizeShortestEdge semantics."""
    size = float(min_size)
    scale = size / min(h, w)
    if h < w:
        new_h, new_w = size, scale * w
    else:
        new_h, new_w = scale * h, size
    if max(new_h, new_w) > max_size:
        scale2 = max_size / max(new_h, new_w)
        new_h, new_w = new_h * scale2, new_w * scale2
    return resize(w, h, int(new_w + 0.5), int(new_h + 0.5))


def build_train_augmentations(cfg, w: int, h: int, rng: np.random.RandomState,
                              min_size: Optional[int] = None) -> AffineAug:
    """The random train-time map, with the JAX function's draws in its
    order: hflip p=.5 (if INPUT.HFLIP_TRAIN), vflip p=.5, a rotation from
    INPUT.ROTATION_AUG_ANGLES ("choice" or "range"), then the resize."""
    aug = identity(w, h)
    if cfg.INPUT.HFLIP_TRAIN and rng.rand() < 0.5:
        aug = aug.compose(hflip(aug.out_w, aug.out_h))
    if rng.rand() < 0.5:
        aug = aug.compose(vflip(aug.out_w, aug.out_h))
    angles = list(cfg.INPUT.ROTATION_AUG_ANGLES)
    if angles:
        if cfg.INPUT.ROTATION_AUG_SAMPLE_STYLE == "range" and len(angles) == 2:
            angle = float(rng.uniform(angles[0], angles[1]))
        else:
            angle = float(angles[rng.randint(len(angles))])
        if angle % 360 != 0:
            aug = aug.compose(rotation(aug.out_w, aug.out_h, angle))
    if cfg.INPUT.RESIZE_TYPE == "shortest-edge":
        sizes = list(cfg.INPUT.MIN_SIZE_TRAIN)
        if min_size is not None:
            pass  # forced by the caller
        elif not sizes:
            min_size = min(w, h)
        elif cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING == "range":
            if len(sizes) != 2 or sizes[0] > sizes[1]:
                raise ValueError(
                    "INPUT.MIN_SIZE_TRAIN_SAMPLING='range' requires "
                    f"MIN_SIZE_TRAIN = (lo, hi) with lo <= hi, got {sizes}"
                )
            min_size = int(rng.randint(int(sizes[0]), int(sizes[1]) + 1))
        else:
            min_size = int(sizes[rng.randint(len(sizes))])
        aug = aug.compose(
            shortest_edge_resize(aug.out_w, aug.out_h, min_size, cfg.INPUT.MAX_SIZE_TRAIN)
        )
    else:  # "both"
        aug = aug.compose(resize(aug.out_w, aug.out_h, cfg.INPUT.RESIZE_WIDTH_TRAIN,
                                 cfg.INPUT.RESIZE_HEIGHT_TRAIN))
    return aug


def train_geometric_augs_separable(cfg) -> bool:
    """True iff every train-time geometric draw of `cfg` is separable (a
    signed (anti)diagonal linear part, ``ops/device_warp.py``): flips and
    resizes always are; rotations only when every angle is a multiple of
    90 degrees.  A continuous "range" of angles is not."""
    angles = [float(a) for a in cfg.INPUT.ROTATION_AUG_ANGLES]
    if not angles:
        return True
    if cfg.INPUT.ROTATION_AUG_SAMPLE_STYLE == "range" and len(angles) == 2:
        if angles[0] != angles[1]:
            return False
    return all(a % 90.0 == 0.0 for a in angles)


def eval_preprocess_meta(cfg) -> dict:
    """The eval-time preprocessing recipe as a plain dict (JAX
    ``data/mapper.py::eval_preprocess_meta``, also importable from the
    port's ``data/mapper.py``): the resize ``eval_resize`` applies and the
    channel order clients must send.  One source for an exported
    artifact's metadata (``tools/export_model.py``), serving and the eval
    mapper, so that no two front ends can diverge."""
    return {
        "resize_type": cfg.INPUT.RESIZE_TYPE,
        "min_size_test": cfg.INPUT.MIN_SIZE_TEST,
        "max_size_test": cfg.INPUT.MAX_SIZE_TEST,
        "resize_width_test": cfg.INPUT.get("RESIZE_WIDTH_TEST", 0),
        "resize_height_test": cfg.INPUT.get("RESIZE_HEIGHT_TEST", 0),
        "input_format": cfg.INPUT.FORMAT,
    }


def eval_resize(meta: dict, w: int, h: int) -> AffineAug:
    """The test-time resize of an ``eval_preprocess_meta`` recipe (JAX
    ``tools/serve.py::_test_aug``): shortest edge to min_size_test capped
    at max_size_test, or resize_{width,height}_test for "both"."""
    if meta.get("resize_type", "shortest-edge") == "shortest-edge":
        return shortest_edge_resize(w, h, meta["min_size_test"], meta["max_size_test"])
    return resize(w, h, meta["resize_width_test"], meta["resize_height_test"])


def build_test_augmentation(cfg, w: int, h: int) -> AffineAug:
    """The test-time resize of `cfg`: ``eval_resize`` of its recipe."""
    return eval_resize(eval_preprocess_meta(cfg), w, h)


# detectron2 RandomLighting PCA basis (AlexNet-style ImageNet eigen
# decomposition, d2 augmentation_impl.py)
_LIGHTING_EIGEN_VECS = np.array(
    [
        [-0.5675, 0.7192, 0.4009],
        [-0.5808, -0.0045, -0.8140],
        [-0.5836, -0.6948, 0.4203],
    ]
)
_LIGHTING_EIGEN_VALS = np.array([0.2175, 0.0188, 0.0045])


def apply_color_augmentations(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Detectron2's color jitter in the reference's order: RandomLighting(1.0),
    RandomBrightness, RandomContrast and RandomSaturation (0.5, 1.5), each a
    blend that clips and truncates to uint8 between stages for uint8 input;
    the mean and the grayscale are taken in float64, as d2 does."""
    was_uint8 = img.dtype == np.uint8

    def blend(src, src_w, dst_w, im):
        out = src_w * src + dst_w * im.astype(np.float32)
        if was_uint8:
            return np.clip(out, 0, 255).astype(np.uint8)
        return out.astype(np.float32)

    weights = rng.normal(scale=1.0, size=3)
    img = blend(_LIGHTING_EIGEN_VECS.dot(weights * _LIGHTING_EIGEN_VALS), 1.0, 1.0, img)
    w = rng.uniform(0.5, 1.5)
    img = blend(0.0, 1.0 - w, w, img)
    w = rng.uniform(0.5, 1.5)
    img = blend(img.mean(dtype=np.float64), 1.0 - w, w, img)
    w = rng.uniform(0.5, 1.5)
    gray = img.astype(np.float64).dot([0.299, 0.587, 0.114])[:, :, None]
    img = blend(gray, 1.0 - w, w, img)
    return img
