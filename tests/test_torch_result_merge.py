"""The DOTA cross-tile merge and submission zip, port vs JAX.

The same Task1 lines (random tile detections, duplicates across the
200-pixel overlap of neighbouring tiles, pairs of boxes at IoU 0.1 exactly
in the original frame, rows with NaN) go through both packages.
Tolerance: none; the merged files are compared byte for byte.  The JAX
package merges with its C++ ``poly_nms`` where g++ built it, the port with
its NumPy one: the tests here hold the two to the same kept sets, at the
threshold too.
"""

import os
import zipfile

import numpy as np
import pytest
import torch

from dafne_tpu.evaluation import result_merge as JR
from dafne_tpu.utils import polyiou as jax_polyiou

from dafne_torch.evaluation import result_merge as R
from dafne_torch.utils import polyiou

torch.set_num_threads(1)

CLASSES = ["plane", "ship", "small-vehicle", "harbor"]
STRIDE, TILE = 824, 1024


@pytest.mark.parametrize("tile_id", [
    "P0003__1__0___600", "P0003__0.5__824___1648", "P1234__1.5__0___0", "P0003",
    "name__with__underscores__1__10___20", "P0001__1__0___", "P0001__x__0___0", ""])
def test_parse_tile_id_equals_jax(tile_id):
    assert R.parse_tile_id(tile_id) == JR.parse_tile_id(tile_id)


def _fmt(tile, score, poly):
    return f"{tile} {score:.4f} " + " ".join(f"{v:.2f}" for v in np.ravel(poly))


def _square(x, y, side):
    return [x, y, x + side, y, x + side, y + side, x, y + side]


def _task1_lines(seed, n_random=60):
    """One class's Task1 lines over the 2 x 2 tiles of two originals."""
    rng = np.random.RandomState(seed)
    lines = []
    for name in ("P0001", "P0002"):
        tiles = [(x, y) for y in (0, STRIDE) for x in (0, STRIDE)]
        for _ in range(n_random):  # random quads anywhere in a tile
            x, y = tiles[rng.randint(4)]
            cx, cy = rng.uniform(20, TILE - 20, 2)
            w, h, a = rng.uniform(8, 60), rng.uniform(8, 60), rng.uniform(0, np.pi)
            c = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
            c = c @ np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]).T + [cx, cy]
            lines.append(_fmt(f"{name}__1__{x}___{y}", rng.rand(), c.reshape(8)))
        for _ in range(15):  # one object seen by two tiles across the overlap
            ox, oy = rng.uniform(STRIDE + 10, TILE - 40, 2)
            poly = np.array(_square(ox, oy, rng.uniform(10, 25)))
            jitter = rng.uniform(-1.5, 1.5, 8)
            lines.append(_fmt(f"{name}__1__0___0", rng.rand(), poly))
            lines.append(_fmt(f"{name}__1__{STRIDE}___0", rng.rand(),
                              (poly + jitter).reshape(4, 2) - [STRIDE, 0]))
        for k in range(6):  # squares of side 11 offset by 9: IoU 22 / 220 = 0.1 exactly
            x0, y0 = 100 + 40 * k, 700
            lines.append(_fmt(f"{name}__1__0___0", 0.9 - 0.01 * k, _square(x0, y0, 11)))
            lines.append(_fmt(f"{name}__1__0___0", 0.5, _square(x0 + 9, y0, 11)))
            lines.append(_fmt(f"{name}__1__0___0", 0.5, _square(x0, y0 + 8.99, 11)))
        lines.append(f"{name}__1__0___0 0.7000 nan 1.00 2.00 3.00 4.00 5.00 6.00 7.00")
        lines.append(f"{name}__1__0___0 0.7000 1 2 3")  # too short: skipped
    return lines


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_class_lines_equals_jax(seed):
    lines = _task1_lines(seed)
    got = R.merge_class_lines(lines, 0.1)
    assert got == JR.merge_class_lines(lines, 0.1)
    assert 0 < len(got) < len(lines)
    assert all(line.split()[0] in ("P0001", "P0002") for line in got)


def test_boxes_at_the_threshold_keep_the_same_set():
    """IoU 0.1 exactly (side-11 squares offset by 9) and just above: the
    port's NumPy poly_nms keeps what the JAX package's keeps."""
    boxes = np.array([_square(0, 0, 11), _square(9, 0, 11), _square(0, 8.99, 11),
                      _square(0, 9, 11), _square(9.01, 9, 11)], np.float64)
    iou = polyiou.iou_poly_pairs(boxes[:1].repeat(4, 0), boxes[1:])
    assert abs(iou[0] - 0.1) < 1e-15 and iou[1] > 0.1
    for scores in (np.array([0.9, 0.5, 0.5, 0.4, 0.3]), np.ones(5)):
        keep = polyiou.poly_nms(boxes, scores, 0.1)
        np.testing.assert_array_equal(keep, jax_polyiou.poly_nms(boxes, scores, 0.1))
        np.testing.assert_array_equal(keep, polyiou.poly_nms_plain(boxes, scores, 0.1))


def _write_task1(src, seed):
    os.makedirs(src, exist_ok=True)
    for i, c in enumerate(CLASSES):
        lines = _task1_lines(seed * 10 + i, n_random=20 + 10 * i) if c != "harbor" else []
        with open(os.path.join(src, f"Task1_{c}.txt"), "w") as f:
            f.write("".join(line + "\n" for line in lines))
    with open(os.path.join(src, "notes.txt"), "w") as f:
        f.write("not a Task1 file\n")


@pytest.mark.parametrize("seed", [1, 4])
def test_merge_by_poly_and_zip_equal_jax_byte_for_byte(tmp_path, seed):
    src = str(tmp_path / "task1")
    _write_task1(src, seed=seed)
    got = R.merge_by_poly(src, str(tmp_path / "port"))
    want = JR.merge_by_poly(src, str(tmp_path / "jax"), num_workers=1)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == len(CLASSES)
    for g, w in zip(got, want):
        assert open(g, "rb").read() == open(w, "rb").read(), g
    assert (tmp_path / "port" / "Task1_harbor.txt").read_text() == ""  # no detections
    zg = R.make_submission_zip(str(tmp_path / "port"), str(tmp_path / "port.zip"))
    zw = JR.make_submission_zip(str(tmp_path / "jax"), str(tmp_path / "jax.zip"))
    with zipfile.ZipFile(zg) as a, zipfile.ZipFile(zw) as b:
        assert a.namelist() == b.namelist() == sorted(f"Task1_{c}.txt" for c in CLASSES)
        for n in a.namelist():
            assert a.read(n) == b.read(n)
