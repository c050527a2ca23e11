"""Cross-tile result merging for DOTA test submissions.

The port's copy of ``dafne_tpu/evaluation/result_merge.py``, which follows
dafne/utils/ResultMerge_multi_process.py:

- tile ids follow "name__rate__x___y" (``parse_tile_id``);
- detections are shifted back by the tile origin and rescaled by 1/rate;
- per original image and class: greedy rotated polygon NMS at
  `nms_thresh` (default 0.1) with an hbox prefilter, the port's exact
  ``utils/polyiou.py::poly_nms`` (the JAX package calls its C++ library);
- rows with a NaN coordinate are dropped.

The classes' files merge one after another in this process.  The JAX
package forks worker processes, which must not happen once CUDA is up;
threads were slower than the serial loop, since ``poly_nms`` holds the GIL
for most of its time (``dafne_torch/tools/time_merge.py`` times both).
"""

from __future__ import annotations

import os
import re
import zipfile
from typing import Dict, List, Tuple

import numpy as np

from dafne_torch.utils.polyiou import poly_nms

_TILE_RE = re.compile(r"^(.*?)__([\d.]+)__(\d+)___(\d+)$")


def parse_tile_id(tile_id: str) -> Tuple[str, float, float, float]:
    """'P0003__1__0___600' -> ('P0003', 1.0, 0.0, 600.0); plain ids pass
    through with rate 1 and zero offset."""
    m = _TILE_RE.match(tile_id)
    if not m:
        return tile_id, 1.0, 0.0, 0.0
    return m[1], float(m[2]), float(m[3]), float(m[4])


def merge_class_lines(lines: List[str], nms_thresh: float) -> List[str]:
    """Merge one class's Task1 lines across tiles into original frames."""
    by_image: Dict[str, List[Tuple[float, np.ndarray]]] = {}
    for line in lines:
        parts = line.split()
        if len(parts) < 10:
            continue
        tile_id, score = parts[0], float(parts[1])
        poly = np.asarray([float(v) for v in parts[2:10]])
        if not np.isfinite(poly).all():
            continue
        name, rate, ox, oy = parse_tile_id(tile_id)
        poly = (poly.reshape(4, 2) + [ox, oy]).reshape(8) / rate
        by_image.setdefault(name, []).append((score, poly))

    out = []
    for name, dets in by_image.items():
        scores = np.asarray([d[0] for d in dets])
        polys = np.stack([d[1] for d in dets])
        keep = poly_nms(polys, scores, nms_thresh)
        for i in np.where(keep)[0]:
            coords = " ".join(f"{v:.2f}" for v in polys[i])
            out.append(f"{name} {scores[i]:.4f} {coords}")
    return out


def _merge_one_file(args):
    src, dst, nms_thresh = args
    with open(src) as f:
        lines = [l.strip() for l in f if l.strip()]
    merged = merge_class_lines(lines, nms_thresh)
    with open(dst, "w") as f:
        f.write("\n".join(merged) + ("\n" if merged else ""))
    return dst


def merge_by_poly(src_dir: str, dst_dir: str, nms_thresh: float = 0.1) -> List[str]:
    """Merge every Task1_*.txt in src_dir into dst_dir."""
    os.makedirs(dst_dir, exist_ok=True)
    return [_merge_one_file((os.path.join(src_dir, fn), os.path.join(dst_dir, fn), nms_thresh))
            for fn in sorted(os.listdir(src_dir))
            if fn.startswith("Task1_") and fn.endswith(".txt")]


def make_submission_zip(merged_dir: str, zip_path: str) -> str:
    """Zip the merged Task1 files for the DOTA evaluation server."""
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        for fn in sorted(os.listdir(merged_dir)):
            if fn.startswith("Task1_") and fn.endswith(".txt"):
                z.write(os.path.join(merged_dir, fn), fn)
    return zip_path
