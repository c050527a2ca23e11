"""DOTA 1.0 / 1.5 dataset (tiled COCO-json format).

The port's copy of ``dafne_tpu/data/datasets/dota.py``, which follows the
reference loader (dafne/data/datasets/dota.py):
- plain-json COCO parsing (no pycocotools; DOTA tiles store quads as a
  single 8-float `segmentation` polygon and the enclosing hbox as `bbox`)
- min-area / min-side skip (dota.py:226-232 semantics via INPUT.MIN_AREA,
  INPUT.MIN_SIDE), degenerate-quad (overlapping corners, any pair closer
  than 1e-2 L1) skip (dota.py:247-264)
- registers dota_{1,1_5}_{train,val,test}_{600,800,1024,1300,1600,2048}
  plus a `_mini` 5% (>=10 images) twin for fast in-training eval
  (dota.py:80-84,312-318,408-412)
- data root from $DAFNE_DATA_DIR (dota.py:391)
- optional container-crane removal for 1.5 (DATASETS.DOTA_REMOVE_CONTAINER_CRANE)
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from dafne_torch.data.registry import DatasetCatalog, MetadataCatalog, data_root

DOTA_10_CLASSES = [
    "plane", "baseball-diamond", "bridge", "ground-track-field",
    "small-vehicle", "large-vehicle", "ship", "tennis-court",
    "basketball-court", "storage-tank", "soccer-ball-field", "roundabout",
    "harbor", "swimming-pool", "helicopter",
]
DOTA_15_CLASSES = DOTA_10_CLASSES + ["container-crane"]

SIZES = ["600", "800", "1024", "1300", "1600", "2048"]


def _quad_is_degenerate(seg: np.ndarray, tol: float = 1e-2) -> bool:
    """Any two corners (L1-)closer than tol -> degenerate (dota.py:247-264)."""
    pts = seg.reshape(4, 2)
    for i in range(4):
        for j in range(i + 1, 4):
            if np.abs(pts[i] - pts[j]).sum() < tol:
                return True
    return False


def load_dota_json(json_file: str, image_root: str, cfg, mini: bool = False) -> List[dict]:
    with open(json_file) as f:
        coco = json.load(f)

    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    remove_cc = cfg.DATASETS.DOTA_REMOVE_CONTAINER_CRANE
    cc_ids = {c["id"] for c in cats if c["name"] == "container-crane"}

    anns_by_image = {}
    for a in coco.get("annotations", []):
        anns_by_image.setdefault(a["image_id"], []).append(a)

    min_area = cfg.INPUT.MIN_AREA
    min_side = cfg.INPUT.MIN_SIDE

    records = []
    for img in coco["images"]:
        objs = []
        for a in anns_by_image.get(img["id"], []):
            if remove_cc and a["category_id"] in cc_ids:
                continue
            x, y, w, h = a["bbox"]
            area = a.get("area", w * h)
            if area <= min_area or max(w, h) < min_side:
                continue
            segm = a.get("segmentation")
            if not segm:
                continue
            polys = [p for p in segm if len(p) % 2 == 0 and len(p) >= 6]
            if not polys:
                continue
            seg = np.asarray(polys[0], dtype=np.float64)
            if seg.size != 8 or _quad_is_degenerate(seg):
                continue
            objs.append(
                {
                    "corners": seg.tolist(),
                    "bbox": [x, y, x + w, y + h],
                    "category_id": id_map[a["category_id"]],
                    "difficult": bool(a.get("difficult", 0)),
                    "area": float(area),
                }
            )
        records.append(
            {
                "file_name": os.path.join(image_root, img["file_name"]),
                "image_id": os.path.splitext(img["file_name"])[0],
                "height": img["height"],
                "width": img["width"],
                "annotations": objs,
            }
        )

    if mini:
        # 5% random (with replacement, matching dota.py:312-318), >= 10 images
        n_mini = max(10, int(len(records) * 0.05))
        rng = np.random.RandomState(0)
        records = [records[i] for i in rng.randint(0, len(records), n_mini)]
    return records


def register_dota(cfg) -> None:
    root = data_root()
    for version in ["1", "1_5"]:
        classes = DOTA_10_CLASSES if version == "1" else DOTA_15_CLASSES
        if version == "1_5" and cfg.DATASETS.DOTA_REMOVE_CONTAINER_CRANE:
            classes = DOTA_10_CLASSES
        for split in ["train", "val", "test"]:
            for size in SIZES:
                name = f"dota_{version}_{split}_{size}"
                d = os.path.join(root, f"dota_{version}_split", f"{split}{size}")
                json_file = os.path.join(d, f"DOTA{version}_{split}{size}.json")
                image_root = os.path.join(d, "images")
                for suffix, mini in [("", False), ("_mini", True)]:
                    full = name + suffix
                    DatasetCatalog.register(
                        full,
                        (lambda jf=json_file, ir=image_root, m=mini: load_dota_json(
                            jf, ir, cfg, mini=m
                        )),
                    )
                    MetadataCatalog[full] = {
                        "evaluator_type": "dota",
                        "thing_classes": classes,
                        "json_file": json_file,
                        "image_root": image_root,
                        "root_dir": d,
                        "is_test": split == "test",
                        "dota_version": version,
                    }
