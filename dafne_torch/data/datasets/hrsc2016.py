"""HRSC2016 ship dataset (XML annotations).

The port's copy of ``dafne_tpu/data/datasets/hrsc2016.py``, which follows
dafne/data/datasets/hrsc2016.py: parses
`labelXml/<id>.xml`, converts the (cx, cy, w, h, angle) mbox to 4 corners
via the rotation matrix (hrsc2016.py:37-42), stores the enclosing hbox, and
registers hrsc_{train,val,test,trainval} rooted at $DAFNE_DATA_DIR/hrsc.
One class: "ship".
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List

import numpy as np

from dafne_torch.data.registry import DatasetCatalog, MetadataCatalog, data_root

CLASSES = ["ship"]


def xywha_to_corners(cx, cy, w, h, a) -> np.ndarray:
    """(center, size, angle[rad, clockwise from x-axis]) -> [4, 2] corners."""
    base = np.array(
        [[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]]
    )
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    return base @ rot.T + [cx, cy]


def load_hrsc(root: str, image_set: str) -> List[dict]:
    with open(os.path.join(root, "ImageSets", f"{image_set}.txt")) as f:
        ids = [l for l in f.read().splitlines() if l.strip()]

    records = []
    for img_id in ids:
        img_id = int(img_id)
        xml_path = os.path.join(root, "labelXml", f"{img_id}.xml")
        tree = ET.parse(xml_path).getroot()
        record = {
            "file_name": os.path.join(root, "images", f"{img_id}.bmp"),
            "image_id": img_id,
            "width": int(tree.find("Img_SizeWidth").text),
            "height": int(tree.find("Img_SizeHeight").text),
        }
        objs = []
        for obj in tree.findall("HRSC_Objects")[0].findall("HRSC_Object"):
            vals = [
                float(obj.find(k).text)
                for k in ("mbox_cx", "mbox_cy", "mbox_w", "mbox_h", "mbox_ang")
            ]
            corners = xywha_to_corners(*vals)
            xs, ys = corners[:, 0], corners[:, 1]
            objs.append(
                {
                    "corners": corners.reshape(8).tolist(),
                    "bbox": [xs.min(), ys.min(), xs.max(), ys.max()],
                    "category_id": 0,
                    "difficult": bool(int(obj.find("difficult").text)),
                    "area": float((xs.max() - xs.min()) * (ys.max() - ys.min())),
                }
            )
        record["annotations"] = objs
        records.append(record)
    return records


def register_hrsc(cfg) -> None:
    root = os.path.join(data_root(), "hrsc")
    for split in ["train", "val", "test", "trainval"]:
        name = f"hrsc_{split}"
        DatasetCatalog.register(name, lambda s=split: load_hrsc(root, s))
        MetadataCatalog[name] = {
            "evaluator_type": "hrsc",
            "thing_classes": CLASSES,
            "root_dir": root,
            "image_root": os.path.join(root, "images"),
            "split": split,
            "is_test": split == "test",
        }
