"""ICDAR-2015 incidental scene text dataset (comma-separated txt).

The port's copy of ``dafne_tpu/data/datasets/icdar15.py`` (image sizes from
the file's header through ``data/image_io.py::image_size`` instead of PIL),
which follows dafne/data/datasets/icdar15.py: per-image
`Annotations/<set>/gt_img_<id>.txt` with "x0,y0,...,y3[,text]" lines,
validity filter w > 2 & h > 2 & ar < 30 (icdar15.py:107-110); val images
live in the train folder; one class "text".
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from dafne_torch.data.image_io import image_size
from dafne_torch.data.registry import DatasetCatalog, MetadataCatalog, data_root

CLASSES = ["text"]



def load_icdar15(root: str, image_set: str) -> List[dict]:
    with open(os.path.join(root, "ImageSets", f"{image_set}.txt")) as f:
        ids = [l.replace("gt_img_", "") for l in f.read().splitlines() if l.strip()]

    # val images + annotations live in the train folder (icdar15.py:39-55)
    folder = "train" if image_set == "val" else image_set

    records = []
    for img_id in ids:
        img_path = os.path.join(root, "images", folder, f"img_{img_id}.jpg")
        w_img, h_img = image_size(img_path)
        record = {
            "file_name": img_path,
            "image_id": img_id,
            "width": w_img,
            "height": h_img,
        }
        objs = []
        anno_path = os.path.join(root, "Annotations", folder, f"gt_img_{img_id}.txt")
        with open(anno_path, encoding="utf-8-sig") as f:
            for line in f.read().split("\n"):
                if not line.strip():
                    continue
                vals = line.split(",")[0:8]
                corners = np.asarray([float(v) for v in vals])
                xs, ys = corners[0::2], corners[1::2]
                w = xs.max() - xs.min()
                h = ys.max() - ys.min()
                ar = max(w / (h + 1e-16), h / (w + 1e-16))
                if not (w > 2 and h > 2 and ar < 30):
                    continue
                # "###" marks unreadable text -> difficult in the ICDAR protocol
                difficult = line.split(",")[8].strip() == "###" if len(line.split(",")) > 8 else False
                objs.append(
                    {
                        "corners": corners.tolist(),
                        "bbox": [xs.min(), ys.min(), xs.max(), ys.max()],
                        "category_id": 0,
                        "difficult": bool(difficult),
                        "area": float(w * h),
                    }
                )
        record["annotations"] = objs
        records.append(record)
    return records


def register_icdar15(cfg) -> None:
    root = os.path.join(data_root(), "icdar-2015")
    for split in ["train", "val", "test"]:
        name = f"icdar15_{split}"
        DatasetCatalog.register(name, lambda s=split: load_icdar15(root, s))
        MetadataCatalog[name] = {
            "evaluator_type": "icdar15",
            "thing_classes": CLASSES,
            "root_dir": root,
            "image_root": os.path.join(
                root, "images", "train" if split in ("train", "val") else "test"
            ),
            "split": split,
            "is_test": split == "test",
        }
