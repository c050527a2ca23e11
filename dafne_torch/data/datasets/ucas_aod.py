"""UCAS-AOD dataset (space-separated txt annotations, car + airplane).

The port's copy of ``dafne_tpu/data/datasets/ucas_aod.py`` (image sizes from
the file's header through ``data/image_io.py::image_size`` instead of PIL),
which follows dafne/data/datasets/ucas_aod.py: per-image
`Annotations/<id>.txt` with "<class> x0 y0 ... y3" lines, background label
skipped, validity filter w > 2 & h > 2 & aspect-ratio < 30
(ucas_aod.py:106-109); registers ucas_aod_{train,val,test,trainval}.
Classes: car(0), airplane(1) — the reference's 1-indexed labels minus the
background slot (ucas_aod.py:69,100-103).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from dafne_torch.data.image_io import image_size
from dafne_torch.data.registry import DatasetCatalog, MetadataCatalog, data_root

CLASSES = ["car", "airplane"]
_NAME_TO_LABEL = {"__background__": -1, "car": 0, "airplane": 1}



def load_ucas_aod(root: str, image_set: str) -> List[dict]:
    with open(os.path.join(root, "ImageSets", f"{image_set}.txt")) as f:
        ids = [l for l in f.read().splitlines() if l.strip()]

    records = []
    for img_id in ids:
        img_path = os.path.join(root, "AllImages", f"{img_id}.png")
        w_img, h_img = image_size(img_path)
        record = {
            "file_name": img_path,
            "image_id": img_id[1:] if img_id[:1] == "P" else img_id,
            "width": w_img,
            "height": h_img,
        }
        objs = []
        anno_path = os.path.join(root, "Annotations", f"{img_id}.txt")
        with open(anno_path, encoding="utf-8-sig") as f:
            for line in f.read().split("\n"):
                if not line.strip():
                    continue
                parts = line.split()
                label = _NAME_TO_LABEL[parts[0]]
                if label < 0:
                    continue
                corners = np.asarray([float(v) for v in parts[1:9]])
                xs, ys = corners[0::2], corners[1::2]
                w = xs.max() - xs.min()
                h = ys.max() - ys.min()
                ar = max(w / (h + 1e-16), h / (w + 1e-16))
                if not (w > 2 and h > 2 and ar < 30):
                    continue
                objs.append(
                    {
                        "corners": corners.tolist(),
                        "bbox": [xs.min(), ys.min(), xs.max(), ys.max()],
                        "category_id": label,
                        "difficult": False,
                        "area": float(w * h),
                    }
                )
        record["annotations"] = objs
        records.append(record)
    return records


def register_ucas_aod(cfg) -> None:
    root = os.path.join(data_root(), "UCAS-AOD")
    for split in ["train", "val", "test", "trainval"]:
        name = f"ucas_aod_{split}"
        DatasetCatalog.register(name, lambda s=split: load_ucas_aod(root, s))
        MetadataCatalog[name] = {
            "evaluator_type": "ucas_aod",
            "thing_classes": CLASSES,
            "root_dir": root,
            "image_root": os.path.join(root, "AllImages"),
            "split": split,
            "is_test": split == "test",
        }
