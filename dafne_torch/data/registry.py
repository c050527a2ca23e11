"""Dataset registry: name -> (loader fn, metadata).

The port's own copy of ``dafne_tpu/data/registry.py``.  Records are plain
dicts:

  {"image": uint8 [H, W, 3], "image_id": str, "height": int, "width": int,
   "annotations": [{"corners": [8 floats], "bbox": [x0, y0, x1, y1],
                    "category_id": int, "difficult": bool, "area": float}]}
"""

from __future__ import annotations

from typing import Callable, Dict, List


class _Catalog:
    def __init__(self):
        self._loaders: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, fn: Callable[[], List[dict]]):
        self._loaders[name] = fn

    def get(self, name: str) -> List[dict]:
        if name not in self._loaders:
            raise KeyError(
                f"Dataset '{name}' is not registered. Known: {sorted(self._loaders)[:20]}..."
            )
        return self._loaders[name]()

    def __contains__(self, name):
        return name in self._loaders


DatasetCatalog = _Catalog()
MetadataCatalog: Dict[str, dict] = {}


def apply_overfit(records: List[dict], cfg) -> List[dict]:
    """DEBUG.OVERFIT_NUM_IMAGES truncation (defaults.py:13-14, dota.py:128-130)."""
    n = cfg.DEBUG.OVERFIT_NUM_IMAGES
    if n is not None and n > 0:
        return records[:n]
    return records


def get_dataset(name: str, cfg=None) -> List[dict]:
    records = DatasetCatalog.get(name)
    if cfg is not None:
        records = apply_overfit(records, cfg)
    return records


def register_all_datasets(cfg) -> None:
    """Register every dataset family the port can load (idempotent): the
    synthetic scenes, which carry their images.  DOTA, HRSC2016, UCAS-AOD
    and ICDAR15 decode image files (cv2) and are not registered."""
    from dafne_torch.data import synthetic

    synthetic.register_synthetic_gen(cfg)
