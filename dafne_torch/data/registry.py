"""Dataset registry: name -> (loader fn, metadata).

The port's own copy of ``dafne_tpu/data/registry.py``.  Records are plain
dicts:

  {"file_name": str (or "image": uint8 [H, W, 3]), "image_id": str,
   "height": int, "width": int,
   "annotations": [{"corners": [8 floats], "bbox": [x0, y0, x1, y1],
                    "category_id": int, "difficult": bool, "area": float}]}

The data root comes from the DAFNE_DATA_DIR environment variable, read
when the datasets are registered.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional


class _Catalog:
    def __init__(self):
        self._loaders: Dict[str, Callable[..., List[dict]]] = {}
        self._sized = set()

    def register(self, name: str, fn: Callable[..., List[dict]], sized: bool = False):
        """`sized`: fn(limit) makes only the first `limit` records (a
        generator set), the same as the first `limit` of fn()."""
        self._loaders[name] = fn
        self._sized.discard(name)
        if sized:
            self._sized.add(name)

    def get(self, name: str, limit: Optional[int] = None) -> List[dict]:
        """The records of `name`; at least the first `limit` of them."""
        if name not in self._loaders:
            raise KeyError(
                f"Dataset '{name}' is not registered. Known: {sorted(self._loaders)[:20]}..."
            )
        if limit and name in self._sized:
            return self._loaders[name](limit)
        return self._loaders[name]()

    def __contains__(self, name):
        return name in self._loaders

    def list(self):
        return sorted(self._loaders)


DatasetCatalog = _Catalog()
MetadataCatalog: Dict[str, dict] = {}


def data_root() -> str:
    return os.environ.get("DAFNE_DATA_DIR", "/data")


def apply_overfit(records: List[dict], cfg) -> List[dict]:
    """DEBUG.OVERFIT_NUM_IMAGES truncation (defaults.py:13-14, dota.py:128-130)."""
    n = cfg.DEBUG.OVERFIT_NUM_IMAGES
    if n is not None and n > 0:
        return records[:n]
    return records


def get_dataset(name: str, cfg=None) -> List[dict]:
    """The records of `name`, cut to DEBUG.OVERFIT_NUM_IMAGES (a generator
    set makes only those)."""
    if cfg is None:
        return DatasetCatalog.get(name)
    return apply_overfit(DatasetCatalog.get(name, cfg.DEBUG.OVERFIT_NUM_IMAGES), cfg)


def register_all_datasets(cfg) -> None:
    """Register every dataset family the port can load (idempotent), as
    ``dafne_tpu/data/registry.py:67-72`` does: DOTA, HRSC2016, UCAS-AOD and
    ICDAR15 under ``data_root()``, and the synthetic scenes, which carry
    their images (``synthetic_{train,val,test}`` and the generator sets)."""
    from dafne_torch.data import synthetic
    from dafne_torch.data.datasets import dota, hrsc2016, icdar15, ucas_aod

    dota.register_dota(cfg)
    hrsc2016.register_hrsc(cfg)
    ucas_aod.register_ucas_aod(cfg)
    icdar15.register_icdar15(cfg)
    synthetic.register_synthetic(cfg)
