from dafne_torch.data.registry import (
    DatasetCatalog,
    MetadataCatalog,
    get_dataset,
    register_all_datasets,
)

__all__ = [
    "DatasetCatalog",
    "MetadataCatalog",
    "get_dataset",
    "register_all_datasets",
]
