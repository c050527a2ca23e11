from dafne_torch.geometry.iou import (
    quad_intersection_area_clip,
    quad_iou,
    quad_iou_matrix,
)
from dafne_torch.geometry.quads import (
    enclosing_hbox,
    quad_area,
    quad_signed_area,
    sort_quadrilateral,
)

__all__ = [
    "enclosing_hbox",
    "quad_area",
    "quad_intersection_area_clip",
    "quad_iou",
    "quad_iou_matrix",
    "quad_signed_area",
    "sort_quadrilateral",
]
