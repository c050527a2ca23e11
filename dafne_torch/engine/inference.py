"""Inference step: raw-pixel images -> fixed-size detections.

Counterpart of ``dafne_tpu/engine/trainer.py::make_eval_step``: the model
forward, then ``decode_detections``.  ``EvalProgram`` is that body as a
module, which ``tools/export_model.py`` exports whole.  int8 convs
(``TPU.EVAL_INT8``) are not ported: the step raises when the key is set.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from dafne_torch.ops.postprocess import DecodeSpec, decode_detections


class EvalProgram(nn.Module):
    """``forward(images [B, H, W, 3], scale_xy [B, 2] = None)``: `model`'s
    forward on raw pixels, then ``decode_detections`` with `spec`."""

    def __init__(self, model: nn.Module, spec: DecodeSpec):
        super().__init__()
        self.model = model
        self.spec = spec

    def forward(self, images: torch.Tensor,
                scale_xy: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        return decode_detections(self.model(images), self.spec, scale_xy)


def eval_program(model, cfg) -> EvalProgram:
    """The eval step's body for `model` and `cfg` (TPU.EVAL_INT8 raises)."""
    if cfg.TPU.EVAL_INT8:
        raise NotImplementedError("TPU.EVAL_INT8 (w8a8 eval convs) is not ported")
    return EvalProgram(model, DecodeSpec.from_config(cfg))


def make_eval_step(model, cfg, image_hw: Tuple[int, int]) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``eval_step(images [B, H, W, 3], scale_xy [B, 2] = None)``.

    Images are raw pixels on the model's device, H x W = `image_hw`.  The
    step returns the dict of ``decode_detections``: [B, POST_NMS_TOPK_TEST]
    corners, hboxes, scores, classes, centerness, locations and valid."""
    program = eval_program(model, cfg)
    image_hw = tuple(image_hw)

    @torch.inference_mode()
    def eval_step(images: torch.Tensor, scale_xy: Optional[torch.Tensor] = None):
        if images.ndim != 4 or tuple(images.shape[1:3]) != image_hw or images.shape[3] != 3:
            raise ValueError(f"expected images [B, {image_hw[0]}, {image_hw[1]}, 3], "
                             f"got {tuple(images.shape)}")
        return program(images, scale_xy)

    return eval_step
