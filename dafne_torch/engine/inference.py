"""Inference step: raw-pixel images -> fixed-size detections.

Counterpart of ``dafne_tpu/engine/trainer.py::make_eval_step``: the model
forward, then ``decode_detections``.  ``EvalProgram`` is that body as a
module, which ``tools/export_model.py`` exports whole.  With
``TPU.EVAL_INT8`` the program's model is a copy whose eligible convs run
in int8 (``layers/quant.py::quantized_eval_model``; the scales JSON of
``TPU.EVAL_INT8_SCALES`` is read when the program is built, as
``trainer.py:372-381`` of the JAX package reads it); ``program.int8``
records the mode, the width rule, the sites and the scales.
``make_eval_step(..., decode_overrides=)`` replaces fields of the decode
spec (JAX ``trainer.py:359-370``), for diagnostics such as
``{"skip_nms": True}``.
"""

from __future__ import annotations

import dataclasses
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


def eval_program(model, cfg, quantize_weights: bool = True,
                 decode_overrides: Optional[dict] = None) -> EvalProgram:
    """The eval step's body for `model` and `cfg`.  Under TPU.EVAL_INT8 the
    weights of the int8 sites are quantized now, or, with
    `quantize_weights` False (a program whose weights are its inputs), at
    each call.  `decode_overrides` replaces fields of the config's
    ``DecodeSpec`` (diagnostics only)."""
    from dafne_torch.layers import quant  # model code: not for an artifact's server

    settings = quant.int8_settings(cfg)
    qmodel = quant.quantized_eval_model(model, enabled=settings["enabled"],
                                        min_channels=settings["min_channels"],
                                        act_scales=settings["scales"],
                                        quantize_weights=quantize_weights)
    spec = DecodeSpec.from_config(cfg)
    if decode_overrides:
        spec = dataclasses.replace(spec, **decode_overrides)
    program = EvalProgram(qmodel, spec)
    sites = quant.int8_sites(qmodel)
    program.int8 = {
        "mode": ("off" if not settings["enabled"]
                 else "static" if settings["scales"] else "dynamic"),
        "min_channels": (quant.resolve_min_channels(settings["min_channels"], settings["scales"])
                         if settings["enabled"] else None),
        "sites": len(sites),
        "static_sites": sum(m == "static" for m in sites.values()),
        "scales": settings["scales"],
    }
    return program


def make_eval_step(model, cfg, image_hw: Tuple[int, int],
                   decode_overrides: Optional[dict] = None) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build ``eval_step(images [B, H, W, 3], scale_xy [B, 2] = None)``.

    Images are raw pixels on the model's device, H x W = `image_hw`.  The
    step returns the dict of ``decode_detections``: [B, POST_NMS_TOPK_TEST]
    corners, hboxes, scores, classes, centerness, locations and valid.
    ``eval_step.program`` is its ``EvalProgram``; `decode_overrides`
    replaces fields of its decode spec (e.g. ``{"skip_nms": True}``)."""
    program = eval_program(model, cfg, decode_overrides=decode_overrides)
    image_hw = tuple(image_hw)

    @torch.inference_mode()
    def eval_step(images: torch.Tensor, scale_xy: Optional[torch.Tensor] = None):
        if images.ndim != 4 or tuple(images.shape[1:3]) != image_hw or images.shape[3] != 3:
            raise ValueError(f"expected images [B, {image_hw[0]}, {image_hw[1]}, 3], "
                             f"got {tuple(images.shape)}")
        return program(images, scale_xy)

    eval_step.program = program
    return eval_step
