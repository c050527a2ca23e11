"""Request front end: images in, detection lists out.

In the shape of ``tools/serve.py::DetectorService`` without HTTP and without
resizing: each request image is placed top-left on the static canvas,
requests are batched, run through the eval step, and each image's valid
detections come back as ``{corners, hbox, score, class}`` dicts in original
image coordinates, highest score first.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from dafne_torch.data.mapper import pad_target_hw
from dafne_torch.engine.inference import make_eval_step


class Predictor:
    """Batches H x W x 3 uint8 request images onto the config's test canvas
    (`pad_target_hw`)."""

    def __init__(self, model, cfg, batch: int):
        self.batch = int(batch)
        self.canvas_hw = pad_target_hw(cfg, train=False)
        self.device = next(model.parameters()).device
        self.step = make_eval_step(model, cfg, self.canvas_hw)

    def check(self, images: Sequence[np.ndarray]) -> None:
        """Raise ValueError unless every request is an H x W x 3 uint8 image
        that fits the canvas."""
        ph, pw = self.canvas_hw
        for i, img in enumerate(images):
            if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
                raise ValueError(f"request {i}: expected an H x W x 3 uint8 image, "
                                 f"got {img.dtype} {img.shape}")
            h, w = img.shape[:2]
            if h == 0 or w == 0 or h > ph or w > pw:
                raise ValueError(f"request {i}: image {h}x{w} does not fit the {ph}x{pw} canvas")

    def canvas(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        """[batch, H, W, 3] uint8 canvas on the model's device holding the
        (checked) `images` top-left.  It is filled in pinned host memory and
        copied without blocking; the model casts it to its compute dtype."""
        host = torch.zeros((self.batch, *self.canvas_hw, 3), dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        for i, img in enumerate(images):
            host[i, : img.shape[0], : img.shape[1]] = torch.from_numpy(img)
        return host.to(self.device, non_blocking=True)

    def detect(self, images: Sequence[np.ndarray]) -> List[List[Dict]]:
        """One list of detections per request image."""
        self.check(images)  # refuse before any batch runs
        results = []
        for start in range(0, len(images), self.batch):
            chunk = images[start : start + self.batch]
            out = self.step(self.canvas(chunk))
            out = {k: v[: len(chunk)].cpu().numpy() for k, v in out.items()}
            for b in range(len(chunk)):
                dets = [
                    {
                        "corners": out["corners"][b, i].tolist(),
                        "hbox": out["hboxes"][b, i].tolist(),
                        "score": float(out["scores"][b, i]),
                        "class": int(out["classes"][b, i]),
                    }
                    for i in np.nonzero(out["valid"][b])[0]
                ]
                dets.sort(key=lambda d: -d["score"])
                results.append(dets)
        return results
