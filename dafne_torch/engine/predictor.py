"""Request front end: images in, detection lists out.

In the shape of ``tools/serve.py::DetectorService`` (``preprocess``
:203-223, ``detect``) without HTTP: each request image is converted to
uint8 (float pixels clipped first), resized with the recipe's eval resize
(``data/transforms.py::eval_resize`` of ``eval_preprocess_meta``,
rendered by ``AffineAug.apply_image``) and placed top-left on the static
canvas, cropped there if it is larger, exactly as the eval mapper places
it; the requests are batched and run through an eval step, and each
image's valid detections come back, rescaled by scale_xy = (w / rw, h /
rh) to the original image's coordinates, as ``{corners, hbox, score,
class}`` dicts, highest score first.

``FrontEnd`` needs no config: the recipe dict, the canvas and any step
``(images [B, H, W, 3] uint8, scale_xy [B, 2] f32) -> detections`` (an
exported program's too).  ``Predictor`` is the front end of a model and
its config, over ``make_eval_step``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from dafne_torch.data import transforms as T
from dafne_torch.data.mapper import pad_target_hw
from dafne_torch.engine.inference import make_eval_step


class FrontEnd:
    """Batches H x W x 3 request images (uint8, or float in 0-255) onto a
    `canvas_hw` canvas on `device`, resized as the recipe `meta`
    (``eval_preprocess_meta``) says, and runs them through `step`."""

    def __init__(self, step: Callable, meta: Dict, canvas_hw: Tuple[int, int], batch: int,
                 device):
        self.step = step
        self.meta = meta
        self.canvas_hw = tuple(canvas_hw)
        self.batch = int(batch)
        self.device = torch.device(device)

    def check(self, images: Sequence[np.ndarray]) -> None:
        """Raise ValueError unless every request is a non-empty H x W x 3
        image."""
        for i, img in enumerate(images):
            if img.ndim != 3 or img.shape[2] != 3:
                raise ValueError(f"request {i}: expected an H x W x 3 image, got {img.shape}")
            if img.shape[0] == 0 or img.shape[1] == 0:
                raise ValueError(f"request {i}: zero-sized image {img.shape}")

    def preprocess(self, img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(the resized uint8 image, its scale_xy [2] float32) of one
        checked request: float pixels clipped to uint8 first, so that the
        resize sees the dtype the eval mapper reads from disk."""
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        h, w = img.shape[:2]
        resized = T.eval_resize(self.meta, w, h).apply_image(img)
        rh, rw = resized.shape[:2]
        return resized, np.asarray([w / rw, h / rh], np.float32)

    def canvas(self, images: Sequence[np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor]:
        """([batch, H, W, 3] uint8 canvas, [batch, 2] scale_xy), on the
        model's device, of the (checked) `images`: each resized and placed
        top-left, cropped to the canvas; unused slots stay black with scale
        1.  The canvas is filled in pinned host memory and copied without
        blocking; the model casts it to its compute dtype."""
        pin = self.device.type == "cuda"
        ph, pw = self.canvas_hw
        host = torch.zeros((self.batch, ph, pw, 3), dtype=torch.uint8, pin_memory=pin)
        scale = torch.ones((self.batch, 2), dtype=torch.float32, pin_memory=pin)
        view = host.numpy()
        for i, img in enumerate(images):
            resized, scale_xy = self.preprocess(img)
            view[i, : resized.shape[0], : resized.shape[1]] = resized[:ph, :pw]
            scale[i] = torch.from_numpy(scale_xy)
        return (host.to(self.device, non_blocking=True),
                scale.to(self.device, non_blocking=True))

    def detect(self, images: Sequence[np.ndarray]) -> List[List[Dict]]:
        """One list of detections per request image, in its coordinates."""
        self.check(images)  # refuse before any batch runs
        results = []
        for start in range(0, len(images), self.batch):
            chunk = images[start : start + self.batch]
            out = self.step(*self.canvas(chunk))
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


class Predictor(FrontEnd):
    """The front end of `model` (on its device) and `cfg`: the config's test
    canvas (`pad_target_hw`) and its eval step."""

    def __init__(self, model, cfg, batch: int):
        canvas_hw = pad_target_hw(cfg, train=False)
        super().__init__(make_eval_step(model, cfg, canvas_hw), T.eval_preprocess_meta(cfg),
                         canvas_hw, batch, next(model.parameters()).device)
        self.cfg = cfg
