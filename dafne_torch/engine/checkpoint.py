"""Checkpoints with resume-or-bootstrap semantics.

Counterpart of ``dafne_tpu/engine/checkpoint.py`` (:44-173): a checkpoint
holds the model's, the optimizer's and the LR scheduler's state dicts and
the step, written with ``torch.save`` under ``OUTPUT_DIR/checkpoints`` as
``model_<step>.pth``; the file ``last_checkpoint`` there names the newest,
and the last `max_to_keep` are kept.  ``resume_or_load`` resumes from the
newest checkpoint when asked and one exists, and otherwise loads
MODEL.WEIGHTS (a port ``.pth``: a checkpoint or a bare model state dict)
or keeps the initial weights.  Saves are synchronous (the JAX package saves
asynchronously); orbax checkpoints of the JAX package are not read.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

LAST = "last_checkpoint"


class Checkpointer:
    def __init__(self, output_dir: str, max_to_keep: int = 5):
        self.dir = os.path.abspath(os.path.join(output_dir, "checkpoints"))
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"model_{step:07d}.pth")

    def save(self, step: int, model, optimizer=None, scheduler=None) -> str:
        """Write the checkpoint of `step` (atomically: a reader never sees
        half a file) and point ``last_checkpoint`` at it.  Returns its path."""
        payload = {"model": model.state_dict(), "step": int(step)}
        if optimizer is not None:
            payload["optimizer"] = optimizer.state_dict()
        if scheduler is not None:
            payload["scheduler"] = scheduler.state_dict()
        path = self._path(step)
        torch.save(payload, f"{path}.tmp")
        os.replace(f"{path}.tmp", path)
        with open(os.path.join(self.dir, f"{LAST}.tmp"), "w") as f:
            f.write(os.path.basename(path))
        os.replace(os.path.join(self.dir, f"{LAST}.tmp"), os.path.join(self.dir, LAST))
        saved = sorted(p for p in os.listdir(self.dir) if p.startswith("model_") and p.endswith(".pth"))
        for old in saved[: max(len(saved) - self.max_to_keep, 0)]:
            os.remove(os.path.join(self.dir, old))
        return path

    def latest_step(self) -> Optional[int]:
        """The step of the checkpoint ``last_checkpoint`` names, or None."""
        try:
            with open(os.path.join(self.dir, LAST)) as f:
                name = f.read().strip()
        except FileNotFoundError:
            return None
        return int(name[len("model_"): -len(".pth")])

    def restore(self, model, optimizer=None, scheduler=None) -> int:
        """Load the newest checkpoint into `model` (and the optimizer and
        scheduler when given and saved).  Returns its step, 0 when there is
        none."""
        step = self.latest_step()
        if step is None:
            return 0
        device = next(model.parameters()).device
        payload = torch.load(self._path(step), map_location=device, weights_only=True)
        model.load_state_dict(payload["model"])
        if optimizer is not None and "optimizer" in payload:
            optimizer.load_state_dict(payload["optimizer"])
        if scheduler is not None and "scheduler" in payload:
            scheduler.load_state_dict(payload["scheduler"])
        return int(payload["step"])

    def resume_or_load(self, model, cfg, resume: bool, optimizer=None, scheduler=None) -> int:
        """Resume from OUTPUT_DIR when `resume` and a checkpoint exists;
        else load MODEL.WEIGHTS into the model when the file exists.
        Returns the step to start from."""
        if resume and self.latest_step() is not None:
            return self.restore(model, optimizer, scheduler)
        weights = cfg.MODEL.WEIGHTS
        if weights and os.path.exists(weights):
            device = next(model.parameters()).device
            payload = torch.load(weights, map_location=device, weights_only=True)
            model.load_state_dict(payload.get("model", payload))
        return 0
