"""Export the whole eval step as one ``torch.export`` artifact.

    python -m dafne_torch.tools.export_model --config-file configs/dota-1.0/1024.yaml \
        [--output-dir OUT] [--batch N] [--weights-as-args] [--cpu] [KEY VALUE ...]
    python -m dafne_torch.tools.export_model --check OUT/model.pt2

Counterpart of ``tools/export_model.py``.  The model of the config with the
newest checkpoint under OUTPUT_DIR restored (else MODEL.WEIGHTS), and the
eval step's body (``engine/inference.py::EvalProgram``: the forward on raw
pixels, the decode, the rotated NMS with K1 and the greedy kernel, the
post-NMS top-k), are exported with ``torch.export.export`` (non-strict,
under ``torch.no_grad``) for inputs (images [B, H, W, 3] uint8, scale_xy
[B, 2] float32) on the test canvas, and saved with ``torch.export.save`` as
OUT/model.pt2 (OUT defaults to OUTPUT_DIR/export), the weights in it.  The
kernels are ``torch.ops.dafne`` ops (``ops/kernels/library.py``), call
nodes of the graph.  OUT/export_meta.json holds the canvas (``pad_hw``),
``batch``, ``checkpoint_step``, ``weights``, ``weights_as_args``,
``output_keys``, the eval preprocessing recipe
(``data/mapper.py::eval_preprocess_meta``), the device the program was
exported for and the torch version (in place of JAX's ``platforms``), and
the ``dafne::`` call nodes counted, and ``int8``: the int8 mode of
``TPU.EVAL_INT8`` ("off", "dynamic" or "static"), the minimum width, the
number of int8 sites and the scales table's content (not its path), so
that the artifact needs no file beside it.  B is TPU.EVAL_BATCH unless
``--batch`` is given.  The export runs on the card unless ``--cpu`` is given; the
program runs on the device it was exported for.

``--weights-as-args`` exports a program whose parameters and buffers are
its first input, a dict by name (``torch.func.functional_call``), and
saves no weights.  Under ``TPU.EVAL_INT8`` the int8 sites' weights are
then inputs in float32 too, so their per-channel quantization runs inside
the program at each call; a program with its own weights holds them
quantized once, at export.  ``--check`` loads an artifact with only ``torch`` and
the op library imported, replays zeros through it (not for a
weights-as-args artifact, which needs its weights) and prints the output
shapes.  ``python -m dafne_torch.tools.serve --artifact OUT/model.pt2``
serves it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter

import torch
from torch import nn

OUTPUT_KEYS = ["corners", "hboxes", "scores", "classes", "centerness", "locations", "valid"]


class WeightsAsArgs(nn.Module):
    """``forward(state, images, scale_xy)``: `program` run with `state` (its
    parameters and buffers by name) in place of its own tensors.  The
    program is held outside the module's children, so an export of this
    module owns no weights."""

    def __init__(self, program: nn.Module):
        super().__init__()
        self.__dict__["program"] = program

    def forward(self, state, images, scale_xy):
        return torch.func.functional_call(self.program, state, (images, scale_xy))


def program_state(program: nn.Module):
    """Every parameter and buffer (the non-persistent ones too) by name."""
    return {**dict(program.named_parameters()), **dict(program.named_buffers())}


def dafne_calls(exported) -> dict:
    """{op name: call nodes} of the ``dafne::`` ops in an exported graph."""
    calls = Counter()
    for node in exported.graph.nodes:
        name = getattr(node.target, "name", lambda: "")() if node.op == "call_function" else ""
        if name.startswith("dafne::"):
            calls[name.split("::", 1)[1].split(".", 1)[0]] += 1
    return dict(calls)


def build_exported(cfg, batch: int, weights_as_args: bool, device: str = "cuda"):
    """(ExportedProgram, export_meta dict) of `cfg`'s eval step at `batch`."""
    from dafne_torch.data.mapper import eval_preprocess_meta, pad_target_hw
    from dafne_torch.engine.checkpoint import restore_for_inference
    from dafne_torch.engine.inference import eval_program

    model, step = restore_for_inference(cfg, device)
    dev = next(model.parameters()).device
    pad_hw = pad_target_hw(cfg, train=False)
    program = eval_program(model, cfg, quantize_weights=not weights_as_args).eval()
    images = torch.zeros((batch, *pad_hw, 3), dtype=torch.uint8, device=dev)
    scale_xy = torch.ones((batch, 2), dtype=torch.float32, device=dev)
    with torch.no_grad():
        if weights_as_args:
            exported = torch.export.export(WeightsAsArgs(program),
                                           (program_state(program), images, scale_xy), strict=False)
        else:
            exported = torch.export.export(program, (images, scale_xy), strict=False)
    meta = {
        "pad_hw": list(pad_hw),
        "batch": int(batch),
        "checkpoint_step": int(step),
        "weights": cfg.MODEL.WEIGHTS,  # serve: /healthz reports untrained weights
        "weights_as_args": bool(weights_as_args),
        "device": dev.type,
        "torch": torch.__version__,
        "output_keys": OUTPUT_KEYS,
        "ops": dafne_calls(exported),
        "int8": program.int8,
        **eval_preprocess_meta(cfg),
    }
    return exported, meta


def check(path: str) -> int:
    """Load the artifact at `path` with only torch and the op library, and
    replay zeros through it unless its weights are inputs."""
    from dafne_torch.ops.kernels import library  # noqa: F401  (the dafne:: ops, before the load)

    t0 = time.perf_counter()
    exported = torch.export.load(path)
    meta_path = os.path.join(os.path.dirname(os.path.abspath(path)), "export_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    int8 = meta.get("int8") or {"mode": "off"}
    print(f"loaded in {time.perf_counter() - t0:.3f} s: exported for {meta['device']} with torch "
          f"{meta['torch']}; dafne:: call nodes {dafne_calls(exported)}; int8 {int8['mode']}"
          + (f" ({int8['sites']} sites, min {int8['min_channels']} channels)"
             if int8["mode"] != "off" else ""))
    if meta.get("weights_as_args"):
        print("weights-as-args artifact: the zero replay is skipped (it needs the weights)")
        return 0
    b, (h, w) = int(meta["batch"]), meta["pad_hw"]
    images = torch.zeros((b, h, w, 3), dtype=torch.uint8, device=meta["device"])
    scale_xy = torch.ones((b, 2), dtype=torch.float32, device=meta["device"])
    with torch.no_grad():
        out = exported.module()(images, scale_xy)
    print("replay OK, output shapes: "
          + json.dumps({k: list(out[k].shape) for k in meta["output_keys"]}))
    return 0


def main(argv=None, device: str = "cuda") -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config-file", default="", metavar="FILE")
    p.add_argument("--output-dir", default="", help="default OUTPUT_DIR/export")
    p.add_argument("--batch", type=int, default=0, help="images per call (default TPU.EVAL_BATCH)")
    p.add_argument("--weights-as-args", action="store_true",
                   help="the parameters and buffers as the program's first input; no weights saved")
    p.add_argument("--check", default="", metavar="ARTIFACT",
                   help="load and replay an artifact instead of exporting")
    p.add_argument("--cpu", action="store_true", help="export for the CPU instead of the card")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="dotted-key config overrides")
    args = p.parse_args(argv)
    if args.check:
        return check(args.check)
    if not args.config_file:
        raise SystemExit("need --config-file (or --check ARTIFACT)")
    from dafne_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    out_dir = args.output_dir or os.path.join(cfg.OUTPUT_DIR, "export")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    exported, meta = build_exported(cfg, args.batch or int(cfg.TPU.EVAL_BATCH),
                                    args.weights_as_args, "cpu" if args.cpu else device)
    path = os.path.join(out_dir, "model.pt2")
    torch.export.save(exported, path)
    with open(os.path.join(out_dir, "export_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps({"artifact": path, "bytes": os.path.getsize(path),
                      "seconds": round(time.perf_counter() - t0, 3), **meta}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
