"""Calibrate static activation scales for int8 eval.

    python -m dafne_torch.tools.calibrate_int8 --config-file configs/dota-1.0/1024.yaml \
        [--num-batches 8] [--output OUTPUT_DIR/int8_scales.json] [--cpu] [KEY VALUE ...]

Counterpart of ``tools/calibrate_int8.py``.  The model of the config with
the newest checkpoint under OUTPUT_DIR restored (else MODEL.WEIGHTS; scales
depend on trained weights, so random ones serve only tests of the tooling)
runs ``--num-batches`` eval batches of the config's first TEST dataset in
full precision through ``layers/quant.py::calibrate_act_scales``, which
records max|x| at the input of every eligible conv, and the {site: amax}
JSON is written (``save_act_scales``: the JAX package's format, which
either package loads).  The sites are those eligible at
``TPU.EVAL_INT8_MIN_CHANNELS``, or at 64 (the static default) when it is 0,
so the table covers any width chosen at serving time.  Point
``TPU.EVAL_INT8_SCALES`` at the JSON, with ``TPU.EVAL_INT8 True``, to run
those sites with static scales.  Runs on the card unless ``--cpu`` is
given.  Prints one JSON line: sites, dataset, checkpoint step, output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional


def calibrate(cfg, model, records, num_batches: int, min_channels: int,
              image_ids: Optional[list] = None) -> Dict[str, float]:
    """{site: amax} of `model` (on its device) over the first `num_batches`
    eval batches (TPU.EVAL_BATCH, the tight eval canvas) of `records`; a
    list `image_ids` receives the ids of the images read."""
    from dafne_torch.data.loader import DataLoader
    from dafne_torch.data.mapper import eval_pad_hw
    from dafne_torch.layers.quant import calibrate_act_scales

    dev = next(model.parameters()).device
    loader = DataLoader(cfg, records, max(1, int(cfg.TPU.EVAL_BATCH)),
                        pad_hw=eval_pad_hw(cfg, records), train=False)

    def batches():
        for i, batch in enumerate(loader):
            if i >= num_batches:
                break
            if image_ids is not None:
                image_ids.extend(b for b, ok in zip(batch["image_id"], batch["batch_valid"]) if ok)
            yield batch["image"].to(dev)

    return calibrate_act_scales(model, batches(), min_channels=min_channels)


def main(argv=None, device: str = "cuda") -> str:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config-file", required=True, metavar="FILE")
    p.add_argument("--num-batches", type=int, default=8)
    p.add_argument("--output", default="", help="default OUTPUT_DIR/int8_scales.json")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="dotted-key config overrides")
    args = p.parse_args(argv)

    from dafne_torch.config import get_cfg
    from dafne_torch.data.registry import get_dataset, register_all_datasets
    from dafne_torch.engine.checkpoint import restore_for_inference
    from dafne_torch.layers.quant import MIN_QUANT_CHANNELS, save_act_scales

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    min_channels = int(cfg.TPU.EVAL_INT8_MIN_CHANNELS) or MIN_QUANT_CHANNELS
    register_all_datasets(cfg)
    model, step = restore_for_inference(cfg, "cpu" if args.cpu else device)

    dataset = cfg.DATASETS.TEST[0]
    scales = calibrate(cfg, model, get_dataset(dataset, cfg), args.num_batches, min_channels)
    out = args.output or os.path.join(cfg.OUTPUT_DIR, "int8_scales.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_act_scales(out, scales)
    print(json.dumps({"sites": len(scales), "dataset": dataset, "checkpoint_step": step,
                      "min_channels": min_channels, "output": out}), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
