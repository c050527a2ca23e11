"""Structural train-step ablations: where the train step's time goes.

    python -m dafne_torch.tools.ablate_train_step [--variants baseline,head_norm_none,...]
        [--out PROFILE_TRAIN_TORCH.json] [--iters 15] [--warmup 3] [--cpu] [KEY VALUE ...]

Counterpart of ``tools/ablate_train_step.py``: the full train step of the
profiler's flagship model (``train_step_profile.flagship_cfg``, batch 8,
1024^2, bf16) on its synthetic batch, under structural ablations, each a
fresh model with seeded random weights; pairwise differences localize
cost:

  baseline              the step as it is
  head_norm_none        MODEL.DAFNE.NORM none: the head's GroupNorms gone
  freeze_all_backbone   MODEL.BACKBONE.FREEZE_AT 5: no backbone backward
  towers_0              MODEL.DAFNE.NUM_CLS_CONVS 0 and NUM_BOX_CONVS 0: no head towers

Refused by name: ``remat_backbone`` (TPU.REMAT_BACKBONE) and
``no_space_to_depth`` (TPU.STEM_SPACE_TO_DEPTH), keys of the JAX
package's TPU namespace that the port does not read.  Each variant's ms
is CUDA events around ITERS steps after WARMUP steps (the host clock on
the CPU), under the CLI's cuDNN settings.  Unlike the JAX tool, which
prints a failed variant and goes on, a variant that fails ends the run
with its error.  Writes ``train_ablation_ms`` (with the card's name and
power limit) merged into ``--out`` and prints it as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

WARMUP, ITERS = 3, 15
VARIANTS = {
    "baseline": [],
    "head_norm_none": ["MODEL.DAFNE.NORM", "none"],
    "freeze_all_backbone": ["MODEL.BACKBONE.FREEZE_AT", "5"],
    "towers_0": ["MODEL.DAFNE.NUM_CLS_CONVS", "0", "MODEL.DAFNE.NUM_BOX_CONVS", "0"],
}
REFUSED = {
    "remat_backbone": "TPU.REMAT_BACKBONE is a key of the JAX package's TPU namespace "
                      "(jax.checkpoint over the backbone stages) that the port does not read",
    "no_space_to_depth": "TPU.STEM_SPACE_TO_DEPTH is a key of the JAX package's TPU "
                         "namespace (its stem lowering) that the port does not read",
}


def check_variants(names) -> None:
    """Raise SystemExit on a refused or unknown variant, naming it."""
    for v in names:
        if v in REFUSED:
            raise SystemExit(f"variant {v} refused: {REFUSED[v]}")
        if v not in VARIANTS:
            raise SystemExit(f"unknown variant {v!r}; variants: {', '.join(VARIANTS)}")


def run(names, device: str, opts=(), batch: int = 8, hw: int = 1024, iters: int = ITERS,
        warmup: int = WARMUP) -> dict:
    """{"train_ablation_ms": {variant: ms}, the card's fields}."""
    from dafne_torch.tools import train_step_profile as TSP
    from dafne_torch.tools.canary import card_fields, cli_backend_flags

    check_variants(names)
    out = {}
    with cli_backend_flags():
        P = TSP.Profile(device, opts, batch, hw, iters, warmup)
        for name in names:
            cfg = TSP.flagship_cfg(tuple(opts) + tuple(VARIANTS[name]))
            step, _, _ = P.train_step(cfg)
            out[name] = P.ms(lambda: step(P.b)["loss/total"])
            print(f"{name}: {out[name]:.3f} ms", flush=True)
            del step
            if device == "cuda":
                import torch

                torch.cuda.empty_cache()
    return {"train_ablation_ms": out, "batch": batch, "hw": hw, **card_fields(device)}


def main(argv=None) -> int:
    from dafne_torch.tools import train_step_profile as TSP
    from dafne_torch.tools.analyze_model import resolve_device

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--out", default=TSP.OUT, help="the record, merged into an existing one")
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--warmup", type=int, default=WARMUP)
    p.add_argument("--batch", type=int, default=TSP.BATCH)
    p.add_argument("--hw", type=int, default=TSP.HW)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="dotted-key config overrides")
    args = p.parse_args(argv)
    names = [v for v in args.variants.split(",") if v]
    check_variants(names)
    rec = run(names, resolve_device(args.cpu), args.opts, args.batch, args.hw, args.iters,
              args.warmup)
    abl = {"train_ablation_ms": rec["train_ablation_ms"],
           "train_ablation_device": rec["device"],
           "train_ablation_power_limit": rec["power_limit"]}
    TSP.write(abl, args.out, args.batch)
    print(json.dumps(abl), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
