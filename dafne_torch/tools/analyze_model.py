"""Model analysis: parameters, FLOPs and bytes, structure.

    python -m dafne_torch.tools.analyze_model --config-file configs/dota-1.0/1024.yaml \
        [--tasks flop parameter structure] [--image-size 1024] [--batch 1] [--cpu] [KEY VALUE ...]

Counterpart of ``tools/analyze_model.py``.  The model of the config, with
seeded random weights (``--seed``), on the card unless ``--cpu`` is given.

- *parameter*: the table (``--table`` prints every row) in the JAX
  package's names and shapes (``utils/weights.py::params_to_flax``), the
  total, and the totals per top-level group (backbone, fpn, head,
  top_module).  The total counts the tensors JAX's ``param_table`` counts:
  every ``nn.Parameter`` and the FrozenBN statistics and affines, which
  are buffers here and parameters there (frozen by the optimizer's labels
  in JAX); a BN tower's running statistics are JAX's ``batch_stats``, not
  parameters, in both.  ``torch_parameters`` is ``sum(p.numel())`` over
  ``model.parameters()``, ``frozen_bn_buffers`` the rest.
- *flop*: the forward on a zero batch of ``--batch`` images at the canvas
  (``--image-size``, else the config's test canvas), counted by
  ``torch.utils.flop_counter.FlopCounterMode``: the convolutions and
  matrix products, a multiply-add as 2.  The ``dafne::`` ops have no
  formula there; ``count_work`` adds their own counts
  (``ops/kernels/quad_nms.py``, ``quant.py``, ``deform_conv.py``), and the
  assignment kernel, a direct ctypes call, is counted by its caller
  (``ops/kernels/assign.py::pair_counts``).  The JAX tool prints XLA's
  cost analysis of the compiled forward, which counts a conv's taps on
  its input only (not on its padding) and also counts elementwise work
  (norms, activations, the normalization of the pixels):
  ``tests/test_torch_tools.py`` records the ratio of the two.
  The bytes are the least the forward must move: the images read once,
  the model's state read once, the head's outputs written once.
- *structure*: the module tree to depth 2, with each module's parameters.

Prints the JAX tool's lines and then one JSON object with every figure,
the device ("cpu" or the card's name) and its power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List, Tuple

import torch


def load_cfg(config_file: str, opts=()):
    """The config of `config_file` (YAML, needs PyYAML) with the dotted
    overrides `opts`."""
    from dafne_torch.config import get_cfg

    cfg = get_cfg()
    if config_file:
        cfg.merge_from_file(config_file)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg


def resolve_device(cpu: bool) -> str:
    """"cpu" with `cpu`, else "cuda"; raises SystemExit when there is no card:
    a measurement never falls back to the CPU."""
    if cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this tool runs on the card "
                         "(--cpu runs it on the CPU)")
    return "cuda"


def build(cfg, device: str, seed: int = 0):
    from dafne_torch.models import build_model

    return build_model(cfg, device=device, generator=torch.Generator().manual_seed(seed))


# ---- parameters -------------------------------------------------------------


def param_rows(model) -> List[Tuple[str, tuple, int]]:
    """(dotted JAX name, JAX shape, elements) of every leaf of the JAX
    package's param tree of `model` (``params_to_flax``)."""
    from dafne_torch.utils.weights import params_to_flax

    def walk(tree, prefix):
        for k, v in tree.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                yield from walk(v, name)
            else:
                yield name, tuple(v.shape), int(v.size)

    return list(walk(params_to_flax(model)[0], ""))


def parameter_report(model) -> dict:
    """{"total", "groups", "torch_parameters", "frozen_bn_buffers", "rows"}."""
    from dafne_torch.models.layers import FrozenBN

    rows = param_rows(model)
    groups: Dict[str, int] = {}
    for name, _, n in rows:
        groups[name.split(".")[0]] = groups.get(name.split(".")[0], 0) + n
    frozen = sum(b.numel() for m in model.modules() if isinstance(m, FrozenBN)
                 for _, b in m.named_buffers(recurse=False))
    return {"total": sum(n for _, _, n in rows), "groups": dict(sorted(groups.items())),
            "torch_parameters": sum(p.numel() for p in model.parameters()),
            "frozen_bn_buffers": frozen, "rows": rows}


# ---- work -------------------------------------------------------------------


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nest of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return 0


def state_bytes(model) -> int:
    """Bytes of the model's state (parameters and buffers): what a forward reads once."""
    return tensor_bytes(list(model.state_dict().values()))


def program_bytes(inputs, model, outputs, train_optimizer=None) -> int:
    """The least bytes a program of `model` moves: its inputs read once, the
    model's state read once, its outputs written once; with
    `train_optimizer` (a train step), the trainable parameters written and
    the optimizer's state read and written too."""
    n = tensor_bytes(inputs) + state_bytes(model) + tensor_bytes(outputs)
    if train_optimizer is not None:
        n += sum(p.numel() * p.element_size() for p in model.parameters() if p.requires_grad)
        n += 2 * sum(tensor_bytes(list(s.values())) for s in train_optimizer.state.values())
    return n


def _kernel_formulas(work: Dict[str, dict]) -> dict:
    """FlopCounterMode formulas for the ``dafne::`` ops: each records its
    own count of this call into `work` ({op: {"calls", "f32_ops",
    "int8_ops", "bytes"}}, from its inputs, since NMS work depends on the
    data) and gives the FLOP total 0, which holds the tensor-core work."""
    from dafne_torch.ops.kernels import deform_conv as DK
    from dafne_torch.ops.kernels import quad_nms as K
    from dafne_torch.ops.kernels import quant as QK

    def note(op, f32_ops=0, int8_ops=0, nbytes=0):
        w = work.setdefault(op, {"calls": 0, "f32_ops": 0, "int8_ops": 0, "bytes": 0})
        w["calls"] += 1
        w["f32_ops"] += int(f32_ops)
        w["int8_ops"] += int(int8_ops)
        w["bytes"] += int(nbytes)
        return 0

    def suppression(op):
        def f(corners, classes, *args, out_val=None, **kwargs):
            b, n = classes.shape
            return note(op, K.same_class_pairs(classes) * K.OPS_PER_PAIR,
                        nbytes=K.suppression_bytes(b, n))
        return f

    def greedy(bits, keep_init, *args, out_val=None, **kwargs):
        return note("greedy_keep_bits", nbytes=K.greedy_bytes(out_val))

    def deform(x, offsets, mask, *args, out_val=None, **kwargs):
        n, c, h, w = x.shape
        ops = DK.OPS_FORWARD + (DK.OPS_FORWARD_MASK if mask is not None else 0)
        return note("deform_im2col", ops * n * 9 * c * h * w,
                    nbytes=DK.forward_bytes(n, c, h, w, x.element_size(), mask is not None))

    def deform_backward(x, offsets, mask, grad_cols, *args, out_val=None, **kwargs):
        n, c, h, w = x.shape
        ops = DK.OPS_BACKWARD + (DK.OPS_BACKWARD_MASK if mask is not None else 0)
        return note("deform_im2col_backward", ops * n * 9 * c * h * w,
                    nbytes=DK.backward_bytes(n, c, h, w, x.element_size(), mask is not None))

    def quantize(x, *args, out_val=None, **kwargs):
        n, c, h, w = x.shape
        return note("quantize_act", nbytes=QK.quantize_bytes(n, c, h, w, x.element_size()))

    def int8_conv(xq, xs, wq, ws, bias, stride, padding, dilation, out_dtype, *args,
                  out_val=None, **kwargs):
        n, h, w, c = xq.shape
        o, kh, kw = wq.shape[:3]
        ho, wo = out_val.shape[2:]
        return note("int8_conv", int8_ops=QK.conv_ops(n, c, o, kh, kw, ho, wo),
                    nbytes=QK.conv_bytes(n, c, h, w, o, kh, kw, ho, wo, out_val.element_size(),
                                         bias is not None))

    formulas = {torch.ops.dafne.suppression_bits: suppression("suppression_bits"),
                torch.ops.dafne.suppression_bits_2d: suppression("suppression_bits_2d"),
                torch.ops.dafne.greedy_keep_bits: greedy,
                torch.ops.dafne.deform_im2col: deform,
                torch.ops.dafne.deform_im2col_backward: deform_backward,
                torch.ops.dafne.quantize_act: quantize,
                torch.ops.dafne.int8_conv: int8_conv}
    for f in formulas.values():
        f._get_raw = True  # the raw tensors, not their shapes
    return formulas


def count_work(fn: Callable[[], object]) -> Tuple[dict, object]:
    """({"flops": the convolutions' and matrix products' FLOPs (a
    multiply-add as 2, backward included where fn runs one), "kernels":
    {dafne op: its calls, f32 ops, int8 ops and bytes}}, fn's result) of
    one call of fn under FlopCounterMode."""
    import dafne_torch.ops.kernels  # noqa: F401  (registers the dafne ops)
    from torch.utils.flop_counter import FlopCounterMode

    work: Dict[str, dict] = {}
    with FlopCounterMode(display=False, custom_mapping=_kernel_formulas(work)) as counter:
        result = fn()
    return {"flops": int(counter.get_total_flops()), "kernels": work}, result


def forward_work(model, images: torch.Tensor) -> dict:
    """``count_work`` of the forward on `images` (inference mode), with
    its bytes: the images, the state and the head's outputs, once each."""
    with torch.inference_mode():
        work, out = count_work(lambda: model(images))
    work["bytes"] = program_bytes(images, model, {k: v for k, v in out.items() if k != "hw"})
    return work


# ---- structure ----------------------------------------------------------------


def structure(model, depth: int = 2) -> List[str]:
    """One line per module to `depth`: its name, type and parameters."""
    lines = []

    def walk(mod, name, level):
        n = sum(p.numel() for p in mod.parameters())
        lines.append(f"{'  ' * level}{name or '(model)'}  {type(mod).__name__}  {n:,}")
        if level < depth:
            for child_name, child in mod.named_children():
                walk(child, f"{name}.{child_name}" if name else child_name, level + 1)

    walk(model, "", 0)
    return lines


# ---- the command line -----------------------------------------------------------


def analyze(cfg, tasks, device: str, image_size: int = 0, batch: int = 1, seed: int = 0,
            table: bool = False) -> dict:
    """The report of `tasks` for the model of `cfg` on `device`, printed as
    the JAX tool prints it; returns the figures."""
    from dafne_torch.data.mapper import pad_target_hw
    from dafne_torch.tools.canary import card_fields

    model = build(cfg, device, seed)
    hw = (image_size, image_size) if image_size else pad_target_hw(cfg, train=False)
    report = {"image_hw": list(hw), "batch": batch, **card_fields(device)}
    if "parameter" in tasks:
        p = parameter_report(model)
        print(f"\n=== Parameters: {p['total'] / 1e6:.2f} M total ===")
        for g, n in p["groups"].items():
            print(f"  {g:20s} {n / 1e6:8.2f} M")
        print(f"  (torch parameters {p['torch_parameters']:,} + FrozenBN buffers "
              f"{p['frozen_bn_buffers']:,})")
        if table:
            for name, shape, n in p["rows"]:
                print(f"  {name:70s} {str(shape):22s} {n:,}")
        report["parameter"] = {k: v for k, v in p.items() if k != "rows"}
    if "flop" in tasks:
        images = torch.zeros((batch,) + tuple(hw) + (3,), device=device)
        work = forward_work(model, images)
        print(f"\n=== FlopCounterMode (forward, image {tuple(hw)}, batch {batch}) ===")
        print(f"  flops:          {work['flops'] / 1e9:.2f} GFLOP (convolutions and matrix "
              f"products; XLA's cost analysis in the JAX tool also counts elementwise work)")
        print(f"  bytes accessed: {work['bytes'] / 1e6:.1f} MB (images, state and outputs, "
              f"once each)")
        for op, w in work["kernels"].items():
            print(f"  dafne::{op}: {w}")
        report["flop"] = work
    if "structure" in tasks:
        print("\n=== Structure ===")
        print("\n".join(structure(model, depth=2)))
    print(json.dumps(report), flush=True)
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config-file", required=True, metavar="FILE")
    p.add_argument("--tasks", nargs="+", default=["flop", "parameter"],
                   choices=["flop", "parameter", "structure"])
    p.add_argument("--image-size", type=int, default=0, help="square canvas (default: the "
                   "config's test canvas)")
    p.add_argument("--batch", type=int, default=1, help="images in the counted forward")
    p.add_argument("--seed", type=int, default=0, help="the random weights' torch seed")
    p.add_argument("--table", action="store_true", help="print every parameter row")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="dotted-key config overrides")
    args = p.parse_args(argv)
    cfg = load_cfg(args.config_file, args.opts)
    analyze(cfg, args.tasks, resolve_device(args.cpu), args.image_size, args.batch, args.seed,
            args.table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
