"""int8 (w8a8) eval convolutions, counterpart of ``dafne_tpu/layers/quant.py``.

Opt-in with ``TPU.EVAL_INT8``; with it off nothing here runs and the eval
program is the model itself.  With it on, every eligible conv of the eval
program runs as

  - weights: symmetric per-output-channel scales (max|w| over the kh, kw,
    cin axes / 127), quantized from the float32 parameter;
  - activations: a per-image dynamic scale (max|x| / 127 of each batch
    element's slab), or a static one calibrated by ``calibrate_act_scales``;
  - an s32 sum, dequantized with ``acc * (x_scale * w_scale) (+ bias)`` in
    float32 and cast to the conv's output dtype, so everything around the
    conv (norms, activations, residual adds) runs as in the float path.

The two kernels, the activation quantize and the implicit-GEMM conv, are
the ops ``dafne::quantize_act`` and ``dafne::int8_conv``
(``ops/kernels/library.py``): ``csrc/int8_conv.cu`` on the card, the plain
versions of ``ops/kernels/quant.py`` on the CPU.  A CUDA tensor launches
the kernels or raises.

Eligibility (``conv_is_quantizable``) is JAX's: a plain conv (the port's
``models.layers.Conv2d``, JAX's ``nn.Conv``), one feature group, input and
output channels at least ``min_channels``, a 2-D kernel with padding given
as numbers.  Every conv JAX computes otherwise stays full precision: the
stems of 3 input channels, depthwise and grouped convs, the blur-pool,
every predictor (<= 15 output channels) and the deformable offset
generators (18).

PyTorch runs eagerly, so instead of JAX's flax interceptor (which runs
the original conv as well and lets XLA drop it) each site's mode is
decided once, when the eval program is built (``quantized_eval_model``):
the eligible ``Conv2d`` modules of a structural copy of the model (sharing
its tensors) are replaced by ``Int8Conv2d``, whose weights are quantized
then, as XLA folds JAX's weight quantization into constants.  The per-site
rule is ``make_int8_conv_interceptor``'s (here ``int8_site_plan``): a site
in the scales table runs static, one with an amax <= 0 dynamic; without a
table every eligible site runs dynamic; with one, an uncalibrated site
narrower than ``dynamic_min_channels`` (256) stays full precision.  A
site's key (``module_site``) is the flax path, the port's qualified module
name with "/" for ".", so a scales JSON of either package loads in the
other.

  JAX (dafne_tpu/layers/quant.py)   here
  quantize_tensor_dynamic / _static quantize_tensor_dynamic / _static
  quantize_kernel_per_channel (HWIO) quantize_kernel_per_channel (OIHW)
  int8_conv (NHWC)                  int8_conv (NCHW)
  conv_is_quantizable, module_site  the same
  make_int8_conv_interceptor        int8_site_plan
  quantized_eval_scope              quantized_eval_model
  calibrate_act_scales, save_act_scales, load_act_scales  the same
"""

from __future__ import annotations

import copy
import itertools
import json
from typing import Dict, Iterable, Optional, Union

import torch
from torch import nn

from dafne_torch.models.layers import Conv2d
from dafne_torch.ops.kernels import quant as K

# floors keep 0-range tensors (all-zero activations or weights) finite;
# both are far below any trained tensor's scale
_ACT_SCALE_FLOOR = K.ACT_SCALE_FLOOR  # 1e-8
_W_SCALE_FLOOR = 1e-12

MIN_QUANT_CHANNELS = 64
#: with a scales table, uncalibrated sites narrower than this stay full
#: precision (JAX's ``dynamic_min_channels``)
DYNAMIC_MIN_CHANNELS = 256


def quantize_tensor_dynamic(x: torch.Tensor):
    """(x_q int8, scale f32 [N, 1, ..., 1]) with x ~= x_q * scale: one scale
    per leading-axis element, max|x| / 127 over its whole slab, so an
    image's quantization never depends on its batchmates."""
    xf = x.float()
    scale = K.act_scale_dynamic(xf).reshape((-1,) + (1,) * (x.dim() - 1))
    return K.quantize_with_scale(xf, scale), scale


def quantize_tensor_static(x: torch.Tensor, amax: float):
    """(x_q int8, scale f32 scalar) with the calibrated constant scale
    amax / 127; values past the calibrated range saturate at +-127."""
    scale = torch.tensor(K.static_act_scale(amax), dtype=torch.float32, device=x.device)
    return K.quantize_with_scale(x.float(), scale), scale


def quantize_kernel_per_channel(w: torch.Tensor):
    """(w_q int8 OIHW, scale f32 [O]) with w ~= w_q * scale, one scale per
    output channel over (in, kh, kw), from the float32 weight."""
    wf = w.float()
    amax = wf.abs().amax(dim=(1, 2, 3))
    scale = torch.clamp_min(amax / amax.new_tensor(127.0), _W_SCALE_FLOOR)
    return K.quantize_with_scale(wf, scale[:, None, None, None]), scale


def _pair(v) -> tuple:
    return (v, v) if isinstance(v, int) else tuple(v)


def int8_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], stride,
              padding, dilation, out_dtype: torch.dtype, act_amax: Optional[float] = None,
              weight_q: Optional[torch.Tensor] = None, weight_scale: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """w8a8 conv of x [N, C, H, W] with the OIHW float32 `weight` (or its
    quantized form `weight_q` [O, KH, KW, C] with `weight_scale`), the
    float32 `bias` or None, symmetric `padding`: dynamic per-image
    activation scales unless a calibrated `act_amax` is given.  Through
    ``dafne::quantize_act`` and ``dafne::int8_conv``."""
    if weight_q is None:
        wq, weight_scale = quantize_kernel_per_channel(weight)
        weight_q = wq.permute(0, 2, 3, 1).contiguous()
    scale = 0.0 if act_amax is None else K.static_act_scale(act_amax)
    xq, xs = torch.ops.dafne.quantize_act(x, scale)
    return torch.ops.dafne.int8_conv(xq, xs, weight_q, weight_scale,
                                     None if bias is None else bias.float(),
                                     list(_pair(stride)), list(_pair(padding)),
                                     list(_pair(dilation)), out_dtype)


def conv_is_quantizable(mod: nn.Module, min_channels: int = MIN_QUANT_CHANNELS) -> bool:
    """True iff `mod` is a plain ``Conv2d`` that runs in int8: one group,
    at least `min_channels` in and out (``in_channels`` is the input's
    channel count), a 2-D kernel, zero padding given as numbers."""
    if type(mod) is not Conv2d:
        return False
    if mod.groups != 1 or mod.in_channels < min_channels or mod.out_channels < min_channels:
        return False
    if len(tuple(mod.kernel_size)) != 2 or mod.padding_mode != "zeros":
        return False
    return not isinstance(mod.padding, str)


def module_site(name: str) -> str:
    """A module's key in a scales table: its flax path, "/"-joined."""
    return name.replace(".", "/")


def resolve_min_channels(min_channels: Optional[int], act_scales) -> int:
    """``quantized_eval_scope``'s width rule: None (the bare API) is 64;
    0 or less (the config's auto) is 64 with a scales table and 256
    without one."""
    if min_channels is None:
        return MIN_QUANT_CHANNELS
    if min_channels <= 0:
        return MIN_QUANT_CHANNELS if act_scales else DYNAMIC_MIN_CHANNELS
    return int(min_channels)


def int8_site_plan(model: nn.Module, min_channels: int = MIN_QUANT_CHANNELS,
                   act_scales: Optional[Dict[str, float]] = None,
                   dynamic_min_channels: int = DYNAMIC_MIN_CHANNELS
                   ) -> Dict[str, Optional[float]]:
    """{qualified module name: static amax, or None for dynamic} of the
    sites to quantize, by ``make_int8_conv_interceptor``'s rule."""
    act_scales = act_scales or None  # an empty table is no table: dynamic
    plan = {}
    for name, mod in model.named_modules():
        if not conv_is_quantizable(mod, min_channels):
            continue
        amax = act_scales.get(module_site(name)) if act_scales else None
        if amax is not None and amax <= 0:
            amax = None  # all-zero at calibration is not zero at serving
        if amax is None and act_scales is not None and not conv_is_quantizable(
                mod, dynamic_min_channels):
            continue  # an uncalibrated narrow site in static mode: full precision
        plan[name] = amax
    return plan


class Int8Conv2d(nn.Module):
    """The w8a8 stand-in of one eligible ``Conv2d``.

    With `quantize_weights` the weight is quantized once, here, into the
    buffers ``weight_q`` [O, KH, KW, C] int8 and ``weight_scale`` [O]; else
    the module keeps the float32 ``weight`` parameter and quantizes it at
    each call (an exported program whose weights are inputs).  The float32
    ``bias`` is kept as it is.  `act_amax` None is a dynamic activation
    scale."""

    def __init__(self, conv: Conv2d, act_amax: Optional[float], quantize_weights: bool = True):
        super().__init__()
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation
        self.act_amax = act_amax
        self.bias = conv.bias
        if quantize_weights:
            with torch.no_grad():
                wq, ws = quantize_kernel_per_channel(conv.weight)
            self.register_buffer("weight_q", wq.permute(0, 2, 3, 1).contiguous(),
                                 persistent=False)
            self.register_buffer("weight_scale", ws, persistent=False)
            self.weight = None
        else:
            self.weight = conv.weight
            self.weight_q = self.weight_scale = None

    @property
    def mode(self) -> str:
        return "dynamic" if self.act_amax is None else "static"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_conv(x, self.weight, self.bias, self.stride, self.padding, self.dilation,
                         x.dtype, self.act_amax, self.weight_q, self.weight_scale)


def quantize_sites(model: nn.Module, plan: Dict[str, Optional[float]],
                   quantize_weights: bool = True) -> nn.Module:
    """A copy of `model` whose modules named in `plan` are ``Int8Conv2d``;
    the copy shares every parameter and buffer with `model`, which is left
    as it was."""
    memo = {id(t): t for t in itertools.chain(model.parameters(), model.buffers())}
    qmodel = copy.deepcopy(model, memo)
    for name, amax in plan.items():
        parent, _, leaf = name.rpartition(".")
        owner = qmodel.get_submodule(parent) if parent else qmodel
        setattr(owner, leaf, Int8Conv2d(getattr(owner, leaf), amax, quantize_weights))
    return qmodel


def int8_settings(cfg) -> dict:
    """{"enabled", "min_channels", "scales"} from ``TPU.EVAL_INT8``,
    ``EVAL_INT8_MIN_CHANNELS`` and ``EVAL_INT8_SCALES``; the scales JSON is
    read now, so a later deletion of the file cannot break a built step."""
    enabled = bool(cfg.TPU.EVAL_INT8)
    scales = cfg.TPU.EVAL_INT8_SCALES or None
    if enabled and isinstance(scales, str):
        scales = load_act_scales(scales)
    return {"enabled": enabled, "min_channels": int(cfg.TPU.EVAL_INT8_MIN_CHANNELS),
            "scales": scales if enabled else None}


def quantized_eval_model(model: nn.Module, enabled: bool = True,
                         min_channels: Optional[int] = None,
                         act_scales: Union[None, str, Dict[str, float]] = None,
                         quantize_weights: bool = True) -> nn.Module:
    """`model` with its eligible convs in int8, or `model` itself when
    `enabled` is False: ``quantized_eval_scope``'s counterpart, with its
    width rule (``resolve_min_channels``).  `act_scales` is a {site: amax}
    dict or the path of a JSON of ``save_act_scales``."""
    if not enabled:
        return model
    if isinstance(act_scales, str):
        act_scales = load_act_scales(act_scales)
    plan = int8_site_plan(model, resolve_min_channels(min_channels, act_scales), act_scales)
    return quantize_sites(model, plan, quantize_weights)


def int8_sites(model: nn.Module) -> Dict[str, str]:
    """{qualified name: "dynamic" or "static"} of a model's ``Int8Conv2d``s."""
    return {name: m.mode for name, m in model.named_modules() if isinstance(m, Int8Conv2d)}


# ---------------------------------------------------------------------------
# static-scale calibration (abs-max PTQ)
# ---------------------------------------------------------------------------


def calibrate_act_scales(model: nn.Module, batches: Iterable[torch.Tensor],
                         min_channels: int = MIN_QUANT_CHANNELS, slack: float = 1.0
                         ) -> Dict[str, float]:
    """{site: max|x| * slack} over `batches` (raw images as the model takes
    them) at the input of every eligible conv that the full-precision
    forward calls; the max over calls (a tower's levels) and batches."""
    amax: Dict[str, torch.Tensor] = {}

    def record(site):
        def hook(mod, args):
            m = args[0].detach().float().abs().amax()
            amax[site] = torch.maximum(amax[site], m) if site in amax else m
        return hook

    handles = [mod.register_forward_pre_hook(record(module_site(name)))
               for name, mod in model.named_modules() if conv_is_quantizable(mod, min_channels)]
    try:
        with torch.inference_mode():
            for images in batches:
                model(images)
    finally:
        for h in handles:
            h.remove()
    return {k: float(v) * slack for k, v in amax.items()}


def save_act_scales(path: str, scales: Dict[str, float]) -> None:
    with open(path, "w") as f:
        json.dump(scales, f, indent=1, sort_keys=True)


def load_act_scales(path: str) -> Dict[str, float]:
    with open(path) as f:
        return {str(k): float(v) for k, v in json.load(f).items()}

