"""Layers of the port that are not models of their own: deformable conv
(``deform_conv``) and int8 (w8a8) eval convs (``quant``)."""

from dafne_torch.layers.quant import (  # noqa: F401
    MIN_QUANT_CHANNELS,
    Int8Conv2d,
    calibrate_act_scales,
    conv_is_quantizable,
    int8_conv,
    int8_site_plan,
    load_act_scales,
    module_site,
    quantize_kernel_per_channel,
    quantize_tensor_dynamic,
    quantize_tensor_static,
    quantized_eval_model,
    save_act_scales,
)
