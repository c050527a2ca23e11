"""Port's DLA, VoVNet and MobileNetV2 trunks vs the flax ones.

Each of their registry names inside the detector (default bodies, a narrow
FPN and head), float32, batch 2 at 64^2: the trunk's features and the
detector's outputs against JAX's and the optimizer labels label for label;
every other DLA and VoVNet body as a trunk alone.  Setup and tolerance:
``tests/torch_backbone_cases.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dafne_tpu.models import backbones as JB

from dafne_torch.engine.optimizer import param_labels
from dafne_torch.models import backbones as B
from dafne_torch.models import build_model
from dafne_torch.utils.weights import params_from_flax

from tests.test_torch_model import narrow_cfgs
from tests.torch_backbone_cases import (HW, assert_close, check_detector, check_labels,
                                        draw_params, setup)

torch.set_num_threads(2)

NAMES = ["build_dafne_dla_fpn_backbone", "build_dla_fpn_backbone", "build_vovnet_fpn_backbone",
         "build_fcos_vovnet_fpn_backbone", "build_mnv2_backbone",
         "build_mobilenetv2_fpn_backbone"]
BODIES = ([("dla", b) for b in sorted(JB.DLA_SPECS) if b != "DLA34"]
          + [("vovnet", b) for b in sorted(JB.VOVNET_SPECS) if b != "V-39-eSE"])


@pytest.mark.parametrize("name", NAMES)
def test_detector_matches_flax(name):
    check_detector(["MODEL.BACKBONE.NAME", name])


@pytest.mark.parametrize("kind,body", BODIES, ids=[b for _, b in BODIES])
def test_body_matches_flax(kind, body):
    """A trunk alone: params_from_flax fills every key, features match."""
    jtrunk, trunk = ((JB.DLA(body=body), B.DLA(body)) if kind == "dla"
                     else (JB.VoVNet(spec=body), B.VoVNet(body)))
    x = np.random.RandomState(5).uniform(-120, 130, (2, HW, HW, 3)).astype(np.float32)
    shapes = jax.eval_shape(jtrunk.init, jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))
    params = draw_params(dict(shapes["params"]), seed=sum(map(ord, body)))
    sd = params_from_flax(params)
    assert set(sd) == set(trunk.state_dict())
    trunk.load_state_dict(sd, strict=True)
    want = jtrunk.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = trunk(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert sorted(got) == sorted(want) == ["res3", "res4", "res5"]
    channels = B.feature_channels(kind, body)
    for name in sorted(want):
        assert want[name].shape[-1] == channels[name], name
        assert_close([got[name].permute(0, 2, 3, 1)], [want[name]], name)


@pytest.mark.parametrize("name", ["build_dafne_dla_fpn_backbone", "build_vovnet_fpn_backbone",
                                  "build_mnv2_backbone"])
@pytest.mark.parametrize("freeze_at", [0, 2])
def test_optimizer_labels_match_jax(name, freeze_at):
    check_labels(["MODEL.BACKBONE.NAME", name], freeze_at)


def test_frozen_bn_quirks_are_kept():
    """JAX's labels, restated: a ``*_bn`` FrozenBN's affine trains
    ("default" / "bias"), and "backbone/stem" freezes VoVNet's and
    MobileNetV2's stems with their BNs."""
    for name, param, lab in (
            ("build_dafne_dla_fpn_backbone", "backbone.level1_bn.weight", "default"),
            ("build_dafne_dla_fpn_backbone", "backbone.level1_bn.bias", "bias"),
            ("build_vovnet_fpn_backbone", "backbone.stem2_bn.weight", "frozen"),
            ("build_vovnet_fpn_backbone", "backbone.stage3_block0.concat_bn.weight", "default"),
            ("build_vovnet_fpn_backbone", "backbone.stage3_block0.ese.fc.weight", "default"),
            ("build_mnv2_backbone", "backbone.stem_bn.bias", "frozen"),
            ("build_mnv2_backbone", "backbone.block3.dw_bn.weight", "default")):
        _, tcfg, _, _, model = setup(("MODEL.BACKBONE.NAME", name))
        assert param_labels(tcfg, model)[param] == lab, param


def test_feature_channels_match_jax_fpn():
    """The port's FPN input widths are the ones JAX's FPN kernels take."""
    for name in ("build_dafne_dla_fpn_backbone", "build_vovnet_fpn_backbone",
                 "build_mnv2_backbone"):
        _, _, _, params, model = setup(("MODEL.BACKBONE.NAME", name))
        for f in ("res3", "res4", "res5"):
            want = params["fpn"][f"lateral_{f}"]["kernel"].shape[2]
            assert getattr(model.fpn, f"lateral_{f}").weight.shape[1] == want, (name, f)
    assert B.feature_channels("mobilenet") == {"res3": 32, "res4": 96, "res5": 320}
    assert B.feature_channels("vovnet", "V-19-eSE") == {"res3": 512, "res4": 768, "res5": 1024}
    assert B.feature_channels("dla", "dla34") == {"res3": 128, "res4": 256, "res5": 512}


def test_unknown_body_raises():
    _, tcfg = narrow_cfgs(["MODEL.BACKBONE.NAME", "build_dla_fpn_backbone",
                           "MODEL.DLA.CONV_BODY", "DLA7"])
    with pytest.raises(KeyError):
        build_model(tcfg, device="cpu")


def test_init_weights_follow_jax():
    """JAX's initializers for the new modules: a deformable conv's offset
    conv zeros and its 1x1 normal(0.01); ESE's Dense flax's LeCun truncated
    normal with zero bias; convs, depthwise ones too, He-normal on fan-out."""
    from dafne_torch.layers.deform_conv import DeformConv2d

    _, tcfg = narrow_cfgs(["MODEL.BACKBONE.NAME", "build_resnet_interval_backbone",
                           "MODEL.DAFNE.USE_DEFORMABLE", "True"])
    deform = [m for m in build_model(tcfg, device="cpu").modules()
              if isinstance(m, DeformConv2d)]
    assert len(deform) == 13 + 3
    for m in deform:
        assert not m.offset_conv.weight.any() and not m.offset_conv.bias.any()
        assert 0.008 < float(m.weight.weight.std()) < 0.012
    _, tcfg = narrow_cfgs(["MODEL.BACKBONE.NAME", "build_vovnet_fpn_backbone"])
    fc = build_model(tcfg, device="cpu").backbone.stage5_block1.ese.fc
    std = np.sqrt(1.0 / fc.in_features)
    assert not fc.bias.any() and float(fc.weight.abs().max()) <= 2 * std / 0.87962566103423978
    assert 0.9 * std < float(fc.weight.std()) < 1.1 * std
    _, tcfg = narrow_cfgs(["MODEL.BACKBONE.NAME", "build_mnv2_backbone"])
    dw = build_model(tcfg, device="cpu").backbone.block10.dw.weight  # [384, 1, 3, 3]
    assert dw.shape[1] == 1
    assert 0.9 < float(dw.std()) / np.sqrt(2.0 / (dw.shape[0] * 9)) < 1.1
