"""Port's ResNet trunks vs the flax ones on the same weights and images.

The registry's ResNet names (``build_dafne_resnet_fpn_backbone``, the
deformable-interval ``build_resnet_interval_backbone``, the anti-aliased
``build_resnet_lpf_backbone``), ResNet-18/34/152, ANTI_ALIAS on the plain
name, and the interval trunk at DEFORM_INTERVAL 2 under STRIDE_IN_1X1
False (a first block keeps its strided regular 3x3) with deformable head
towers, each inside the detector with a narrow FPN and head (the ResNets
narrow too; ResNet-LPF has fixed widths), float32, batch 2 at 64^2: the
trunk's features and the detector's outputs against JAX's, and the
optimizer labels label for label.  Setup and tolerance:
``tests/torch_backbone_cases.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dafne_tpu.models import backbones as JB

from dafne_torch.layers.deform_conv import DeformConv2d
from dafne_torch.models import backbones as B

from tests.torch_backbone_cases import check_detector, check_labels, setup

torch.set_num_threads(2)

CASES = {
    "resnet50": ["MODEL.BACKBONE.NAME", "build_dafne_resnet_fpn_backbone"],
    "interval": ["MODEL.BACKBONE.NAME", "build_resnet_interval_backbone"],
    "lpf": ["MODEL.BACKBONE.NAME", "build_resnet_lpf_backbone"],
    "anti_alias": ["MODEL.BACKBONE.ANTI_ALIAS", "True"],
    **{f"resnet{d}": ["MODEL.RESNETS.DEPTH", str(d)] for d in (18, 34, 152)},
    "interval2_stride_in_3x3_deformable_head": [
        "MODEL.BACKBONE.NAME", "build_resnet_interval_backbone",
        "MODEL.RESNETS.DEFORM_INTERVAL", "2", "MODEL.RESNETS.STRIDE_IN_1X1", "False",
        "MODEL.DAFNE.USE_DEFORMABLE", "True"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_resnet_trunk_matches_flax(case):
    check_detector(CASES[case])


@pytest.mark.parametrize("case", ["interval", "lpf", "resnet18",
                                  "interval2_stride_in_3x3_deformable_head"])
@pytest.mark.parametrize("freeze_at", [0, 2])
def test_optimizer_labels_match_jax(case, freeze_at):
    got = check_labels(CASES[case], freeze_at)
    assert got["backbone/res3_1/conv1/kernel"] == "default"


def test_interval_blocks_and_deformable_towers():
    """Which 3x3s are deformable: every k-th block of res3-res5 where that
    3x3 has stride 1; the last conv of each tower but the share tower."""
    _, _, _, _, model = setup(tuple(CASES["interval2_stride_in_3x3_deformable_head"]))
    bb = model.backbone
    deform = {n.rpartition(".")[0] for n, m in bb.named_modules() if isinstance(m, DeformConv2d)}
    assert deform == {"res3_2", "res4_2", "res4_4", "res5_2"}  # b % 2 == 0, b > 0
    assert bb.res3_0.conv2.stride == (2, 2)
    for tower in ("cls_tower", "corners_tower", "center_tower"):
        t = getattr(model.head, tower)
        assert isinstance(getattr(t, f"conv{t.num_convs - 1}"), DeformConv2d), tower
        assert not isinstance(t.conv0, DeformConv2d)
    _, _, _, _, model = setup(tuple(CASES["interval"]))
    deform = {n.rpartition(".")[0] for n, m in model.backbone.named_modules()
              if isinstance(m, DeformConv2d)}
    assert len(deform) == 4 + 6 + 3  # interval 1: every block of res3-res5
    assert "res2_0" not in deform


def test_lpf_freeze_stops_the_gradient():
    """ResNet-LPF stops the gradient after the stem and each stage <=
    FREEZE_AT, as JAX's stop_gradient does."""
    _, _, _, _, model = setup(tuple(CASES["lpf"]))
    x = torch.rand(1, 3, 64, 64, requires_grad=True)
    sum(v.sum() for v in model.backbone(x).values()).backward()
    assert x.grad is None
    assert model.backbone.res2_0.conv1.weight.grad is None
    assert model.backbone.res3_0.conv1.weight.grad is not None
    model.zero_grad(set_to_none=True)


def test_blur_pool_matches_jax_and_reflects():
    rng = np.random.RandomState(3)
    x = rng.rand(2, 9, 10, 5).astype(np.float32)
    want = np.asarray(JB.blur_pool(jnp.asarray(x), 2))
    got = B.blur_pool(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ones = B.blur_pool(torch.ones(1, 1, 6, 6))
    assert torch.equal(ones, torch.ones_like(ones))  # REFLECT: no darkened border


@pytest.mark.parametrize("case", ["resnet18", "resnet152", "interval"])
def test_detectron2_backbone_keys_map_as_in_jax(case):
    """A Detectron2 checkpoint of the trunk (``backbone.bottom_up.res2.0.
    conv1.weight`` ...): the port's importer uses and leaves unmatched the
    same keys as JAX's (a deformable conv2 maps in neither), and fills
    each used tensor."""
    from dafne_tpu.utils.weight_import import import_state_dict as jax_import
    from dafne_torch.utils.weight_import import import_state_dict

    from chip_smoke import d2_name

    _, _, _, params, model = setup(tuple(CASES[case]))
    rng = np.random.RandomState(11)
    sd = {d2_name(k.replace(".conv2.weight.weight", ".conv2.weight")):
          rng.randn(*v.shape).astype(np.float32)
          for k, v in model.state_dict().items()
          if k.startswith("backbone.") and ".offset_conv." not in k}
    _, jreport = jax_import(sd, params)
    new, report = import_state_dict(sd, model.state_dict())
    assert sorted(report.used) == sorted(jreport.used)
    assert sorted(report.unmatched) == sorted(jreport.unmatched)
    assert len(report.used) == len(report.filled) > 0
    deform = [k for k in sd if k.endswith(".conv2.weight") and k.replace(
        "backbone.bottom_up.", "").split(".")[0] in ("res3", "res4", "res5")]
    assert (set(report.unmatched) == set(deform)) == (case == "interval")
