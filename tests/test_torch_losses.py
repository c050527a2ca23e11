"""Port's DAFNe losses vs the JAX package in float32: values and gradients.

The same numpy-made head outputs and the same targets (the port's
assignment of numpy-made gts, handed to both) go through
``dafne_losses`` of both packages under each flag combination.  Values at
rtol 1e-5 (the same f32 formulas, summed in another order); gradients with
respect to logits, corners, center and ctrness at rtol 1e-4 (the backward
passes of two frameworks round differently), with an absolute floor of
1e-6 of the largest gradient for entries that are ~0.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dafne_tpu.ops.losses import LossSpec as JaxLossSpec
from dafne_tpu.ops.losses import dafne_losses as jax_dafne_losses

from dafne_torch.ops.losses import LossSpec, dafne_losses
from dafne_torch.ops.targets import AssignmentSpec, assign_targets
from dafne_torch.engine.trainer import make_location_tables

from tests.test_torch_targets import packed_gts

torch.set_num_threads(1)

CASES = {
    "default": {},
    "focal_no_alpha": {"focal_alpha": -1.0},
    "focal_a0.5_g1.5": {"focal_alpha": 0.5, "focal_gamma": 1.5},
    "plain_eight_point": {"loss_modulation": False},
    "linear_space": {"loss_logspace": False},
    "centerness_none": {"centerness": "none"},
    "centerness_plain": {"centerness": "plain"},
    "smoothl1_beta0": {"smooth_l1_beta": 0.0},
    "iou": {"loc_loss_type": "iou"},
    "giou": {"loc_loss_type": "giou"},
    "unsorted_corners": {"sort_corners": False},
    "no_center_reg_no_lambda_norm": {"has_center_reg": False, "lambda_norm": False,
                                     "lambda_cls": 10.0},
}


def inputs(seed, num_classes=3):
    """Head outputs [N, K, ...] and the targets of a 128^2 two-image batch."""
    rng = np.random.RandomState(seed)
    spec = AssignmentSpec(strides=(8, 16, 32, 64, 128), num_classes=num_classes)
    _, loc, st, rg = make_location_tables((128, 128), spec)
    gts = packed_gts(rng, 2, 16, n_max=8, num_classes=num_classes)
    tg = assign_targets(loc, st, rg, *(torch.from_numpy(gts[k]) for k in (
        "gt_corners", "gt_hbox", "gt_classes", "gt_area", "gt_valid")), spec)
    tg = {k: v.numpy() for k, v in tg.items()}
    n, k = tg["labels"].shape
    heads = {
        "logits": rng.randn(n, k, num_classes).astype(np.float32) * 2 - 2,
        # near the targets, so the IoU losses see overlapping quads
        "corners": (tg["reg_corners"] + rng.randn(n, k, 8) * 0.3).astype(np.float32),
        "center": rng.randn(n, k, 2).astype(np.float32),
        "ctrness": rng.randn(n, k).astype(np.float32),
    }
    return heads, tg


def _jax(heads, tg, spec):
    def total(lg, co, ce, ct):
        out = jax_dafne_losses(lg, co, ce if spec.has_center_reg else None, ct, tg, spec)
        return out["loss/total"], out

    (_, out), grads = jax.value_and_grad(total, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(heads[k]) for k in ("logits", "corners", "center", "ctrness")))
    return {k: float(v) for k, v in out.items()}, [np.asarray(g) for g in grads]


def _port(heads, tg, spec):
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in heads.items()}
    out = dafne_losses(t["logits"], t["corners"], t["center"] if spec.has_center_reg else None,
                       t["ctrness"], {k: torch.from_numpy(v) for k, v in tg.items()}, spec)
    out["loss/total"].backward()
    grads = [np.zeros_like(heads[k]) if t[k].grad is None else t[k].grad.numpy()
             for k in ("logits", "corners", "center", "ctrness")]
    return {k: float(v) for k, v in out.items()}, grads


@pytest.mark.parametrize("case", sorted(CASES))
def test_dafne_losses_match_jax(case):
    heads, tg = inputs(seed=sorted(CASES).index(case))
    spec = LossSpec(num_classes=3, **CASES[case])
    jspec = JaxLossSpec(**dataclasses.asdict(spec))
    got, got_g = _port(heads, tg, spec)
    want, want_g = _jax(heads, {k: jnp.asarray(v) for k, v in tg.items()}, jspec)
    assert set(got) == set(want)
    assert want["num_pos"] > 1
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    for name, g, w in zip(("logits", "corners", "center", "ctrness"), got_g, want_g):
        unused = (name == "center" and not spec.has_center_reg) or (
            name == "ctrness" and spec.centerness == "none")
        assert (np.abs(w).max() == 0) == unused, name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6 * np.abs(w).max(), err_msg=name)


def test_loss_spec_from_config_matches_jax():
    from dafne_tpu.config import get_cfg as jax_get_cfg
    from dafne_torch.config import get_cfg

    for recipe in ([], ["MODEL.DAFNE.LOSS_LAMBDA.CLS", "10.0", "MODEL.DAFNE.CENTERNESS", "plain",
                        "MODEL.DAFNE.LOC_LOSS_TYPE", "giou"]):
        jcfg, cfg = jax_get_cfg(), get_cfg()
        jcfg.merge_from_list(list(recipe))
        cfg.merge_from_list(list(recipe))
        assert dataclasses.asdict(LossSpec.from_config(cfg)) == dataclasses.asdict(
            JaxLossSpec.from_config(jcfg))
