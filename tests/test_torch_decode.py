"""The slice as a whole: decode on shared head outputs, and images to
detections end to end, port vs JAX."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dafne_tpu.engine.trainer import make_eval_step as jax_make_eval_step
from dafne_tpu.models import build_model as jax_build_model
from dafne_tpu.models.head import compute_locations as jax_compute_locations
from dafne_tpu.ops.postprocess import DecodeSpec as JaxDecodeSpec
from dafne_tpu.ops.postprocess import decode_detections as jax_decode

from dafne_torch.engine.inference import make_eval_step
from dafne_torch.ops.postprocess import DecodeSpec, decode_detections

from test_torch_model import narrow_cfgs, port_model_from, random_flax_params

torch.set_num_threads(1)

STRIDES = (8, 16, 32, 64, 128)


def _head_outputs(hw, batch, num_classes, seed):
    """Random per-level head outputs (NHWC numpy).  P4's logits and
    centerness are quantized, so it holds masses of exact score ties."""
    rng = np.random.RandomState(seed)
    out = {"logits": [], "corners": [], "ctrness": []}
    for lvl, s in enumerate(STRIDES):
        h = w = -(-hw // s)
        logits = rng.randn(batch, h, w, num_classes) - 2.5
        ctr = rng.randn(batch, h, w, 1)
        if lvl == 1:
            logits, ctr = np.round(logits * 2) / 2, np.round(ctr * 2) / 2
        center = rng.randn(batch, h, w, 2) * 0.3
        half = rng.uniform(0.5, 3.0, (batch, h, w, 1))
        ang = rng.uniform(0, np.pi, (batch, h, w))
        dx, dy = np.cos(ang)[..., None] * half, np.sin(ang)[..., None] * half
        aspect = rng.uniform(0.3, 1.0, (batch, h, w, 1))
        corners = np.concatenate(
            [center + np.concatenate(v, -1) for v in
             ((-dx + dy * aspect, -dy - dx * aspect), (dx + dy * aspect, dy - dx * aspect),
              (dx - dy * aspect, dy + dx * aspect), (-dx - dy * aspect, -dy + dx * aspect))],
            -1,
        )
        out["logits"].append(logits.astype(np.float32))
        out["ctrness"].append(ctr.astype(np.float32))
        out["corners"].append(corners.astype(np.float32))
    return out


DECODE_CASES = {
    # 256^2: P3/P4 take exact_topk_set (hw*c > 4k); 2100 survivors > 2048,
    # so the 1024 cap takes the exact-set branch; post-NMS top-200 binds
    "exact-cap": (["MODEL.DAFNE.PRE_NMS_TOPK_TEST", "600"], True),
    # 1200 survivors: the cap takes the top_k branch; thresholding on
    # sqrt(cls*ctr) and the un-mixed reported score
    "topk-cap-unmixed": (["MODEL.DAFNE.PRE_NMS_TOPK_TEST", "300",
                          "MODEL.DAFNE.THRESH_WITH_CTR", "True",
                          "MODEL.DAFNE.CENTERNESS_USE_IN_SCORE", "False"], False),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_equal_on_shared_head_outputs(case):
    extra, with_scale = DECODE_CASES[case]
    jcfg, tcfg = narrow_cfgs(extra + ["TPU.NMS_MAX_CANDIDATES", "1024",
                                      "MODEL.DAFNE.POST_NMS_TOPK_TEST", "200"])
    head = _head_outputs(256, 2, 15, seed=len(case))
    scale = np.array([[1.5, 2.0], [0.5, 1.0]], np.float32) if with_scale else None

    locs = [jax_compute_locations(-(-256 // s), -(-256 // s), s) for s in STRIDES]
    jspec = JaxDecodeSpec.from_config(jcfg)
    want = jax.jit(lambda h, sc: jax_decode(h, locs, jspec, sc))(
        jax.tree_util.tree_map(jnp.asarray, head), None if scale is None else jnp.asarray(scale)
    )
    got = decode_detections(
        {k: [torch.from_numpy(a) for a in v] for k, v in head.items()},
        DecodeSpec.from_config(tcfg),
        None if scale is None else torch.from_numpy(scale),
    )

    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    n_valid = want["valid"].sum(1)
    assert (n_valid == 200).all(), n_valid  # the post-NMS top-k binds
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["centerness"], want["centerness"], rtol=0, atol=1e-6)
    for key in ("corners", "hboxes", "locations"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4, err_msg=key)


def _match_rate(got, want):
    """Share of JAX's valid detections with a port detection of the same
    class, corners within 1e-2 and score within 1e-4."""
    matched = total = 0
    for b in range(want["valid"].shape[0]):
        wi = np.nonzero(want["valid"][b])[0]
        gi = np.nonzero(got["valid"][b])[0]
        total += len(wi)
        for i in wi:
            ok = (
                (got["classes"][b, gi] == want["classes"][b, i])
                & (np.abs(got["scores"][b, gi] - want["scores"][b, i]) <= 1e-4)
                & (np.abs(got["corners"][b, gi] - want["corners"][b, i]).max(1) <= 1e-2)
            )
            matched += bool(ok.any())
    return matched / max(total, 1), total


def test_images_to_detections_end_to_end():
    """JAX make_eval_step and the port's on the same weights and images.

    Model outputs agree to ~1e-5, not bit for bit, so two candidates whose
    scores tie within that drift may swap order at a top-k boundary or in
    NMS and change one detection; the test allows 1% of such slots."""
    hw = 128
    jcfg, tcfg = narrow_cfgs(["MODEL.DAFNE.PRE_NMS_TOPK_TEST", "300",
                              "TPU.NMS_MAX_CANDIDATES", "512",
                              "MODEL.DAFNE.POST_NMS_TOPK_TEST", "200"])
    jmodel = jax_build_model(jcfg)
    params = random_flax_params(jmodel, seed=7, hw=hw)
    images = np.random.RandomState(8).uniform(0, 255, (2, hw, hw, 3)).astype(np.float32)

    want = jax.jit(jax_make_eval_step(jmodel, jcfg, (hw, hw)))(params, jnp.asarray(images))
    step = make_eval_step(port_model_from(params, tcfg), tcfg, (hw, hw))
    got = step(torch.from_numpy(images))

    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    rate, total = _match_rate(got, want)
    assert total >= 100, total
    assert rate >= 0.99, (rate, total)
    assert abs(int(got["valid"].sum()) - int(want["valid"].sum())) <= 0.01 * total
