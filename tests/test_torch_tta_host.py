"""TTA's host path, port vs JAX, on the narrow R-50 with the same weights.

``tta_inference_single`` with every copy rendered on the host
(TPU.TTA_DEVICE_AUG False: resizes and flips through the host library)
and with 30-degree copies (separable copies on the device, the rotated
ones through ``warp_affine_linear``) must match at least 99% of the JAX
package's merged detections, which it renders with cv2, under the rule of
``tests/test_torch_tta.py`` (same class, score within 1e-4, corners within
1e-2).
"""

import pytest
import torch

from dafne_tpu.engine import tta as JTTA
from dafne_tpu.models import build_model as jax_build_model

from dafne_torch.data.synthetic import load_synthetic_gen
from dafne_torch.engine import tta

from chip_smoke import match_rate
from test_torch_model import narrow_cfgs, port_model_from, random_flax_params
from test_torch_tta import LADDER, SMALL_NMS

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    return load_synthetic_gen("val", 1, hw=128, max_boxes=10)[0]


@pytest.mark.parametrize("extra,host_copies", [
    (["TPU.TTA_DEVICE_AUG", "False"], 6),
    (["TEST.AUG.ROTATION_ANGLES", "(30.0,)"], 4),
])
def test_tta_host_path_matches_jax(scene, extra, host_copies):
    jcfg, tcfg = narrow_cfgs(LADDER + SMALL_NMS + extra)
    jmodel = jax_build_model(jcfg)
    params = random_flax_params(jmodel, seed=41, hw=128)
    want = JTTA.tta_inference_single(jcfg, JTTA.BucketedEvalSteps(jcfg, jmodel), params,
                                     scene["image"])
    model = port_model_from(params, tcfg).eval()
    stats = {}
    got = tta.tta_inference_single(tcfg, tta.BucketedEvalSteps(tcfg, model), scene["image"], stats)
    assert stats["copies"] == 6 and stats["host_copies"] == host_copies
    matched, total = match_rate({"0": got}, {"0": want})
    assert total >= 50, total
    assert matched >= 0.99 * total, (matched, total)
    assert abs(len(got["scores"]) - total) <= 0.01 * total
