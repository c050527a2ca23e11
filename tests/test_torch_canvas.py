"""One scene on a canvas larger than the image, the port against JAX.

The narrow R-50 of ``tests/test_torch_model.py`` with the same weights
(``draw_params``: cls bias -2, so NMS runs full) evaluates one 192^2
synthetic scene placed on a 256^2 canvas (zeros past the image, as the
eval loader pads) through JAX's jitted eval step and the port's.  The
detections match as ``tests/test_torch_decode.py`` holds them: >= 99% of
one side's valid detections matched by the other's (same class, score
within 1e-4, corners within 1e-2), both ways.  So the padded canvas
gives the same result in both packages: what the padding does to the GN
towers' statistics, it does to JAX's too.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from dafne_tpu.engine.trainer import make_eval_step as jax_make_eval_step
from dafne_tpu.models import build_model as jax_build_model

from dafne_torch.data.synthetic import load_synthetic_gen
from dafne_torch.engine.inference import make_eval_step

from chip_smoke import match_rate
from test_torch_model import narrow_cfgs, port_model_from
from torch_backbone_cases import draw_params

torch.set_num_threads(2)

IMAGE, CANVAS = 192, 256


def _preds(det):
    det = {k: np.asarray(v) for k, v in det.items()}
    return {str(b): {k: det[k][b][det["valid"][b]] for k in ("classes", "scores", "corners")}
            for b in range(det["valid"].shape[0])}


def test_padded_canvas_matches_jax():
    jcfg, tcfg = narrow_cfgs(["MODEL.DAFNE.PRE_NMS_TOPK_TEST", "200",
                              "TPU.NMS_MAX_CANDIDATES", "256",
                              "MODEL.DAFNE.POST_NMS_TOPK_TEST", "100"])
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, CANVAS, CANVAS, 3)))
    params = draw_params(dict(shapes["params"]), seed=13)
    images = np.zeros((1, CANVAS, CANVAS, 3), np.float32)
    images[0, :IMAGE, :IMAGE] = load_synthetic_gen("val", 1, hw=IMAGE)[0]["image"]
    want = _preds(jax.jit(jax_make_eval_step(jmodel, jcfg, (CANVAS, CANVAS)))(
        params, jnp.asarray(images)))
    got = _preds({k: v.numpy() for k, v in make_eval_step(
        port_model_from(params, tcfg), tcfg, (CANVAS, CANVAS))(torch.from_numpy(images)).items()})
    for a, b in ((got, want), (want, got)):
        matched, total = match_rate(a, b)
        assert total >= 50 and matched >= 0.99 * total, (matched, total)
