"""Full-width forward parity of the port, the counterpart of
``tests/test_full_forward_parity.py``.

The same three cases (R-50 GN 256^2, R-101 GN 128^2, R-50 with per-level
BN towers 128^2; float32): one synthetic Detectron2 checkpoint (He-rescaled,
contractive BN affines, as that test draws it) goes through the port's
importer into the port's model and through JAX's importer into the flax
tree.  The port's filled state dict equals JAX's import
(``params_from_flax(params, batch_stats)``) tensor for tensor, every
reference tensor used and every target filled; and the port's forward on
the same random images equals the torch re-statement of the reference
network (``tests/torch_reference_model.py``), which
``tests/test_full_forward_parity.py`` holds the flax model to, within that
test's tolerance (atol 1e-3 with a 5e-5 max|ref| floor, rtol 1e-4).
"""

import jax
import numpy as np
import pytest
import torch

from dafne_tpu.models import build_model as jax_build_model
from dafne_tpu.utils import weight_import as JW

from dafne_torch.config import get_cfg
from dafne_torch.models import build_model
from dafne_torch.utils import weight_import as W
from dafne_torch.utils.weights import params_from_flax

from test_full_forward_parity import PIXEL_MEAN, _assert_close, _bn_checkpoint, _flax_cfg, _he_rescale
from test_weight_import_exhaustive import make_dafne_checkpoint
from torch_reference_model import TorchDAFNe

torch.set_num_threads(2)


def _port_cfg(depth, norm):
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", str(depth), "MODEL.DAFNE.NUM_CLASSES", "15",
                         "MODEL.DAFNE.NORM", norm, "MODEL.PIXEL_MEAN", str(PIXEL_MEAN),
                         "MODEL.PIXEL_STD", "[1.0, 1.0, 1.0]", "TPU.COMPUTE_DTYPE", "float32"])
    return cfg


def _jax_import(sd, depth, norm):
    """JAX's import of `sd` as the port's state dict, and its report.  The
    flax tree to fill is zeros on ``jax.eval_shape``'s shapes."""
    jmodel = jax_build_model(_flax_cfg(depth, norm))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), np.zeros((1, 128, 128, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    merged = JW.merge_batch_stats(zeros["params"], zeros.get("batch_stats"))
    new, report = JW.import_state_dict(sd, merged)
    params, stats = JW.split_batch_stats(new)
    as_np = lambda t: None if t is None else jax.tree_util.tree_map(np.asarray, t)
    return params_from_flax(as_np(params), as_np(stats)), report


@pytest.mark.parametrize(
    "depth,norm,hw",
    [(50, "GN", 256), (101, "GN", 128), (50, "BN", 128)],
    ids=["r50-gn-256", "r101-gn-128", "r50-bn-128"],
)
def test_port_full_forward_parity(depth, norm, hw):
    rng = np.random.RandomState(depth + (17 if norm == "BN" else 0))
    sd = _he_rescale((make_dafne_checkpoint if norm == "GN" else _bn_checkpoint)(depth, 15, rng),
                     15)
    sd_in = {k: v for k, v in sd.items() if not k.startswith("pixel_")}

    model = build_model(_port_cfg(depth, norm), device="cpu")
    report = W.import_into(model, sd_in)
    assert report.unmatched == [] and report.unfilled == []
    want_sd, jax_report = _jax_import(sd_in, depth, norm)
    assert jax_report.unmatched == [] and jax_report.unfilled == []
    got_sd = model.state_dict()
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
    if norm == "BN":
        assert sum(".running_" in k and k.startswith("head.") for k in got_sd) == 3 * 4 * 5 * 2

    ref = TorchDAFNe(depth=depth, num_classes=15, norm=norm)
    missing, unexpected = ref.load_state_dict(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, strict=False)
    assert not unexpected and all("num_batches_tracked" in k for k in missing)
    ref.eval()
    x = rng.uniform(0, 255, (2, hw, hw, 3)).astype(np.float32)
    with torch.no_grad():
        t_logits, t_corners, t_ctr = ref(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        out = model(torch.from_numpy(x))
    for what, ref_levels, key in (("cls_logits", t_logits, "logits"),
                                  ("corners", t_corners, "corners"),
                                  ("ctrness", t_ctr, "ctrness")):
        _assert_close(ref_levels, [o.numpy() for o in out[key]], what, atol=1e-3)
