"""Test-time augmentation (``engine/tta.py``), port vs JAX, and the fast
exact ``poly_nms`` of its merge.

``build_tta_augs`` and the canvas and batch choices of
``BucketedEvalSteps`` must equal JAX's; ``poly_nms`` must keep exactly what
the one-pair-at-a-time loop keeps, on seeded random quads with tied
scores, duplicates and degenerate quads; ``tta_inference_single`` on the
narrow R-50 with the same weights (``params_from_flax``) must match at
least 99% of JAX's merged detections under the rule of
``tests/test_torch_eval.py`` (same class, score within 1e-4, corners
within 1e-2).  The host path (TPU.TTA_DEVICE_AUG False, and copies that
are not separable) runs through the host warps.  The CLI runs TTA after
``do_test`` with TEST.AUG.ENABLED on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from dafne_tpu.engine import tta as JTTA
from dafne_tpu.models import build_model as jax_build_model
from dafne_tpu.utils import polyiou as jax_polyiou
from dafne_tpu.utils import polyiou_np as jax_polyiou_np

from dafne_torch.data import image_warp as IW
from dafne_torch.data.registry import DatasetCatalog, MetadataCatalog
from dafne_torch.data.synthetic import GEN_CLASSES, load_synthetic_gen
from dafne_torch.engine import tta
from dafne_torch.models import build_model
from dafne_torch.tools.train import main as cli_main
from dafne_torch.utils import polyiou

from chip_smoke import match_rate
from test_torch_model import NARROW, narrow_cfgs, port_model_from, random_flax_params

torch.set_num_threads(1)

SMALL_NMS = ["TPU.NMS_GROUP_CANDIDATES", "64", "TPU.NMS_MAX_CANDIDATES", "256",
             "MODEL.DAFNE.PRE_NMS_TOPK_TEST", "300", "MODEL.DAFNE.POST_NMS_TOPK_TEST", "100",
             "MODEL.DAFNE.NUM_CLASSES", "6"]
LADDER = ["TEST.AUG.MIN_SIZES", "(128, 256)", "TEST.AUG.MAX_SIZE", "256"]


@pytest.mark.parametrize("extra", [
    [], ["TEST.AUG.ROTATION_ANGLES", "(90.0, 180.0)"], ["TEST.AUG.VFLIP", "False"],
    ["TEST.AUG.MIN_SIZES", "(256, 512, 756, 1024, 1536)", "TEST.AUG.MAX_SIZE", "1536"]])
def test_build_tta_augs_equal_jax(extra):
    jcfg, cfg = narrow_cfgs(LADDER + extra)
    for w, h in ((128, 128), (200, 150), (1024, 1024)):
        got, want = tta.build_tta_augs(cfg, w, h), JTTA.build_tta_augs(jcfg, w, h)
        assert len(got) == len(want)
        if not extra:
            assert len(got) == 6
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.matrix, b.matrix)
            assert (a.out_w, a.out_h) == (b.out_w, b.out_h)


@pytest.mark.parametrize("extra", [
    [], ["TEST.AUG.MAX_SIZE", "1536"], ["TEST.AUG.MAX_SIZE", "4000", "TPU.IMAGE_SIZE_DIVISIBILITY", "32"]])
def test_bucketed_eval_steps_pick_jax_canvases_and_batches(extra):
    jcfg, cfg = narrow_cfgs(extra)
    ours = tta.BucketedEvalSteps(cfg, build_model(cfg, device="cpu"))
    theirs = JTTA.BucketedEvalSteps(jcfg, jax_build_model(jcfg))
    for needed in (1, 100, 128, 129, 256, 384, 500, 756, 768, 1000, 1024, 1100, 1536, 1700, 5000):
        for transpose in (False, True):
            hw, _, batch = ours.get_fused((1024, 1024), (needed, needed // 2), transpose)
            jhw, _, jbatch = theirs.get_fused((1024, 1024), (needed, needed // 2), transpose)
            assert (hw, batch) == (jhw, jbatch), needed


def _quads(rng, n, extent=200.0, bowties=True):
    """Rotated rectangles, a tenth of them near-duplicates of others, a few
    degenerate (a point, a segment) and, with `bowties`, a twentieth with
    two corners swapped."""
    c = rng.uniform(0, extent, (n, 2))
    s = rng.uniform(4, 40, (n, 2))
    a = rng.uniform(0, np.pi, n)
    d = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]]) * 0.5 * s[:, None]
    x = c[:, None, 0] + d[..., 0] * np.cos(a)[:, None] - d[..., 1] * np.sin(a)[:, None]
    y = c[:, None, 1] + d[..., 0] * np.sin(a)[:, None] + d[..., 1] * np.cos(a)[:, None]
    q = np.stack([x, y], -1).reshape(n, 8)
    dup = rng.choice(n, n // 10, replace=False)
    q[dup] = q[rng.choice(n, len(dup))] + rng.uniform(-1, 1, (len(dup), 8))
    q[0] = np.repeat(q[0][:2][None], 4, 0).ravel()  # a point
    q[1, 4:] = q[1, :4]  # a segment
    if bowties:
        bow = rng.choice(np.arange(2, n), n // 20, replace=False)
        q[bow] = q[bow][:, [0, 1, 2, 3, 6, 7, 4, 5]]
    return q


def test_polygon_iou_takes_non_convex_quads():
    """Raw corners can form bowties and darts: the clipping neither
    overflows nor departs from the JAX package's native library there, and
    convex pairs keep the NumPy reference's values bit for bit."""
    rng = np.random.RandomState(6)
    p, q = rng.uniform(0, 100, (2, 3000, 8))
    got = polyiou.iou_poly_pairs(p, q)
    np.testing.assert_allclose(got, jax_polyiou.iou_poly_pairs(p, q), rtol=0, atol=1e-12)
    convex = _quads(rng, 400, bowties=False)[2:]
    other = _quads(rng, 400, bowties=False)[2:]
    np.testing.assert_array_equal(polyiou.iou_poly_pairs(convex, other),
                                  jax_polyiou_np.iou_pairs(convex, other))


@pytest.mark.parametrize("n,seed", [(0, 0), (1, 1), (40, 2), (300, 3), (700, 4)])
def test_poly_nms_equals_the_loop(n, seed):
    rng = np.random.RandomState(seed)
    boxes = _quads(rng, max(n, 2))[:n]
    scores = np.round(rng.rand(n), 1)  # many ties: the stable order decides
    for thr in (0.1, 0.5):
        got = polyiou.poly_nms(boxes, scores, thr)
        want = polyiou.poly_nms_plain(boxes, scores, thr)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == bool and got.shape == (n,)
        if n >= 300:
            assert 0 < got.sum() < n
            np.testing.assert_array_equal(got, jax_polyiou.poly_nms(boxes, scores, thr))


def test_poly_nms_blocks_equal_the_loop(monkeypatch):
    """Blocks smaller than the input: candidates in later blocks are tested
    against boxes kept in earlier ones."""
    rng = np.random.RandomState(5)
    boxes = _quads(rng, 200, extent=80.0)
    scores = rng.rand(200)
    monkeypatch.setattr(polyiou, "NMS_BLOCK", 16)
    np.testing.assert_array_equal(polyiou.poly_nms(boxes, scores, 0.1),
                                  polyiou.poly_nms_plain(boxes, scores, 0.1))


@pytest.fixture(scope="module")
def scene():
    return load_synthetic_gen("val", 1, hw=128, max_boxes=10)[0]


def test_tta_inference_single_matches_jax(scene):
    """6 copies (128 and 256 shortest edge, each as is, hflipped and
    vflipped) on canvases 128 and 256, grouped NMS with K = 64."""
    jcfg, tcfg = narrow_cfgs(LADDER + SMALL_NMS)
    jmodel = jax_build_model(jcfg)
    params = random_flax_params(jmodel, seed=41, hw=128)
    want = JTTA.tta_inference_single(jcfg, JTTA.BucketedEvalSteps(jcfg, jmodel), params,
                                     scene["image"])
    model = port_model_from(params, tcfg).eval()
    stats = {}
    got = tta.tta_inference_single(tcfg, tta.BucketedEvalSteps(tcfg, model), scene["image"], stats)
    assert set(got) == set(want)
    matched, total = match_rate({"0": got}, {"0": want})
    assert total >= 50, total
    assert matched >= 0.99 * total, (matched, total)
    assert abs(len(got["scores"]) - total) <= 0.01 * total
    assert stats["copies"] == 6 and stats["steps"] == {128: 1, 256: 1}
    assert stats["boxes_out"] == len(got["scores"]) <= stats["boxes_in"]
    assert min(stats["eval_ms"].values()) > 0 and stats["merge_ms"] > 0


def test_unported_tta_paths_raise(scene):
    """The host path: with TPU.TTA_DEVICE_AUG False every copy renders on
    the host (resizes and flips through ``resize_linear``), and with it on
    only the copies that are not separable (30 degrees: ``warp_affine_linear``);
    a float image on the host path raises (``apply_image`` takes uint8)."""
    _, cfg = narrow_cfgs(LADDER + SMALL_NMS)
    steps = tta.BucketedEvalSteps(cfg, build_model(cfg, device="cpu").eval())
    _, host = narrow_cfgs(LADDER + SMALL_NMS + ["TPU.TTA_DEVICE_AUG", "False"])
    IW.reset_launch_counts()
    stats = {}
    tta.tta_inference_single(host, steps, scene["image"], stats)
    assert stats["copies"] == stats["host_copies"] == 6 and stats["warp_ms"] == 0
    assert stats["steps"] == {128: 1, 256: 1} and stats["host_warp_ms"] > 0
    assert IW.resize_linear.launches == 3 and IW.warp_affine_linear.launches == 0
    _, rotated = narrow_cfgs(LADDER + SMALL_NMS + ["TEST.AUG.ROTATION_ANGLES", "(90.0, 30.0)"])
    IW.reset_launch_counts()
    stats = {}
    tta.tta_inference_single(rotated, steps, scene["image"], stats)
    assert stats["copies"] == 10 and stats["host_copies"] == 4
    assert IW.warp_affine_linear.launches == 4
    with pytest.raises(ValueError, match="uint8"):
        tta.tta_inference_single(host, steps, scene["image"].astype(np.float32))


def test_cli_eval_only_runs_tta(tmp_path):
    """--eval-only TEST.AUG.ENABLED True on the CPU: do_test, then TTA into
    results["tta"] with its files under OUTPUT_DIR/inference_tta."""
    name = "torch_tta_gen128"
    recs = load_synthetic_gen("val", 2, hw=128, max_boxes=8)
    DatasetCatalog.register(name, lambda: recs)
    MetadataCatalog[name] = {"evaluator_type": "synthetic", "thing_classes": GEN_CLASSES,
                             "is_test": False}
    args = [str(v) for v in NARROW] + LADDER + SMALL_NMS + [
        "OUTPUT_DIR", str(tmp_path), "DATASETS.TEST", f"('{name}',)", "INPUT.MIN_SIZE_TEST", "128",
        "INPUT.MAX_SIZE_TEST", "128", "TPU.EVAL_BATCH", "2", "TEST.NUM_PRED_VIS", "0",
        "DATALOADER.NUM_WORKERS", "0", "TEST.AUG.ENABLED", "True"]
    tta_stats = {}
    results = cli_main(["--eval-only"] + args, device="cpu", tta_stats=tta_stats)
    assert set(results) == {name, "tta"} and "mAP" in results["tta"][name]
    assert tta_stats[name]["images"] == 2 and len(tta_stats[name]["per_image"]) == 2
    out = tmp_path / "inference_tta" / name
    assert (out / "results.txt").exists()
    assert sorted(os.listdir(out / "task1")) == sorted(f"Task1_{c}.txt" for c in GEN_CLASSES)
