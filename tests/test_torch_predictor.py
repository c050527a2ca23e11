"""The port's request front end on the CPU: canvas placement, batching, and
refusal of requests that do not fit."""

import numpy as np
import pytest
import torch

from dafne_torch.config import get_cfg
from dafne_torch.engine.predictor import Predictor
from dafne_torch.models import build_model

torch.set_num_threads(1)

HW = 128


@pytest.fixture(scope="module")
def predictor():
    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.RESNETS.STEM_OUT_CHANNELS", "16", "MODEL.RESNETS.WIDTH_PER_GROUP", "8",
        "MODEL.RESNETS.RES2_OUT_CHANNELS", "32", "MODEL.FPN.OUT_CHANNELS", "32",
        "TPU.COMPUTE_DTYPE", "float32", "INPUT.MAX_SIZE_TEST", str(HW),
        "TPU.NMS_MAX_CANDIDATES", "256", "MODEL.DAFNE.POST_NMS_TOPK_TEST", "50",
    ])
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.head.cls_logits.bias.fill_(-2.0)
    return Predictor(model, cfg, batch=2)


def _requests(seed, shapes):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in shapes]


def test_canvas_places_requests_top_left(predictor):
    assert predictor.canvas_hw == (HW, HW)
    reqs = _requests(0, [(100, 60), (HW, HW)])
    canvas = predictor.canvas(reqs[:1])
    assert canvas.dtype == torch.uint8 and canvas.device.type == "cpu"
    assert tuple(canvas.shape) == (2, HW, HW, 3)
    np.testing.assert_array_equal(canvas[0, :100, :60].numpy(), reqs[0])
    assert int(canvas[0, 100:].sum()) == 0 and int(canvas[0, :, 60:].sum()) == 0
    assert int(canvas[1].sum()) == 0  # the unused batch slot stays black
    np.testing.assert_array_equal(predictor.canvas(reqs)[1].numpy(), reqs[1])


def test_detect_equals_eval_step_on_the_float_canvas(predictor):
    """Three requests at batch 2: two batches, the second one short.  Each
    image's detections are the eval step's valid slots on a float32 canvas,
    highest score first."""
    reqs = _requests(1, [(HW, HW), (90, 120), (64, 32)])
    dets = predictor.detect(reqs)
    assert len(dets) == 3
    step = predictor.step
    for start in (0, 2):
        chunk = reqs[start : start + 2]
        canvas = np.zeros((2, HW, HW, 3), np.float32)
        for i, img in enumerate(chunk):
            canvas[i, : img.shape[0], : img.shape[1]] = img
        want = {k: v.numpy() for k, v in step(torch.from_numpy(canvas)).items()}
        for b in range(len(chunk)):
            got = dets[start + b]
            idx = np.nonzero(want["valid"][b])[0]
            assert len(got) == len(idx) > 0
            order = idx[np.argsort(-want["scores"][b, idx], kind="stable")]
            np.testing.assert_array_equal([d["class"] for d in got], want["classes"][b, order])
            np.testing.assert_array_equal([d["score"] for d in got], want["scores"][b, order])
            np.testing.assert_array_equal([d["corners"] for d in got], want["corners"][b, order])
            np.testing.assert_array_equal([d["hbox"] for d in got], want["hboxes"][b, order])


@pytest.mark.parametrize("bad", ["taller", "wider", "float", "gray", "empty"])
def test_detect_refuses_bad_requests_before_any_batch(predictor, bad):
    image = {
        "taller": np.zeros((HW + 1, 10, 3), np.uint8),
        "wider": np.zeros((10, HW + 1, 3), np.uint8),
        "float": np.zeros((10, 10, 3), np.float32),
        "gray": np.zeros((10, 10), np.uint8),
        "empty": np.zeros((0, 10, 3), np.uint8),
    }[bad]
    calls = []
    step = predictor.step
    predictor.step = lambda *a: calls.append(1) or step(*a)
    try:
        with pytest.raises(ValueError, match="request 2"):
            predictor.detect(_requests(2, [(32, 32), (32, 32)]) + [image])
    finally:
        predictor.step = step
    assert not calls  # the good first batch never ran
