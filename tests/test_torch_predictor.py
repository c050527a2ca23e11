"""The port's request front end on the CPU: the eval resize and canvas
placement, batching, and refusal of malformed requests."""

import numpy as np
import pytest
import torch

from dafne_torch.config import get_cfg
from dafne_torch.data import transforms as T
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
        "TPU.COMPUTE_DTYPE", "float32", "INPUT.MIN_SIZE_TEST", str(HW),
        "INPUT.MAX_SIZE_TEST", str(HW),
        "TPU.NMS_MAX_CANDIDATES", "256", "MODEL.DAFNE.POST_NMS_TOPK_TEST", "50",
    ])
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.head.cls_logits.bias.fill_(-2.0)
    return Predictor(model, cfg, batch=2)


def _requests(seed, shapes):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in shapes]


def _resized(img):
    """The eval resize of `img` (shortest edge HW, longest at most HW) and its
    scale_xy, as the eval mapper computes them."""
    h, w = img.shape[:2]
    out = T.build_test_augmentation(_cfg(), w, h).apply_image(img)
    return out, np.asarray([w / out.shape[1], h / out.shape[0]], np.float32)


def _cfg():
    cfg = get_cfg()
    cfg.merge_from_list(["INPUT.MIN_SIZE_TEST", str(HW), "INPUT.MAX_SIZE_TEST", str(HW)])
    return cfg


def test_canvas_places_requests_top_left(predictor):
    assert predictor.canvas_hw == (HW, HW)
    reqs = _requests(0, [(100, 60), (HW, HW)])
    canvas, scale = predictor.canvas(reqs[:1])
    assert canvas.dtype == torch.uint8 and canvas.device.type == "cpu"
    assert tuple(canvas.shape) == (2, HW, HW, 3) and tuple(scale.shape) == (2, 2)
    want, want_scale = _resized(reqs[0])
    assert want.shape == (HW, 77, 3)  # 100 x 60 resized to fit 128
    np.testing.assert_array_equal(canvas[0, :, :77].numpy(), want)
    assert int(canvas[0, :, 77:].sum()) == 0
    np.testing.assert_array_equal(scale[0].numpy(), want_scale)
    assert int(canvas[1].sum()) == 0 and scale[1].tolist() == [1.0, 1.0]  # the unused slot
    canvas, scale = predictor.canvas(reqs)
    np.testing.assert_array_equal(canvas[1].numpy(), reqs[1])  # unit scale: as sent
    assert scale[1].tolist() == [1.0, 1.0]


def test_detect_equals_eval_step_on_the_float_canvas(predictor):
    """Three requests at batch 2: two batches, the second one short.  Each
    image's detections are the eval step's valid slots on a float32 canvas
    of the resized images, rescaled by scale_xy, highest score first."""
    reqs = _requests(1, [(HW, HW), (90, 120), (64, 32)])
    dets = predictor.detect(reqs)
    assert len(dets) == 3
    step = predictor.step
    for start in (0, 2):
        chunk = reqs[start : start + 2]
        canvas = np.zeros((2, HW, HW, 3), np.float32)
        scale = np.ones((2, 2), np.float32)
        for i, img in enumerate(chunk):
            resized, scale[i] = _resized(img)
            canvas[i, : resized.shape[0], : resized.shape[1]] = resized
        want = {k: v.numpy() for k, v in step(torch.from_numpy(canvas),
                                               torch.from_numpy(scale)).items()}
        for b in range(len(chunk)):
            got = dets[start + b]
            idx = np.nonzero(want["valid"][b])[0]
            assert len(got) == len(idx) > 0
            order = idx[np.argsort(-want["scores"][b, idx], kind="stable")]
            np.testing.assert_array_equal([d["class"] for d in got], want["classes"][b, order])
            np.testing.assert_array_equal([d["score"] for d in got], want["scores"][b, order])
            np.testing.assert_array_equal([d["corners"] for d in got], want["corners"][b, order])
            np.testing.assert_array_equal([d["hbox"] for d in got], want["hboxes"][b, order])


@pytest.mark.parametrize("kind", ["taller", "wider", "float"])
def test_detect_resizes_and_converts_requests(predictor, kind):
    """A request larger than the canvas is resized to fit it; float pixels
    are clipped to uint8 before the resize."""
    rng = np.random.RandomState(3)
    image = {
        "taller": rng.randint(0, 256, (HW + 40, 50, 3)).astype(np.uint8),
        "wider": rng.randint(0, 256, (30, 3 * HW, 3)).astype(np.uint8),
        "float": rng.uniform(-20, 280, (70, 90, 3)).astype(np.float32),
    }[kind]
    canvas, scale = predictor.canvas([image])
    want, want_scale = _resized(np.clip(image, 0, 255).astype(np.uint8))
    assert max(want.shape[:2]) <= HW
    np.testing.assert_array_equal(canvas[0, : want.shape[0], : want.shape[1]].numpy(), want)
    np.testing.assert_array_equal(scale[0].numpy(), want_scale)
    assert len(predictor.detect([image])) == 1


@pytest.mark.parametrize("bad", ["rgba", "gray", "empty", "zero-width", "batched"])
def test_detect_refuses_bad_requests_before_any_batch(predictor, bad):
    image = {
        "rgba": np.zeros((10, 10, 4), np.uint8),
        "gray": np.zeros((10, 10), np.uint8),
        "empty": np.zeros((0, 10, 3), np.uint8),
        "zero-width": np.zeros((10, 0, 3), np.uint8),
        "batched": np.zeros((1, 10, 10, 3), np.uint8),
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
