"""The port's HTTP server (``dafne_torch/tools/serve.py``) on the CPU.

Mirrors ``tests/test_serve.py``: the narrow model of
``configs/synthetic/base.yaml`` behind the standard library's server,
driven over HTTP.  /healthz is 503 with untrained weights and 200 with a
checkpoint under OUTPUT_DIR; PNG, JPEG and .npy bodies return the
detections ``Predictor.detect`` gives for the same decoded image;
undecodable bodies, images over the pixel cap and malformed arrays are
400, unknown paths 404.  ``preprocess`` equals the port's eval mapper and
the JAX server's ``DetectorService.preprocess``.  Artifact mode refuses a
missing or weights-as-args artifact.  ``python -m
dafne_torch.tools.serve`` starts, prints its JSON line and answers.
"""

import http.client
import io
import json
import os
import subprocess
import sys
import threading

import cv2
import numpy as np
import pytest
import torch

from dafne_tpu.config import get_cfg as jax_get_cfg
from dafne_tpu.data.mapper import eval_preprocess_meta

from dafne_torch.config import get_cfg
from dafne_torch.data.image_io import decode_image_bytes
from dafne_torch.data.mapper import DatasetMapper, pad_target_hw
from dafne_torch.data.synthetic import load_synthetic
from dafne_torch.engine.checkpoint import Checkpointer
from dafne_torch.engine.predictor import Predictor
from dafne_torch.models import build_model
from dafne_torch.tools import serve

from test_torch_model import NARROW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from serve import DetectorService as JaxDetectorService  # noqa: E402

torch.set_num_threads(2)

RECIPE = os.path.join(ROOT, "configs", "synthetic", "base.yaml")
SMALL = [str(v) for v in NARROW] + [
    "MODEL.DAFNE.PRE_NMS_TOPK_TEST", "64", "MODEL.DAFNE.POST_NMS_TOPK_TEST", "32",
    "TPU.NMS_MAX_CANDIDATES", "128", "TPU.NMS_GROUP_CANDIDATES", "32"]


def _cfg(out_dir, extra=()):
    cfg = get_cfg()
    cfg.merge_from_file(RECIPE)
    cfg.merge_from_list(SMALL + ["OUTPUT_DIR", str(out_dir)] + list(extra))
    return cfg


def _trained_checkpoint(cfg):
    """A checkpoint of the narrow model with the class bias at -2 (so that
    requests get detections) under cfg.OUTPUT_DIR; returns its model."""
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.head.cls_logits.bias.fill_(-2.0)
    Checkpointer(cfg.OUTPUT_DIR).save(7, model)
    return model


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/detect", body=body)
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("GET", path)
    r = conn.getresponse()
    return r.status, json.loads(r.read())


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cfg = _cfg(tmp_path_factory.mktemp("serve") / "out")
    model = _trained_checkpoint(cfg)
    service = serve.DetectorService.from_config(cfg, device="cpu")
    srv = serve.make_server(service, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield cfg, model, service, srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()


def test_http_round_trip_png_jpeg_npy_equal_predictor(served):
    cfg, model, service, port = served
    assert not service.untrained and service.meta["checkpoint_step"] == 7
    status, health = _get(port, "/healthz")
    assert status == 200 and health["ok"] and health["canvas"] == [256, 256]
    assert health["batch"] == 1 and health["checkpoint_step"] == 7
    assert set(health["launches"]) == {"suppression_matrix", "greedy_keep"}
    served_before = health["requests"]
    predictor = Predictor(model, cfg, batch=1)
    scene = load_synthetic("val", 2)[1]["image"]
    small = np.ascontiguousarray(scene[:150, :201])  # a resized request: scale_xy != 1
    bodies = {}
    for name, img in (("scene", scene), ("small", small)):
        ok_png, png = cv2.imencode(".png", img)
        ok_jpg, jpg = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        buf = io.BytesIO()
        np.save(buf, img)
        bodies.update({f"{name}.png": png.tobytes(), f"{name}.jpg": jpg.tobytes(),
                       f"{name}.npy": buf.getvalue()})
    n_dets = 0
    for name, body in bodies.items():
        status, out = _post(port, body)
        assert status == 200, (name, out)
        decoded = decode_image_body_reference(body)
        want = json.loads(json.dumps(predictor.detect([decoded])[0]))
        assert out["detections"] == want, name
        scores = [d["score"] for d in out["detections"]]
        assert scores == sorted(scores, reverse=True)
        n_dets += len(want)
    assert n_dets > 0
    assert _get(port, "/healthz")[1]["requests"] == served_before + len(bodies)
    # the lossless bodies decode to the same pixels, so they answer alike
    assert _post(port, bodies["small.png"])[1] == _post(port, bodies["small.npy"])[1]


def decode_image_body_reference(body):
    if body[:6] == b"\x93NUMPY":
        return np.load(io.BytesIO(body))
    img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(decode_image_bytes(body), img)
    return img


def test_client_errors_are_400_and_unknown_paths_404(served, monkeypatch):
    _, _, _, port = served
    for body in (b"not an image", b"\xff\xd8\xff\xe0 cut", b"\x93NUMPY garbage"):
        status, out = _post(port, body)
        assert status == 400 and "error" in out, body
    buf = io.BytesIO()
    np.save(buf, np.zeros((0, 10, 3), np.uint8))
    assert _post(port, buf.getvalue())[0] == 400  # zero-sized
    buf = io.BytesIO()
    np.save(buf, np.zeros((10, 10), np.uint8))
    assert _post(port, buf.getvalue())[0] == 400  # not H x W x 3
    ok, jpg = cv2.imencode(".jpg", np.zeros((40, 40, 3), np.uint8))
    monkeypatch.setenv("OPENCV_IO_MAX_IMAGE_PIXELS", "1000")
    status, out = _post(port, jpg.tobytes())
    assert status == 400 and "pixel" in out["error"]
    buf = io.BytesIO()
    np.save(buf, np.zeros((40, 40, 3), np.uint8))
    status, out = _post(port, buf.getvalue())
    assert status == 400 and "pixel" in out["error"]
    monkeypatch.delenv("OPENCV_IO_MAX_IMAGE_PIXELS")
    assert _get(port, "/nope")[0] == 404
    assert _post(port, jpg.tobytes())[0] == 200  # still serving


def test_untrained_weights_report_503(tmp_path):
    cfg = _cfg(tmp_path / "empty")
    service = serve.DetectorService.from_config(cfg, device="cpu")
    assert service.untrained
    srv = serve.make_server(service, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        status, health = _get(srv.server_address[1], "/healthz")
        assert status == 503 and health["ok"] is False and health["untrained_weights"] is True
        assert health["checkpoint_step"] == 0
    finally:
        srv.shutdown()
        srv.server_close()


def test_preprocess_equals_eval_mapper_and_jax_server(tmp_path):
    cfg = _cfg(tmp_path)
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(RECIPE)
    jcfg.merge_from_list(SMALL)
    pad = pad_target_hw(cfg, train=False)
    model = build_model(cfg, device="cpu")
    service = serve.DetectorService(Predictor(model, cfg, batch=1), {"checkpoint_step": 0})
    jservice = JaxDetectorService(None, 1, pad, eval_preprocess_meta(jcfg))
    mapper = DatasetMapper(cfg, pad, train=False)
    rng = np.random.RandomState(7)
    for hw in ((97, 123), (256, 77), (300, 300), (256, 256)):
        img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
        canvas, scale = service.preprocess(img)
        want = mapper({"image": img, "image_id": "x", "annotations": []})
        np.testing.assert_array_equal(canvas[0], want["image"])
        np.testing.assert_array_equal(scale[0], want["scale_xy"])
        jimages, jscale = jservice.preprocess(img)
        np.testing.assert_array_equal(canvas.astype(np.float32), jimages)
        np.testing.assert_array_equal(scale, jscale)
        fcanvas, _ = service.preprocess(img.astype(np.float32))  # float pixels: uint8 first
        np.testing.assert_array_equal(fcanvas, canvas)


def test_decode_image_body_and_artifact_mode(tmp_path):
    img = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    buf = io.BytesIO()
    np.save(buf, img)
    np.testing.assert_array_equal(serve.decode_image_body(buf.getvalue()), img)
    ok, png = cv2.imencode(".png", img)
    np.testing.assert_array_equal(serve.decode_image_body(png.tobytes(), "RGB"), img[:, :, ::-1])
    with pytest.raises(ValueError, match="undecodable"):
        serve.decode_image_body(b"\x89PNG\r\n\x1a\n broken")
    # artifact mode refuses a missing artifact and a weights-as-args one
    # (tests/test_torch_export.py serves a real one)
    with pytest.raises(SystemExit, match="no artifact"):
        serve.main(["--artifact", str(tmp_path / "model.pt2"), "--cpu"])
    (tmp_path / "model.pt2").write_bytes(b"")
    (tmp_path / "export_meta.json").write_text(json.dumps({"weights_as_args": True}))
    with pytest.raises(SystemExit, match="weights-as-args"):
        serve.main(["--artifact", str(tmp_path / "model.pt2"), "--cpu"])


def test_module_serves_over_http(tmp_path):
    cfg = _cfg(tmp_path / "out")
    _trained_checkpoint(cfg)
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dafne_torch.tools.serve", "--cpu", "--port", "0",
         "--config-file", RECIPE] + SMALL + ["OUTPUT_DIR", cfg.OUTPUT_DIR],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = json.loads(proc.stdout.readline())
        assert line["canvas"] == [256, 256] and line["batch"] == 1
        port = int(line["serving"].rsplit(":", 1)[1])
        assert _get(port, "/healthz")[0] == 200
        ok, jpg = cv2.imencode(".jpg", load_synthetic("test", 1)[0]["image"])
        status, out = _post(port, jpg.tobytes())
        assert status == 200 and isinstance(out["detections"], list)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
