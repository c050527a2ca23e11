"""The kernels as ``torch.ops.dafne`` ops, the export tool and artifact
serving, on the CPU.

Round trip: the narrow model of ``tests/test_export.py`` (R-18, res3-res5,
FPN 32, one conv per tower, 64 / 32 candidates, float32, NMS cap 128, a
128^2 canvas, batch 2), with JAX's parameters carried across by
``params_from_flax`` (``torch_backbone_cases.draw_params``, class bias -2
so the NMS has candidates), goes through ``python -m
dafne_torch.tools.export_model --cpu``; the saved and reloaded program
equals the port's live eval step on every key (``torch.equal``) and JAX's
own ``jax.export`` round trip of its eval step within the decode
tolerances of ``tests/test_torch_decode.py`` (scores and centerness atol
1e-6, the other keys 1e-4; corners and hboxes rtol 1e-6 besides, see
RTOL), and its graph calls the ``dafne::`` kernels.
A narrow deformable model's program calls ``dafne::deform_im2col`` and
equals its live step too.  ``torch.library.opcheck`` holds every op's
schema, fake, autograd registration and traced dispatch on CPU inputs;
the deformable op's gradients equal the plain version's own autograd bit
for bit.  ``--check`` replays an artifact in a process that cannot import
the model code, and skips the replay of a weights-as-args artifact, which
serving refuses; ``python -m dafne_torch.tools.serve --artifact --cpu``
with ``dafne_torch.models`` blocked answers PNG, JPEG and .npy requests
with live mode's detection lists.
"""

import http.client
import io
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import export as jexport

from dafne_tpu.config import get_cfg as jax_get_cfg
from dafne_tpu.engine.trainer import make_eval_step as jax_make_eval_step
from dafne_tpu.models import build_model as jax_build_model

from dafne_torch.config import get_cfg
from dafne_torch.data.synthetic import load_synthetic
from dafne_torch.engine.checkpoint import Checkpointer
from dafne_torch.engine.inference import eval_program, make_eval_step
from dafne_torch.layers import deform_conv as TD
from dafne_torch.models import build_model
from dafne_torch.ops.kernels import quad_nms as Q
from dafne_torch.tools import export_model as E
from dafne_torch.tools import serve
from dafne_torch.utils.weights import params_from_flax

from test_torch_model import NARROW
from torch_backbone_cases import draw_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "synthetic", "base.yaml")
HW = 128
#: tests/test_export.py's narrow model, on a 128^2 canvas
EXPORT_NARROW = [
    "MODEL.RESNETS.DEPTH", "18", "MODEL.RESNETS.OUT_FEATURES", "['res3', 'res4', 'res5']",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "64", "MODEL.FPN.OUT_CHANNELS", "32",
    "MODEL.DAFNE.NUM_CLS_CONVS", "1", "MODEL.DAFNE.NUM_BOX_CONVS", "1",
    "MODEL.DAFNE.PRE_NMS_TOPK_TEST", "64", "MODEL.DAFNE.POST_NMS_TOPK_TEST", "32",
    "TPU.COMPUTE_DTYPE", "float32", "TPU.NMS_MAX_CANDIDATES", "128",
    "INPUT.MIN_SIZE_TEST", str(HW), "INPUT.MAX_SIZE_TEST", str(HW)]
#: the narrow deformable model: the interval trunk and deformable towers
DEFORM_NARROW = [str(v) for v in NARROW] + [
    "MODEL.BACKBONE.NAME", "build_resnet_interval_backbone", "MODEL.RESNETS.DEFORM_INTERVAL", "2",
    "MODEL.RESNETS.STRIDE_IN_1X1", "False", "MODEL.DAFNE.USE_DEFORMABLE", "True",
    "MODEL.DAFNE.NUM_CLASSES", "3", "MODEL.DAFNE.PRE_NMS_TOPK_TEST", "64",
    "MODEL.DAFNE.POST_NMS_TOPK_TEST", "32", "TPU.NMS_MAX_CANDIDATES", "128",
    "INPUT.MIN_SIZE_TEST", str(HW), "INPUT.MAX_SIZE_TEST", str(HW)]
ATOL = {"scores": 1e-6, "centerness": 1e-6}  # test_torch_decode.py's; 1e-4 for the rest
#: and a relative term for the pixel coordinates: end to end, the forward's
#: float32 drift from JAX's (~1e-6 relative, test_torch_model.py) reaches
#: corners of up to ~250 px (1.07e-4 off at 247 px in this case)
RTOL = {"corners": 1e-6, "hboxes": 1e-6}


def _images(batch, seed):
    return np.random.RandomState(seed).randint(0, 256, (batch, HW, HW, 3)).astype(np.uint8)


def _cfgs(tmp_path, overrides):
    """(JAX cfg, port cfg) of the synthetic recipe with `overrides`; the
    port's OUTPUT_DIR is tmp_path."""
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_file(RECIPE)
        cfg.merge_from_list(list(overrides))
    tcfg.OUTPUT_DIR = str(tmp_path)
    return jcfg, tcfg


def _checkpointed(jcfg, tcfg, seed):
    """(flax model, params, port model): JAX's drawn parameters in the port's
    model, saved as the newest checkpoint under the port's OUTPUT_DIR."""
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))
    params = draw_params(dict(shapes["params"]), seed=seed)
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(params), strict=True)
    Checkpointer(tcfg.OUTPUT_DIR).save(5, model.eval())
    return jmodel, params, model


def _export(out_dir, overrides, *flags):
    """Run the export CLI on the CPU; returns the artifact's metadata."""
    rc = E.main(["--config-file", RECIPE, "--cpu", "--output-dir", str(out_dir), *flags]
                + list(overrides))
    assert rc == 0
    with open(os.path.join(out_dir, "export_meta.json")) as f:
        return json.load(f)


def test_round_trip_equals_live_and_jax(tmp_path):
    overrides = EXPORT_NARROW + ["OUTPUT_DIR", str(tmp_path)]
    jcfg, tcfg = _cfgs(tmp_path, EXPORT_NARROW)
    jmodel, params, model = _checkpointed(jcfg, tcfg, seed=11)
    meta = _export(tmp_path / "export", overrides, "--batch", "2")
    assert meta["pad_hw"] == [HW, HW] and meta["batch"] == 2 and meta["checkpoint_step"] == 5
    assert meta["device"] == "cpu" and not meta["weights_as_args"]
    assert meta["ops"] == {"suppression_bits": 1, "greedy_keep_bits": 1}
    loaded = torch.export.load(str(tmp_path / "export" / "model.pt2"))
    assert E.dafne_calls(loaded) == meta["ops"]  # K1 and greedy are call nodes, not inlined

    images = _images(2, 3)
    scale = torch.tensor([[1.0, 1.0], [1.5, 0.75]])
    live = make_eval_step(model, tcfg, (HW, HW))(torch.from_numpy(images), scale)
    with torch.no_grad():
        replayed = loaded.module()(torch.from_numpy(images), scale)
    assert set(replayed) == set(live) == set(meta["output_keys"])
    for k in live:
        assert torch.equal(replayed[k], live[k]), k
    assert int(live["valid"].sum()) > 10

    eval_step = jax_make_eval_step(jmodel, jcfg, (HW, HW))
    fn = jax.jit(lambda im, s: eval_step(params, im, s))
    spec = (jax.ShapeDtypeStruct((2, HW, HW, 3), jnp.float32),
            jax.ShapeDtypeStruct((2, 2), jnp.float32))
    blob = jexport.export(fn)(*spec).serialize()
    want = jexport.deserialize(bytearray(blob)).call(jnp.asarray(images, jnp.float32),
                                                     jnp.asarray(scale.numpy()))
    for k in live:
        np.testing.assert_allclose(replayed[k].numpy().astype(np.float64),
                                   np.asarray(want[k]).astype(np.float64),
                                   rtol=RTOL.get(k, 0), atol=ATOL.get(k, 1e-4), err_msg=k)


def test_deformable_round_trip_calls_the_sampler_op(tmp_path):
    jcfg, tcfg = _cfgs(tmp_path, DEFORM_NARROW)
    _, _, model = _checkpointed(jcfg, tcfg, seed=12)
    meta = _export(tmp_path / "export", DEFORM_NARROW + ["OUTPUT_DIR", str(tmp_path)],
                   "--batch", "1")
    assert meta["ops"]["deform_im2col"] > 0 and meta["ops"]["suppression_bits"] == 1
    loaded = torch.export.load(str(tmp_path / "export" / "model.pt2"))
    images = torch.from_numpy(_images(1, 4))
    scale = torch.ones(1, 2)
    live = make_eval_step(model, tcfg, (HW, HW))(images, scale)
    with torch.no_grad():
        replayed = loaded.module()(images, scale)
    for k in live:
        assert torch.equal(replayed[k], live[k]), k


def _nms_inputs(seed, n=128):
    rng = np.random.RandomState(seed)
    cx, cy = rng.uniform(0, 60, (2, 1, n))
    w, h = rng.uniform(4, 30, (2, 1, n))
    quads = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy - h / 2, cx + w / 2, cy + h / 2,
                      cx - w / 2, cy + h / 2], -1).astype(np.float32)
    classes = rng.randint(-1, 3, (1, n)).astype(np.int32)
    return torch.from_numpy(quads), torch.from_numpy(classes)


@pytest.mark.parametrize("op", ["suppression_bits", "suppression_bits_2d", "greedy_keep_bits",
                                "deform_im2col", "deform_im2col_backward"])
def test_opcheck(op):
    corners, classes = _nms_inputs(5)
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(2, 3, 5, 6).astype(np.float32))
    off = torch.from_numpy(rng.uniform(-2, 2, (2, 18, 5, 6)).astype(np.float32))
    mask = torch.from_numpy(rng.rand(2, 9, 5, 6).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 27, 5, 6).astype(np.float32))
    cases = {
        "suppression_bits": [(corners, classes, 0.1, 1e-6)],
        "suppression_bits_2d": [(corners, classes, 0.1, 1e-6)],
        "greedy_keep_bits": [(Q.suppression_bits(corners, classes, 0.1), classes >= 0)],
        "deform_im2col": [(x.requires_grad_(), off.requires_grad_(), None),
                          (x, off, mask.requires_grad_())],
        "deform_im2col_backward": [(x.detach(), off.detach(), None, g),
                                   (x.detach(), off.detach(), mask.detach(), g)],
    }
    for args in cases[op]:
        torch.library.opcheck(getattr(torch.ops.dafne, op).default, args)


@pytest.mark.parametrize("dtype,with_mask", [(torch.float32, False), (torch.float32, True),
                                             (torch.bfloat16, True)])
def test_deform_op_gradients_equal_plain_autograd(dtype, with_mask):
    rng = np.random.RandomState(7)
    leaves = [torch.from_numpy(rng.randn(2, 4, 6, 7).astype(np.float32)).to(dtype),
              torch.from_numpy(rng.uniform(-3, 3, (2, 18, 6, 7)).astype(np.float32)).to(dtype)]
    if with_mask:
        leaves.append(torch.from_numpy(rng.rand(2, 9, 6, 7).astype(np.float32)).to(dtype))
    g = torch.from_numpy(rng.randn(2, 36, 6, 7).astype(np.float32)).to(dtype)
    want_leaves = [t.clone().requires_grad_() for t in leaves]
    got_leaves = [t.clone().requires_grad_() for t in leaves]
    want_cols = TD.deform_im2col_plain(*want_leaves)
    got_cols = TD.deform_im2col(*got_leaves) if with_mask else TD.deform_im2col(*got_leaves, None)
    assert torch.equal(got_cols, want_cols)
    for got, want in zip(torch.autograd.grad(got_cols, got_leaves, g),
                         torch.autograd.grad(want_cols, want_leaves, g)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def _blocked_python(code):
    """A python -c command that blocks the model code, the config and the
    checkpoints before running `code`."""
    block = ("import sys\n"
             "for m in ('dafne_torch.models', 'dafne_torch.config', 'dafne_torch.engine.checkpoint',"
             " 'jax', 'dafne_tpu'):\n"
             "    sys.modules[m] = None\n")
    return [sys.executable, "-c", block + code]


def test_check_and_weights_as_args(tmp_path, capsys):
    overrides = EXPORT_NARROW + ["OUTPUT_DIR", str(tmp_path)]
    jcfg, tcfg = _cfgs(tmp_path, EXPORT_NARROW)
    _, _, model = _checkpointed(jcfg, tcfg, seed=13)
    # --check of a whole artifact, in a process that cannot import the model code
    _export(tmp_path / "whole", overrides, "--batch", "1")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    res = subprocess.run(_blocked_python(
        "from dafne_torch.tools.export_model import main\n"
        f"sys.exit(main(['--check', {str(tmp_path / 'whole' / 'model.pt2')!r}]))\n"),
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "replay OK" in res.stdout and '"corners": [1, 32, 8]' in res.stdout

    meta = _export(tmp_path / "wa", overrides, "--batch", "1", "--weights-as-args")
    path = str(tmp_path / "wa" / "model.pt2")
    assert meta["weights_as_args"]
    loaded = torch.export.load(path)
    assert not loaded.state_dict  # no weights saved
    capsys.readouterr()
    assert E.check(path) == 0
    assert "zero replay is skipped" in capsys.readouterr().out
    # the weights passed in give the live step's detections
    state = E.program_state(eval_program(model, tcfg))
    images = torch.from_numpy(_images(1, 5))
    scale = torch.ones(1, 2)
    with torch.no_grad():
        got = loaded.module()(state, images, scale)
    live = make_eval_step(model, tcfg, (HW, HW))(images, scale)
    for k in live:
        assert torch.equal(got[k], live[k]), k
    with pytest.raises(SystemExit, match="weights-as-args"):
        serve.main(["--artifact", path, "--cpu"])


SERVE_SMALL = [str(v) for v in NARROW] + [
    "MODEL.DAFNE.PRE_NMS_TOPK_TEST", "64", "MODEL.DAFNE.POST_NMS_TOPK_TEST", "32",
    "TPU.NMS_MAX_CANDIDATES", "128", "TPU.NMS_GROUP_CANDIDATES", "32"]


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_artifact_server_answers_as_live_mode(tmp_path):
    cfg = get_cfg()
    cfg.merge_from_file(RECIPE)
    cfg.merge_from_list(SERVE_SMALL + ["OUTPUT_DIR", str(tmp_path)])
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.head.cls_logits.bias.fill_(-2.0)
    Checkpointer(cfg.OUTPUT_DIR).save(7, model)
    _export(tmp_path / "export", SERVE_SMALL + ["OUTPUT_DIR", str(tmp_path)], "--batch", "1")
    artifact = str(tmp_path / "export" / "model.pt2")
    with pytest.raises(SystemExit, match="overrides"):
        serve.main(["--artifact", artifact, "--cpu", "SEED", "3"])
    live = serve.DetectorService.from_config(cfg, device="cpu")

    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(_blocked_python(
        "import torch\ntorch.set_num_threads(2)\n"
        "from dafne_torch.tools.serve import main\n"
        f"main(['--artifact', {artifact!r}, '--cpu', '--port', '0'])\n"),
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line, proc.stderr.read()
        port = int(json.loads(line)["serving"].rsplit(":", 1)[1])
        status, health = _request(port, "GET", "/healthz")
        assert status == 200 and health["checkpoint_step"] == 7 and health["canvas"] == [256, 256]
        scenes = [r["image"] for r in load_synthetic("val", 2)]
        images = {"scene": scenes[0], "small": np.ascontiguousarray(scenes[1][:150, :201])}
        n_dets = 0
        for name, img in images.items():
            buf = io.BytesIO()
            np.save(buf, img)
            bodies = {"png": cv2.imencode(".png", img)[1].tobytes(),
                      "jpg": cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes(),
                      "npy": buf.getvalue()}
            for kind, body in bodies.items():
                status, out = _request(port, "POST", "/detect", body)
                assert status == 200, (name, kind, out)
                want = live.detect(serve.decode_image_body(body))
                assert out["detections"] == json.loads(json.dumps(want)), (name, kind)
                n_dets += len(want)
        assert n_dets > 0
        health = _request(port, "GET", "/healthz")[1]
        assert health["requests"] == 7  # six requests and the warm-up
    finally:
        proc.terminate()
        proc.wait(timeout=30)
