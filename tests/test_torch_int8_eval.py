"""int8 eval (``TPU.EVAL_INT8``) through the port's eval step and its entry
points, against the JAX package on the CPU.

The model is the 64-wide tiny R-18 of ``tests/test_quant.py:300-311``
(float32 compute, min 64 so the trunk, FPN and towers quantize) with JAX's
parameters carried across by ``params_from_flax``.

Tolerance.  Each function is bit-equal to JAX's (``test_torch_quant.py``),
but the two forwards' float32 layers drift apart by ~1e-7 relative, and a
drifted value that lies at a rounding boundary flips its int8 value by 1.
Measured here (``test_dynamic_flips_cascade``): dynamic scales flip 1 of
131 072 values at the second site (res2_0/conv2: its per-image max|x|
drifts by an ulp, so its scale does), that one flip moves the conv's
output by ~1e-3 of its max, and the sites after it flip 17, 75, 244, ...
values: the two dynamic runs end as far apart as int8 is from float32
(scores ~1e-2).  A calibrated static scale does not drift: the static run
flips no value at any site and ends within the float32 drift of JAX's
jitted eval step (scores 1e-6, corners 1e-4 + 1e-6 relative, the export
test's decode tolerance), >= 99% of detections matched (same class, score
within 1e-4, corners within 1e-2) both ways.  For both modes the eval step
is also run on JAX's own input at every int8 site (its inputs recorded
from JAX's eval step, the same calls in the same order): every site's
output is then bit-equal to JAX's and the detections match under that
rule.  With int8 off the eval program is the model itself: the parent
commit's eval body, bit for bit.

Entry points: TTA under int8 (``tests/test_quant.py:413-446``), the int8
program exported on the CPU through the ops' fakes (dynamic, static and
weights-as-args) replaying live mode's outputs bit for bit, served from
the artifact (in a process that cannot import the model code) as live
mode serves, and ``tools/calibrate_int8.py`` writing
a JSON the eval step loads.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dafne_tpu.config import get_cfg as jax_get_cfg
from dafne_tpu.engine.trainer import make_eval_step as jax_make_eval_step
from dafne_tpu.layers import quant as JQ
from dafne_tpu.models import build_model as jax_build_model

from dafne_torch.config import get_cfg
from dafne_torch.engine import tta
from dafne_torch.engine.checkpoint import Checkpointer
from dafne_torch.engine.inference import EvalProgram, eval_program, make_eval_step
from dafne_torch.layers import quant as Q
from dafne_torch.models import build_model
from dafne_torch.ops.postprocess import DecodeSpec, decode_detections
from dafne_torch.tools import calibrate_int8, serve
from dafne_torch.tools import export_model as E
from dafne_torch.utils.weights import params_from_flax

from chip_smoke import match_rate
from torch_backbone_cases import draw_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "synthetic", "base.yaml")
HW = 128
TINY64 = ["MODEL.RESNETS.DEPTH", "18", "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
          "MODEL.RESNETS.STEM_OUT_CHANNELS", "64", "MODEL.FPN.OUT_CHANNELS", "64",
          "MODEL.DAFNE.NUM_CLASSES", "3", "MODEL.DAFNE.NUM_CLS_CONVS", "1",
          "MODEL.DAFNE.NUM_BOX_CONVS", "1", "TPU.COMPUTE_DTYPE", "float32",
          "TPU.NMS_MAX_CANDIDATES", "256", "MODEL.DAFNE.PRE_NMS_TOPK_TEST", "128",
          "MODEL.DAFNE.POST_NMS_TOPK_TEST", "64", "INPUT.MIN_SIZE_TEST", str(HW),
          "INPUT.MAX_SIZE_TEST", str(HW)]
INT8 = ["TPU.EVAL_INT8", "True", "TPU.EVAL_INT8_MIN_CHANNELS", "64"]
ATOL = {"scores": 1e-6, "centerness": 1e-6}  # the export test's decode tolerance; 1e-4 else
RTOL = {"corners": 1e-6, "hboxes": 1e-6}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's model and parameters, the port's model, two images and JAX's
    calibration table of them (saved as JSON)."""
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_list(TINY64 + INT8)
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))
    params = draw_params(dict(shapes["params"]), seed=3)
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(params), strict=True)
    images = np.random.RandomState(5).randint(0, 256, (2, HW, HW, 3)).astype(np.float32)
    table = JQ.calibrate_act_scales(jmodel, {"params": params}, [jnp.asarray(images)],
                                    min_channels=64)
    path = str(tmp_path_factory.mktemp("int8") / "scales.json")
    JQ.save_act_scales(path, table)
    return {"jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel, "params": params,
            "model": model.eval(), "images": images, "scales": path}


def _cfgs(setup, mode):
    jcfg, tcfg = copy.deepcopy(setup["jcfg"]), copy.deepcopy(setup["tcfg"])
    if mode == "static":
        jcfg.TPU.EVAL_INT8_SCALES = tcfg.TPU.EVAL_INT8_SCALES = setup["scales"]
    return jcfg, tcfg


def _preds(det):
    """match_rate's {image: {classes, scores, corners}} of an eval step's
    valid detections."""
    det = {k: np.asarray(v) for k, v in det.items()}
    return {str(b): {k: det[k][b][det["valid"][b]] for k in ("classes", "scores", "corners")}
            for b in range(det["valid"].shape[0])}


def _assert_detections_match(got, want):
    for a, b in ((got, want), (want, got)):
        matched, total = match_rate(_preds(a), _preds(b))
        assert total >= 50 and matched >= 0.99 * total, (matched, total)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(want[k], np.float64),
                                   rtol=RTOL.get(k, 0), atol=ATOL.get(k, 1e-4), err_msg=k)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Per mode, JAX's eager eval step (eager: under jit XLA divides by a
    constant through its reciprocal) with every int8 call recorded:
    {"want": detections, "calls": {site: [(input NHWC, output) per call]}}."""
    runs = {}
    real = JQ._quantized_call
    with pytest.MonkeyPatch.context() as mp:
        for mode in ("dynamic", "static"):
            calls = {}

            def recording(next_fun, args, kwargs, mod, x, act_amax=None, calls=calls):
                out = real(next_fun, args, kwargs, mod, x, act_amax)
                calls.setdefault(JQ.module_site(mod), []).append((np.asarray(x), np.asarray(out)))
                return out

            mp.setattr(JQ, "_quantized_call", recording)
            jcfg, _ = _cfgs(setup, mode)
            want = jax_make_eval_step(setup["jmodel"], jcfg, (HW, HW))(
                setup["params"], jnp.asarray(setup["images"]))
            runs[mode] = {"want": want, "calls": calls}
    return runs


def _site_modules(step):
    return {Q.module_site(n): m for n, m in step.program.model.named_modules()
            if isinstance(m, Q.Int8Conv2d)}


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_eval_step_on_jaxs_site_inputs_equals_jax(setup, jax_runs, mode):
    _, tcfg = _cfgs(setup, mode)
    calls, want = jax_runs[mode]["calls"], jax_runs[mode]["want"]
    step = make_eval_step(setup["model"], tcfg, (HW, HW))
    sites = _site_modules(step)
    assert set(sites) == set(calls) and len(sites) >= 20
    assert {m.mode for m in sites.values()} == {mode}
    pending = {s: list(c) for s, c in calls.items()}
    differing = []

    def force(site):
        def pre(mod, args):
            return (torch.from_numpy(pending[site][0][0].transpose(0, 3, 1, 2).copy()),)

        def post(mod, args, out):
            if not np.array_equal(out.permute(0, 2, 3, 1).numpy(), pending[site].pop(0)[1]):
                differing.append(site)
        return pre, post

    handles = []
    for site, mod in sites.items():
        pre, post = force(site)
        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    try:
        got = step(torch.from_numpy(setup["images"]))
    finally:
        for h in handles:
            h.remove()
    assert not differing, differing
    assert not any(pending.values())  # every JAX call, in order, and no other
    _assert_detections_match({k: v.numpy() for k, v in got.items()}, want)


def _flips(setup, jax_runs, mode):
    """([(site, flipped values, values)] of the first call of each site: the
    port's and JAX's own inputs there, each quantized by JAX's function;
    the port's detections; the two configs)."""
    jcfg, tcfg = _cfgs(setup, mode)
    step = make_eval_step(setup["model"], tcfg, (HW, HW))
    seen = {}

    def first_input(site):
        def pre(mod, args):
            seen.setdefault(site, args[0].permute(0, 2, 3, 1).numpy())
        return pre

    handles = [m.register_forward_pre_hook(first_input(site))
               for site, m in _site_modules(step).items()]
    try:
        got = step(torch.from_numpy(setup["images"]))
    finally:
        for h in handles:
            h.remove()
    scales = step.program.int8["scales"]
    out = []
    for site, site_calls in jax_runs[mode]["calls"].items():
        if mode == "static":
            def q(x):
                return JQ.quantize_tensor_static(jnp.asarray(x), scales[site])[0]
        else:
            def q(x):
                return JQ.quantize_tensor_dynamic(jnp.asarray(x))[0]
        mine, theirs = np.asarray(q(seen[site])), np.asarray(q(site_calls[0][0]))
        out.append((site, int((mine != theirs).sum()), mine.size))
    return out, got, jcfg, tcfg


def test_static_eval_step_equals_jax(setup, jax_runs):
    flips, _, jcfg, tcfg = _flips(setup, jax_runs, "static")
    assert len(flips) >= 20 and sum(f for _, f, _ in flips) == 0, flips
    want = jax.jit(jax_make_eval_step(setup["jmodel"], jcfg, (HW, HW)))(
        setup["params"], jnp.asarray(setup["images"]))
    got = make_eval_step(setup["model"], tcfg, (HW, HW))(torch.from_numpy(setup["images"]))
    _assert_detections_match({k: v.numpy() for k, v in got.items()}, want)


def test_dynamic_flips_cascade(setup, jax_runs):
    """The measurement behind the tolerance: the first flips are a few in
    1e5 values, the later sites flip more (the cascade), and the port's
    int8 detections end within int8's own distance from float32."""
    flips, got, jcfg, tcfg = _flips(setup, jax_runs, "dynamic")
    first = next(i for i, (_, f, _) in enumerate(flips) if f)
    site, n, size = flips[first]
    assert first >= 1 and n <= 1e-4 * size, flips[:first + 1]
    assert sum(f for _, f, _ in flips) > n  # the cascade after the first flip
    want = jax.jit(jax_make_eval_step(setup["jmodel"], jcfg, (HW, HW)))(
        setup["params"], jnp.asarray(setup["images"]))
    fcfg = copy.deepcopy(jcfg)
    fcfg.TPU.EVAL_INT8 = False
    flt = jax.jit(jax_make_eval_step(setup["jmodel"], fcfg, (HW, HW)))(
        setup["params"], jnp.asarray(setup["images"]))
    int8_noise = np.abs(np.asarray(want["scores"]) - np.asarray(flt["scores"])).max()
    assert 0 < int8_noise < 0.05
    assert np.abs(got["scores"].numpy() - np.asarray(want["scores"])).max() <= 2 * int8_noise


def test_int8_off_is_the_model_itself(setup):
    tcfg = copy.deepcopy(setup["tcfg"])
    tcfg.TPU.EVAL_INT8 = False
    program = eval_program(setup["model"], tcfg)
    assert program.model is setup["model"] and program.int8["mode"] == "off"
    assert not any(isinstance(m, Q.Int8Conv2d) for m in program.modules())
    images = torch.from_numpy(setup["images"])
    got = make_eval_step(setup["model"], tcfg, (HW, HW))(images)
    with torch.inference_mode():  # the parent commit's eval body
        want = EvalProgram(setup["model"], DecodeSpec.from_config(tcfg))(images)
        direct = decode_detections(setup["model"](images), DecodeSpec.from_config(tcfg))
    for k in want:
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], direct[k]), k
    # an int8 program leaves the model's own modules as they were
    qprogram = eval_program(setup["model"], setup["tcfg"])
    assert qprogram.int8["sites"] >= 20
    assert not any(isinstance(m, Q.Int8Conv2d) for m in setup["model"].modules())
    assert qprogram.model.head.cls_logits.weight is setup["model"].head.cls_logits.weight


def test_tta_runs_under_int8(setup):
    tcfg = copy.deepcopy(setup["tcfg"])
    tcfg.merge_from_list(["TEST.AUG.MIN_SIZES", "(128,)", "TEST.AUG.MAX_SIZE", "128",
                          "TEST.AUG.HFLIP", "True"])
    steps = tta.BucketedEvalSteps(tcfg, setup["model"])
    img = (np.random.RandomState(1).rand(200, 160, 3) * 255).astype(np.uint8)
    stats = {}
    det = tta.tta_inference_single(tcfg, steps, img, stats)
    assert det["corners"].shape[1] == 8 and np.isfinite(det["scores"]).all()
    assert len(det["scores"]) > 0 and stats["copies"] >= 2
    assert any(isinstance(k, tuple) for k in steps._steps)  # the device-rendered path ran
    for key, (step, _) in steps._steps.items():
        fused = step.__closure__  # the fused step holds its eval step
        cores = [c.cell_contents for c in fused if hasattr(c.cell_contents, "program")]
        assert cores and all(c.program.int8["sites"] >= 20 for c in cores), key


def _export(out_dir, overrides, *flags):
    rc = E.main(["--config-file", RECIPE, "--cpu", "--output-dir", str(out_dir), *flags]
                + list(overrides))
    assert rc == 0
    with open(os.path.join(out_dir, "export_meta.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("mode", ["dynamic", "static", "weights-as-args"])
def test_export_replays_live_int8(setup, tmp_path, mode):
    overrides = TINY64 + INT8 + ["OUTPUT_DIR", str(tmp_path)] + (
        ["TPU.EVAL_INT8_SCALES", setup["scales"]] if mode == "static" else [])
    cfg = get_cfg()
    cfg.merge_from_file(RECIPE)
    cfg.merge_from_list(overrides)
    Checkpointer(cfg.OUTPUT_DIR).save(4, setup["model"])
    # batch 1 where the artifact serves: the live server runs at batch 1
    batch = 1 if mode == "static" else 2
    flags = ["--batch", str(batch)] + (["--weights-as-args"] if mode == "weights-as-args" else [])
    meta = _export(tmp_path / "export", overrides, *flags)
    int8 = meta["int8"]
    assert int8["mode"] == ("static" if mode == "static" else "dynamic")
    assert int8["min_channels"] == 64 and int8["sites"] >= 20
    assert meta["ops"]["quantize_act"] == meta["ops"]["int8_conv"] >= 28  # towers: 5 calls each
    if mode == "static":
        assert int8["scales"] == Q.load_act_scales(setup["scales"])  # the content, not the path
    assert E.main(["--check", str(tmp_path / "export" / "model.pt2")]) == 0  # replays or skips
    loaded = torch.export.load(str(tmp_path / "export" / "model.pt2"))
    images = torch.from_numpy(setup["images"][:batch].astype(np.uint8))
    scale = torch.tensor([[1.5, 0.75], [1.0, 1.0]])[:batch]
    live = make_eval_step(setup["model"], cfg, (HW, HW))(images, scale)
    with torch.no_grad():
        if mode == "weights-as-args":
            state = E.program_state(eval_program(setup["model"], cfg, quantize_weights=False))
            assert not any(k.endswith("weight_q") for k in state)  # quantized in the program
            replayed = loaded.module()(state, images, scale)
        else:
            replayed = loaded.module()(images, scale)
    for k in live:
        assert torch.equal(replayed[k], live[k]), k
    if mode == "static":  # artifact mode serves as live int8 mode, with no model code
        artifact = str(tmp_path / "export" / "model.pt2")
        code = ("import sys\n"
                "for m in ('dafne_torch.models', 'dafne_torch.config', 'jax', 'dafne_tpu'):\n"
                "    sys.modules[m] = None\n"
                "import torch\ntorch.set_num_threads(2)\n"
                "from dafne_torch.tools.serve import DetectorService\n"
                f"s = DetectorService.from_artifact({artifact!r}, 'cpu')\n"
                "print(s.meta['int8']['mode'], s.requests)\n")
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                             text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
        assert res.returncode == 0 and res.stdout.split() == ["static", "1"], res.stderr
        art = serve.DetectorService.from_artifact(artifact, "cpu")
        cfg1 = copy.deepcopy(cfg)
        live1 = serve.DetectorService.from_config(cfg1, device="cpu")
        assert live1.meta["int8"]["mode"] == art.meta["int8"]["mode"] == "static"
        img = np.random.RandomState(8).randint(0, 256, (100, 120, 3)).astype(np.uint8)
        assert art.detect(img) == live1.detect(img)


def test_calibrate_tool_writes_scales_the_step_loads(setup, tmp_path):
    overrides = TINY64 + ["OUTPUT_DIR", str(tmp_path), "DEBUG.OVERFIT_NUM_IMAGES", "2",
                          "TPU.EVAL_BATCH", "2"]
    cfg = get_cfg()
    cfg.merge_from_file(RECIPE)
    cfg.merge_from_list(overrides)
    Checkpointer(cfg.OUTPUT_DIR).save(6, setup["model"])
    out = calibrate_int8.main(["--config-file", RECIPE, "--num-batches", "1", "--cpu",
                               "--output", str(tmp_path / "s.json")] + overrides)
    scales = Q.load_act_scales(out)
    assert set(scales) == set(JQ.load_act_scales(setup["scales"]))  # JAX's sites at 64
    assert all(v > 0 for v in scales.values())
    cfg.merge_from_list(INT8 + ["TPU.EVAL_INT8_SCALES", out])
    step = make_eval_step(setup["model"], cfg, (HW, HW))
    assert step.program.int8["mode"] == "static"
    assert step.program.int8["static_sites"] == len(scales)
    det = step(torch.from_numpy(setup["images"]))
    assert bool(torch.isfinite(det["scores"]).all())
