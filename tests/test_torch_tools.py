"""The port's measurement tools (``dafne_torch/tools/analyze_model.py``,
``benchmark.py``, ``train_step_profile.py``, ``ablate_train_step.py``)
and the two decode diagnostics they need, against the JAX package on the
CPU at narrow widths.

- ``DecodeSpec.skip_nms``: the port's ``decode_detections`` and JAX's on
  the same seeded head outputs, both with skip_nms: equal detections, and
  nothing suppressed (keep = valid: every valid candidate up to the
  post-NMS top-k comes out).  ``make_eval_step(decode_overrides=)``
  reaches the program's spec.
- ``analyze_model``'s parameter total equals JAX's ``param_table`` total
  (``tools/analyze_model.py``) on the same tree, for the narrow R-50 and
  VoVNet, and so do the per-group totals.
- Its FLOP count (FlopCounterMode) equals the sum over the model's convs
  and linears (2 per multiply-add) exactly.  JAX's figure is XLA's cost
  analysis of the compiled forward, which counts a conv's taps on the
  input only (not those on its padding), also counts elementwise work
  (the pixel normalization, FrozenBN, GroupNorm, ReLU, the head's scales)
  and runs JAX's space-to-depth stem (a 4x4 conv over 12 channels where
  the port runs the 7x7 over 3): both ratios are printed, and XLA's
  figure over the port's taps inside the input lies in [1, XLA_RATIO_MAX].
- Each tool's ``--cpu`` run at a narrow width prints the JAX tool's
  fields, device "cpu", and mfu "not measured"; the profiler runs
  model_fwd, assign_only, decode_only and roofline only.
- Each refused phase and variant raises, naming its key.
"""

import dataclasses
import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafne_tpu.models import build_model as jax_build_model
from dafne_tpu.models.head import compute_locations as jax_compute_locations
from dafne_tpu.ops.postprocess import DecodeSpec as JaxDecodeSpec
from dafne_tpu.ops.postprocess import decode_detections as jax_decode

from dafne_torch.engine.inference import make_eval_step
from dafne_torch.models import build_model
from dafne_torch.ops.postprocess import DecodeSpec, decode_detections, nms_candidates
from dafne_torch.tools import ablate_train_step, analyze_model, benchmark
from dafne_torch.tools import train_step_profile as TSP

from tests.test_torch_decode import STRIDES, _head_outputs
from tests.test_torch_model import NARROW, narrow_cfgs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 64
#: JAX's XLA FLOPs over the port's conv and matrix-product FLOPs counted on
#: the taps inside the input only: XLA's cost analysis leaves out the taps
#: on padding (at 64^2 the FPN's top levels are 1-2 pixels wide, so over
#: all taps the ratio is 0.90 for R-50 and 0.88 for VoVNet) and adds the
#: elementwise work and JAX's space-to-depth stem; measured 1.07 (R-50,
#: lowered; 1.08 compiled) and 1.003 (VoVNet, compiled) at 64^2
XLA_RATIO_MAX = 1.2
TOOL_OPTS = [str(v) for v in NARROW] + ["TPU.NMS_MAX_CANDIDATES", "256"]
FAMILIES = {"R-50": (), "VoVNet": ("MODEL.BACKBONE.NAME", "build_vovnet_fpn_backbone")}


def test_skip_nms_equals_jaxs():
    """keep = valid on the same head outputs as JAX's decode with skip_nms."""
    jcfg, tcfg = narrow_cfgs(["TPU.NMS_MAX_CANDIDATES", "256",
                              "MODEL.DAFNE.POST_NMS_TOPK_TEST", "200"])
    head = _head_outputs(HW, 1, 15, seed=7)
    locs = [jax_compute_locations(-(-HW // s), -(-HW // s), s) for s in STRIDES]
    jspec = JaxDecodeSpec.from_config(jcfg)
    assert not jspec.skip_nms and not DecodeSpec.from_config(tcfg).skip_nms
    jspec = dataclasses.replace(jspec, skip_nms=True)
    want = jax.jit(lambda h: jax_decode(h, locs, jspec))(jax.tree_util.tree_map(jnp.asarray, head))
    theirs = {k: [torch.from_numpy(a) for a in v] for k, v in head.items()}
    spec = dataclasses.replace(DecodeSpec.from_config(tcfg), skip_nms=True)
    got = {k: v.numpy() for k, v in decode_detections(theirs, spec).items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    n_valid = int(nms_candidates(theirs, spec)["valid"].sum())
    assert got["valid"].sum() == min(n_valid, 200) > 100  # nothing suppressed: keep = valid
    kept = decode_detections(theirs, DecodeSpec.from_config(tcfg))["valid"].sum()
    assert kept < got["valid"].sum()  # with NMS some are
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-6)
    for key in ("corners", "hboxes", "locations"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4, err_msg=key)


def test_decode_overrides_reach_the_spec():
    _, tcfg = narrow_cfgs()
    model = build_model(tcfg, device="cpu")
    plain = make_eval_step(model, tcfg, (HW, HW)).program.spec
    assert plain == DecodeSpec.from_config(tcfg)
    step = make_eval_step(model, tcfg, (HW, HW), decode_overrides={"skip_nms": True,
                                                                   "post_nms_topk": 50})
    assert step.program.spec.skip_nms and step.program.spec.post_nms_topk == 50
    assert step.program.spec.nms_threshold == plain.nms_threshold
    out = step(torch.zeros((1, HW, HW, 3)))
    assert out["scores"].shape == (1, 50)


def _jax_param_table():
    spec = importlib.util.spec_from_file_location(
        "jax_analyze_model", os.path.join(ROOT, "tools", "analyze_model.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.param_table


def _valid_taps(n_out, k, stride, pad, dilation, n_in) -> int:
    """Taps of a conv along one axis that fall inside the input, over its outputs."""
    i = np.arange(n_out)[:, None] * stride - pad + np.arange(k)[None, :] * dilation
    return int(((i >= 0) & (i < n_in)).sum())


def _conv_linear_flops(model, images, inside_only=False):
    """2 x multiply-adds of every Conv2d call of the forward (its output's
    elements times its taps; with `inside_only` only the taps that fall
    inside the input, as XLA's cost analysis counts them) and of every
    Linear, which VoVNet's eSE applies once per image through F.linear
    (in x out each)."""
    total = []

    def hook(mod, args, out):
        kh, kw = mod.kernel_size
        if inside_only:
            vh, vw = (_valid_taps(out.shape[a], k, mod.stride[a - 2], mod.padding[a - 2],
                                  mod.dilation[a - 2], args[0].shape[a])
                      for a, k in ((2, kh), (3, kw)))
            total.append(2 * out.shape[0] * out.shape[1] * mod.in_channels // mod.groups * vh * vw)
        else:
            total.append(2 * out.numel() * mod.in_channels // mod.groups * kh * kw)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.inference_mode():
        model(images)
    for h in hooks:
        h.remove()
    return sum(total) + sum(2 * images.shape[0] * m.in_features * m.out_features
                            for m in model.modules() if isinstance(m, torch.nn.Linear))


@functools.lru_cache(maxsize=None)
def _models(family):
    """(JAX model, its param shapes at HW^2, the port's model with seeded
    random weights) of the narrow config with `family`'s overrides."""
    jcfg, tcfg = narrow_cfgs(list(FAMILIES[family]))
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))
    return jmodel, shapes["params"], build_model(tcfg, device="cpu",
                                                 generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_parameters_and_flops(family):
    """The parameter total and groups against JAX's ``param_table`` on the
    same tree; the FLOPs against the sum over the convs and linears."""
    _, shapes, model = _models(family)
    rows = _jax_param_table()(shapes)
    report = analyze_model.parameter_report(model)
    assert report["total"] == sum(r[2] for r in rows)
    groups = {}
    for name, _, n in rows:
        groups[name.split(".")[0]] = groups.get(name.split(".")[0], 0) + n
    assert report["groups"] == groups
    assert report["torch_parameters"] == sum(p.numel() for p in model.parameters())
    assert report["total"] == report["torch_parameters"] + report["frozen_bn_buffers"]
    images = torch.from_numpy(np.random.RandomState(0).uniform(0, 255, (1, HW, HW, 3))
                              .astype(np.float32))
    work = analyze_model.forward_work(model, images)
    assert work["flops"] == _conv_linear_flops(model, images) > 0
    assert work["kernels"] == {}


def test_flops_against_xla():
    """JAX's XLA FLOPs (the cost analysis of the lowered forward; the JAX
    tool's compiled figure is ~1.5% higher, fusion) over the port's."""
    jmodel, shapes, model = _models("R-50")
    images = torch.from_numpy(np.random.RandomState(0).uniform(0, 255, (1, HW, HW, 3))
                              .astype(np.float32))
    flops = analyze_model.forward_work(model, images)["flops"]
    x = jax.ShapeDtypeStruct((1, HW, HW, 3), jnp.float32)
    xla = float(jax.jit(lambda p, x: jmodel.apply({"params": p}, x)).lower(shapes, x)
                .cost_analysis()["flops"])
    inside = _conv_linear_flops(model, images, inside_only=True)
    print(f"JAX's XLA flops / the port's conv+linear flops = {xla / flops:.3f}; "
          f"/ the taps inside the input = {xla / inside:.3f}")
    assert 1.0 <= xla / inside <= XLA_RATIO_MAX


def _json_line(text):
    return json.loads([line for line in text.splitlines() if line.startswith("{")][-1])


def test_analyze_model_cli_on_the_cpu(capsys):
    assert analyze_model.main(["--cpu", "--config-file", "", "--tasks", "parameter", "flop",
                               "structure", "--image-size", str(HW)] + TOOL_OPTS) == 0
    text = capsys.readouterr().out
    for line in ("=== Parameters:", "  backbone", "=== FlopCounterMode", "flops:",
                 "bytes accessed:", "=== Structure ===", "head.cls_tower"):
        assert line in text, line
    rec = _json_line(text)
    assert rec["device"] == "cpu" and rec["power_limit"] is None
    assert rec["flop"]["flops"] > 0 and rec["parameter"]["total"] > 0


@pytest.mark.parametrize("task", ["eval", "train", "data"])
def test_benchmark_cli_on_the_cpu(task, capsys):
    fields = {"eval": ("img_per_s", "latency_ms", "pad_hw"),
              "train": ("img_per_s", "step_ms", "bucketed", "device_aug", "canvases"),
              "data": ("img_per_s", "device_aug")}[task]
    assert benchmark.main(["--cpu", "--config-file", "", "--task", task, "--iters", "1",
                           "--warmup", "0", "--batch-size", "1"] + TOOL_OPTS + [
        "INPUT.MIN_SIZE_TRAIN", f"({HW},)", "INPUT.MAX_SIZE_TRAIN", str(HW),
        "INPUT.MAX_SIZE_TEST", str(HW), "DATASETS.TRAIN", "('synthetic_gen_train',)",
        "DEBUG.OVERFIT_NUM_IMAGES", "2"]) == 0
    rec = _json_line(capsys.readouterr().out)
    assert rec["task"] == task and rec["batch_size"] == 1 and rec["device"] == "cpu"
    for f in fields:
        assert f in rec, f
    if task != "data":
        assert rec["mfu"] == "not measured"


def test_profile_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "profile.json"
    phases = "model_fwd,assign_only,decode_only,roofline"
    assert TSP.main(["--cpu", "--phases", phases, "--out", str(out), "--iters", "1",
                     "--warmup", "0", "--batch", "2", "--hw", str(HW)] + TOOL_OPTS) == 0
    rec = json.loads(out.read_text())
    assert rec == _json_line(capsys.readouterr().out)
    assert "batch" not in rec  # a batch other than 8 suffixes every key, as JAX's does
    rec = {k[:-len("_b2")]: v for k, v in rec.items()}
    assert rec["device"] == "cpu" and rec["hw"] == HW
    for key in ("model_fwd_ms", "assign_only_ms", "decode_only_ms", "decode_only_host_ms"):
        assert rec[key] > 0, key
    assert set(rec["roofline"]) == {"model_fwd", "model_grad", "eval_full", "train_step"}
    for row in rec["roofline"].values():
        for f in ("flops_g", "bytes_gb", "flops_bound_ms", "bw_bound_ms", "bound_ms", "bound",
                  "measured_ms", "pct_of_bound"):
            assert f in row, f
    assert rec["roofline"]["train_step"]["kernel_ops_g"] > 0  # K3's candidate pairs
    assert all(row["mfu"] == "not measured" for row in rec["roofline"].values())
    assert set(rec["launches"]) == set(phases.split(","))
    TSP.write({"launches": {"tta_r101": {}}, "mfu": {"train_step": 0.1}}, str(out), 2)
    merged = json.loads(out.read_text())  # a later partial run adds its phases
    assert set(merged["launches_b2"]) == set(phases.split(",")) | {"tta_r101"}
    assert merged["mfu_b2"] == {"train_step": 0.1}


def test_ablation_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "profile.json"
    out.write_text(json.dumps({"model_fwd_ms": 1.0}))
    assert ablate_train_step.main(["--cpu", "--variants", "baseline,towers_0", "--out", str(out),
                                   "--iters", "1", "--warmup", "0", "--batch", "8",
                                   "--hw", str(HW)] + TOOL_OPTS) == 0
    rec = json.loads(out.read_text())
    assert rec["model_fwd_ms"] == 1.0  # merged, as JAX's profile merges
    assert set(rec["train_ablation_ms"]) == {"baseline", "towers_0"}
    assert rec["train_ablation_device"] == "cpu"
    assert _json_line(capsys.readouterr().out)["train_ablation_ms"] == rec["train_ablation_ms"]


@pytest.mark.parametrize("name", sorted(TSP.REFUSED))
def test_refused_phases_raise(name):
    with pytest.raises(SystemExit, match=f"phase {name} refused"):
        TSP.main(["--cpu", "--phases", f"model_fwd,{name}"])


@pytest.mark.parametrize("name", sorted(ablate_train_step.REFUSED))
def test_refused_variants_raise(name):
    with pytest.raises(SystemExit, match=f"variant {name} refused"):
        ablate_train_step.main(["--cpu", "--variants", f"baseline,{name}"])
