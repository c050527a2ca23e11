"""Port's config copy vs the JAX package's, the port's import rule, and
the config keys the port refuses rather than ignores."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dafne_tpu.config import get_cfg as jax_get_cfg
from dafne_tpu.ops.postprocess import DecodeSpec as JaxDecodeSpec

import dafne_torch
from dafne_torch.config import get_cfg
from dafne_torch.engine.inference import make_eval_step
from dafne_torch.models import build_model
from dafne_torch.ops.postprocess import DecodeSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(node, prefix=""):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_every_port_default_equals_jax_default():
    jax_cfg = jax_get_cfg()
    leaves = dict(_leaves(get_cfg()))
    assert "TPU.NMS_MAX_CANDIDATES" in leaves and "TPU.COMPUTE_DTYPE" in leaves
    for key in ("SOLVER.BASE_LR", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "MODEL.BACKBONE.FREEZE_AT",
                "MODEL.DAFNE.POS_RADIUS", "MODEL.DAFNE.LOSS_LAMBDA.CLS", "INPUT.MIN_SIZE_TRAIN",
                "DATALOADER.REPEAT_THRESHOLD", "TPU.MAX_INSTANCES", "TPU.ASSIGN_IMPL",
                "DEBUG.NAN_CHECK", "SEED", "OUTPUT_DIR"):
        assert key in leaves, key
    for key, value in leaves.items():
        node = jax_cfg
        for part in key.split("."):
            node = node[part]
        assert node == value, key


RECIPES = sorted(os.path.relpath(os.path.join(d, f), os.path.join(ROOT, "configs"))
                 for d, _, fs in os.walk(os.path.join(ROOT, "configs")) for f in fs
                 if f.endswith(".yaml"))


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipes_merge_like_jax(recipe):
    path = os.path.join(ROOT, "configs", recipe)
    jax_cfg, cfg = jax_get_cfg(), get_cfg()
    jax_cfg.merge_from_file(path)
    cfg.merge_from_file(path)
    for key, value in _leaves(get_cfg()):
        a, b = cfg, jax_cfg
        for part in key.split("."):
            a, b = a[part], b[part]
        assert a == b, key


NARROW_BUILD = ["MODEL.RESNETS.STEM_OUT_CHANNELS", "8", "MODEL.RESNETS.WIDTH_PER_GROUP", "4",
                "MODEL.RESNETS.RES2_OUT_CHANNELS", "16", "MODEL.FPN.OUT_CHANNELS", "16",
                "TPU.COMPUTE_DTYPE", "float32"]


@pytest.mark.parametrize("recipe", RECIPES)
def test_every_recipe_builds_a_model(recipe):
    """Every config in configs/ builds the port's model (narrowed), its head
    options, depth and classes as the recipe sets them."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", recipe))
    cfg.merge_from_list(NARROW_BUILD)
    model = build_model(cfg, device="cpu")
    d = cfg.MODEL.DAFNE
    assert model.head.cls_logits.weight.shape[0] == d.NUM_CLASSES
    assert model.head.corner_prediction == d.CORNER_PREDICTION
    assert hasattr(model.head, "ctrness") == (d.CENTERNESS != "none")
    res4 = sum(n.startswith("res4_") for n, _ in model.backbone.named_children())
    assert res4 == {50: 6, 101: 23}[cfg.MODEL.RESNETS.DEPTH]


def test_port_imports_nothing_of_jax():
    """Every dafne_torch module (``dafne_torch.parallel.*`` with
    ``torch.distributed`` among them) and chip_smoke import with jax, flax,
    optax, dafne_tpu, cv2, PIL, yaml and tensorboard blocked."""
    modules = [m.name for m in pkgutil.walk_packages(dafne_torch.__path__, "dafne_torch.")]
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'dafne_tpu', 'cv2', 'PIL', 'yaml', 'tensorboard'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {modules + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'torch.distributed' in sys.modules\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(modules) >= 30
    for m in ("dafne_torch.ops.kernels.assign", "dafne_torch.engine.train_loop",
              "dafne_torch.data.loader", "dafne_torch.tools.train", "dafne_torch.engine.checkpoint",
              "dafne_torch.evaluation.evaluator", "dafne_torch.evaluation.voc_eval",
              "dafne_torch.data.registry", "dafne_torch.utils.polyiou",
              "dafne_torch.ops.device_warp", "dafne_torch.engine.tta",
              "dafne_torch.data.image_io", "dafne_torch.data.datasets.dota",
              "dafne_torch.data.datasets.hrsc2016", "dafne_torch.data.datasets.ucas_aod",
              "dafne_torch.data.datasets.icdar15", "dafne_torch.utils.weight_import",
              "dafne_torch.evaluation.result_merge", "dafne_torch.data.image_warp",
              "dafne_torch.parallel", "dafne_torch.parallel.distributed",
              "dafne_torch.parallel.mesh", "dafne_torch.layers.deform_conv",
              "dafne_torch.ops.kernels.deform_conv", "dafne_torch.models.backbones",
              "dafne_torch.ops.kernels.library", "dafne_torch.tools.export_model",
              "dafne_torch.utils.notify", "dafne_torch.layers.quant",
              "dafne_torch.ops.kernels.quant", "dafne_torch.tools.calibrate_int8",
              "dafne_torch.tools.int8_canary", "dafne_torch.tools.tta_canary",
              "dafne_torch.tools.gen_canary", "dafne_torch.tools.analyze_model",
              "dafne_torch.tools.benchmark", "dafne_torch.tools.train_step_profile",
              "dafne_torch.tools.ablate_train_step", "dafne_torch.utils.measure"):
        assert m in modules


def test_slice_keys_have_the_jax_defaults():
    leaves = dict(_leaves(get_cfg()))
    for key in ("TEST.AUG.MIN_SIZES", "TEST.AUG.MAX_SIZE", "TEST.AUG.FLIP", "TEST.AUG.HFLIP",
                "TEST.AUG.VFLIP", "TEST.AUG.ROTATION_ANGLES", "TPU.TTA_DEVICE_AUG",
                "TPU.TRAIN_DEVICE_AUG", "TPU.EVAL_INT8", "TPU.EVAL_INT8_SCALES",
                "TPU.EVAL_INT8_MIN_CHANNELS", "TPU.DECODE_APPROX_TOPK", "EXPERIMENT_NAME",
                "DEBUG.PROFILE_ITERS"):
        assert key in leaves, key  # equal to JAX's: test_every_port_default_equals_jax_default


def test_data_from_disk_keys_have_the_jax_defaults():
    leaves, jax_cfg = dict(_leaves(get_cfg())), jax_get_cfg()
    for key, value in (("INPUT.FORMAT", "BGR"), ("INPUT.MIN_AREA", 10), ("INPUT.MIN_SIDE", 2),
                       ("DATASETS.DOTA_REMOVE_CONTAINER_CRANE", False),
                       ("DATALOADER.CACHE_IMAGES", False)):
        section, name = key.split(".")
        assert leaves[key] == jax_cfg[section][name] == value, key


def test_eval_int8_raises():
    """TPU.EVAL_INT8 no longer raises: the int8 eval step builds and runs
    (tests/test_torch_int8_eval.py holds it against JAX).  What still
    raises is a missing EVAL_INT8_SCALES file, when the step is built."""
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.RESNETS.STEM_OUT_CHANNELS", "8", "MODEL.RESNETS.WIDTH_PER_GROUP",
                         "4", "MODEL.RESNETS.RES2_OUT_CHANNELS", "16", "MODEL.FPN.OUT_CHANNELS",
                         "64", "TPU.COMPUTE_DTYPE", "float32"])
    model = build_model(cfg, device="cpu")
    make_eval_step(model, cfg, (128, 128))  # bf16/f32 scoring builds
    cfg.TPU.EVAL_INT8 = True
    step = make_eval_step(model, cfg, (128, 128))
    assert step.program.int8["mode"] == "dynamic" and step.program.int8["min_channels"] == 256
    cfg.TPU.EVAL_INT8_MIN_CHANNELS = 64
    step = make_eval_step(model, cfg, (128, 128))
    assert step.program.int8["sites"] > 0
    images = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, 128, 128, 3)))
    out = step(images.float())
    assert set(out) >= {"corners", "scores", "valid"} and bool(torch.isfinite(out["scores"]).all())
    cfg.TPU.EVAL_INT8_SCALES = os.path.join(ROOT, "output", "no_such_scales.json")
    with pytest.raises(FileNotFoundError):
        make_eval_step(model, cfg, (128, 128))


def test_decode_approx_topk_raises_and_bare_spec_default():
    cfg = get_cfg()
    assert DecodeSpec.from_config(cfg).nms_max_candidates == cfg.TPU.NMS_MAX_CANDIDATES
    cfg.TPU.DECODE_APPROX_TOPK = True
    with pytest.raises(NotImplementedError, match="DECODE_APPROX_TOPK"):
        DecodeSpec.from_config(cfg)
    assert DecodeSpec().nms_max_candidates == JaxDecodeSpec().nms_max_candidates == 2048
