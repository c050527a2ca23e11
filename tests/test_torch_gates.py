"""The trained-weight gate tools of the port (``dafne_torch/tools/int8_canary.py``,
``tta_canary.py``, ``gen_canary.py``) against the JAX package's
``tools/int8_canary.py``, ``tta_canary.py`` and ``gen_canary.py`` on the CPU.

- The gates: each tool's ``checks`` on boundary cases, against JAX's own
  gate expression read out of the JAX tool's source and evaluated on the
  same mAPs (a drop of exactly 1.0 passes, bf16 of exactly 50 fails, TTA
  at exactly plain - 2.0 passes, val exactly 50, TTA at val - 0.5 and the
  train slice at val - 5 pass, no calibrated site fails).
- ``gen_canary._SCALES`` equals JAX's in every field but "out".
- The recipes: JAX's ``load_config`` of the recipe with the JAX tool's own
  ``cfg.<KEY> = ...`` lines run on it, in order, against each port tool's
  ``recipe``, on every key that either tool sets and every key of the YAML.
- A short run of each tool (2 steps, 2 scenes, the narrow R-50 of
  ``test_torch_model.NARROW``): the record at ``--out`` has JAX's fields
  (the keys of the JAX package's committed record) and the port's added
  ones; gen_canary's val scenes are disjoint from its train scenes and its
  static calibration read train images only; nothing is written at the
  repository's root and the JAX package's four records are unchanged.
- ``params_to_flax``: the narrow model's state, port -> flax -> port, bit
  for bit, in the tree JAX's ``init`` gives.
- ``canary.card_fields``: the power limit read from nvidia-smi's row of
  the device's own UUID.
"""

import ast
import copy
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafne_tpu.config import load_config
from dafne_tpu.models import build_model as jax_build_model

from dafne_torch.models import build_model
from dafne_torch.tools import calibrate_int8, canary, gen_canary, int8_canary, tta_canary
from dafne_torch.utils.weights import params_from_flax, params_to_flax

from chip_smoke import GATE_ADDED_FIELDS, JAX_GATE_RECORDS, file_digests
from test_torch_model import NARROW, narrow_cfgs

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHORT = [str(v) for v in NARROW] + [
    "SOLVER.MAX_ITER", "2", "DEBUG.OVERFIT_NUM_IMAGES", "2", "SOLVER.IMS_PER_BATCH", "2",
    "TPU.EVAL_BATCH", "2", "DATALOADER.NUM_WORKERS", "1"]


def _jax_tool(name):
    with open(os.path.join(ROOT, "tools", name)) as f:
        return f.read()


def _jax_main(name):
    tree = ast.parse(_jax_tool(name))
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _jax_expr(tool, target):
    """The value of `target`'s assignment in the JAX tool's main(), compiled."""
    node = next(n for n in ast.walk(_jax_main(tool)) if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Name) and n.targets[0].id == target)
    return compile(ast.Expression(node.value), tool, "eval")


def _jax_ok(tool, target, **ns):
    value = eval(_jax_expr(tool, target), {}, ns)
    return all(value.values()) if isinstance(value, dict) else bool(value)


@pytest.mark.parametrize("bf16, dynamic, static, sites", [
    (60.0, 59.0, 59.0, 72),  # each int8 mode exactly 1.0 under bf16: passes
    (60.0, 58.75, 60.0, 72),
    (60.0, 60.0, 58.75, 72),
    (50.0, 50.0, 50.0, 72),  # bf16 exactly 50: fails (JAX: > 50)
    (50.5, 50.0, 49.5, 72),
    (60.0, 60.0, 60.0, 0),  # no calibrated site: fails
])
def test_int8_checks_are_jaxs(bf16, dynamic, static, sites):
    mine = int8_canary.checks(bf16, dynamic, static, sites)
    theirs = _jax_ok("int8_canary.py", "ok", plain={"mAP": bf16}, quant={"mAP": dynamic},
                     static={"mAP": static}, scales=[0] * sites)
    assert all(mine.values()) == theirs
    assert all(int8_canary.checks(60.0, 59.0, 59.0, 72).values())
    assert not all(int8_canary.checks(50.0, 50.0, 50.0, 72).values())


@pytest.mark.parametrize("plain, tta, dets", [
    (60.0, 58.0, 5),  # exactly plain - 2.0: passes
    (60.0, 57.75, 5),
    (50.0, 60.0, 5),  # plain exactly 50: fails
    (60.0, 60.0, 0),  # no detection on image 0: fails
])
def test_tta_checks_are_jaxs(plain, tta, dets):
    mine = tta_canary.checks(plain, tta, dets)
    theirs = _jax_ok("tta_canary.py", "ok", results={"tta_detections_img0": dets},
                     tta_map=tta, plain_map=plain)
    assert all(mine.values()) == theirs
    assert all(tta_canary.checks(60.0, 58.0, 1).values())


@pytest.mark.parametrize("val, train, tta, dynamic, static", [
    (50.0, 45.0, 49.5, 49.0, 49.0),  # every check exactly at its edge: passes
    (49.75, 60.0, 60.0, 60.0, 60.0),
    (60.0, 54.75, 60.0, 60.0, 60.0),
    (60.0, 60.0, 59.25, 60.0, 60.0),
    (60.0, 60.0, 60.0, 58.75, 60.0),
    (60.0, 60.0, 60.0, 60.0, 58.75),
])
def test_gen_checks_are_jaxs(val, train, tta, dynamic, static):
    mine = gen_canary.checks(val, train, tta, dynamic, static)
    ns = dict(val={"mAP": val}, train_slice={"mAP": train}, tta={"mAP": tta},
              int8_dyn={"mAP": dynamic}, int8_sta={"mAP": static})
    theirs = eval(_jax_expr("gen_canary.py", "checks"), {}, ns)
    assert mine == {k: bool(v) for k, v in theirs.items()}
    assert all(gen_canary.checks(50.0, 45.0, 49.5, 49.0, 49.0).values())


def _jax_gen_canary():
    spec = importlib.util.spec_from_file_location(
        "jax_gen_canary", os.path.join(ROOT, "tools", "gen_canary.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gen_scales_are_jaxs_but_for_the_records():
    theirs = _jax_gen_canary()._SCALES
    assert set(theirs) == set(gen_canary._SCALES) == {256, 1024}
    for scale, p in gen_canary._SCALES.items():
        mine, jp = dict(p), dict(theirs[scale])
        assert mine.pop("out") == jp.pop("out").replace(".json", "_TORCH.json")
        assert mine == jp


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _get(cfg, key):
    for part in key.split("."):
        cfg = cfg[part]
    return cfg


def _jax_cfg(tool, yaml, **ns):
    """(JAX's config, the keys its tool sets): the recipe through
    ``load_config``, then every ``cfg.<KEY> = ...`` line of the tool's main()
    in source order (OUTPUT_DIR left out: each tool makes its own)."""
    cfg = load_config(yaml, freeze=False)
    lines = sorted((n for n in ast.walk(_jax_main(tool)) if isinstance(n, ast.Assign)
                    and isinstance(n.targets[0], ast.Attribute)
                    and ast.unparse(n.targets[0]).startswith("cfg.")),
                   key=lambda n: n.lineno)
    keys = []
    for n in lines:
        key = ast.unparse(n.targets[0])[len("cfg."):]
        if key != "OUTPUT_DIR":
            exec(compile(ast.Module([n], []), tool, "exec"), {"os": os, "int": int},
                 dict(ns, cfg=cfg))
            keys.append(key)
    return cfg, keys


@pytest.mark.parametrize("tool, iters", [("int8_canary", None), ("tta_canary", None),
                                         ("gen_canary", None), ("gen_canary_1024", None),
                                         ("gen_canary_1024", "100")])
def test_recipes_are_jaxs(tool, iters, monkeypatch):
    for var in ("CANARY_ITERS", "GEN_CANARY_ITERS"):
        monkeypatch.delenv(var, raising=False)
        if iters:
            monkeypatch.setenv(var, iters)
    if tool.startswith("gen_canary"):
        scale = 1024 if tool.endswith("1024") else 256
        p = gen_canary._SCALES[scale]
        yaml = os.path.join(ROOT, "configs", "synthetic", p["cfg"])
        jcfg, keys = _jax_cfg("gen_canary.py", yaml, P=_jax_gen_canary()._SCALES[scale],
                              args=types.SimpleNamespace(resume_dir=None))
        tcfg = gen_canary.recipe(scale)
        mine = ["SOLVER.MAX_ITER", "SOLVER.CHECKPOINT_PERIOD", "SOLVER.STEPS"]
        assert tcfg.SOLVER.STEPS == [int(0.8 * tcfg.SOLVER.MAX_ITER)]
    else:
        mod = {"int8_canary": int8_canary, "tta_canary": tta_canary}[tool]
        yaml = os.path.join(ROOT, mod.RECIPE)
        jcfg, keys = _jax_cfg(f"{tool}.py", yaml, eval_int8=False, scales_path="")
        tcfg = mod.recipe()
        mine = [k for k in mod.OVERRIDES[0::2] if k != "OUTPUT_DIR"] + ["SOLVER.MAX_ITER"]
    import yaml as pyyaml

    with open(yaml) as f:
        in_yaml = [k for k, _ in _leaves(pyyaml.safe_load(f))]
    assert set(keys) >= {"SOLVER.MAX_ITER", "SOLVER.CHECKPOINT_PERIOD"}
    for key in sorted(set(keys) | set(mine) | set(in_yaml)):
        assert _get(tcfg, key) == _get(jcfg, key), key
    if iters:
        assert tcfg.SOLVER.MAX_ITER == 100 and tcfg.SOLVER.STEPS == [80]


def _root_records():
    return {n: file_digests([n])[n] for n in os.listdir(ROOT) if n.endswith(".json")}


@pytest.fixture
def root_unchanged():
    """No record written at the repository's root (every JSON file there
    as it was, none added), so the JAX records are unchanged too."""
    before = _root_records()
    assert set(JAX_GATE_RECORDS) <= set(before)
    yield
    assert _root_records() == before


def _fields(jax_record):
    import json

    with open(os.path.join(ROOT, jax_record)) as f:
        return set(json.load(f)) | set(GATE_ADDED_FIELDS)


def _read(path):
    import json

    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("tool, jax_record", [(int8_canary, "INT8_CANARY.json"),
                                              (tta_canary, "TTA_CANARY.json")])
def test_short_canary_run_writes_its_record(tool, jax_record, tmp_path, root_unchanged):
    out = tmp_path / "record.json"
    rc = tool.main(["--cpu", "--out", str(out)] + SHORT + ["OUTPUT_DIR", str(tmp_path / "run")])
    record = _read(out)
    assert set(record) >= _fields(jax_record)
    assert rc == (0 if record["ok"] else 1) and record["ok"] == all(record["checks"].values())
    assert record["iters"] == 2 and record["device"] == "cpu" and record["seed"] == 0
    assert all(np.isfinite(v) for k, v in record.items() if k.endswith("mAP"))


def test_short_gen_run_calibrates_on_train_scenes_only(tmp_path, root_unchanged, monkeypatch):
    read = []
    real = calibrate_int8.calibrate

    def recording(cfg, model, records, *args):
        read.extend(r["image_id"] for r in records)
        return real(cfg, model, records, *args)

    monkeypatch.setattr(calibrate_int8, "calibrate", recording)
    st = {}
    record = gen_canary.run(256, SHORT + ["OUTPUT_DIR", str(tmp_path / "run")], "cpu", None, st)
    assert canary.report(record, str(tmp_path / "record.json")) == (0 if record["ok"] else 1)
    assert set(_read(tmp_path / "record.json")) >= _fields("GEN_CANARY.json")
    assert record["train_images"] == record["val_images"] == 2 and record["calib_images"] == 2
    train, val = set(st["train_ids"]), set(st["val_ids"])
    assert not train & val and set(st["slice_ids"]) <= train
    assert read and set(read) <= train and set(st["calib_ids"]) <= train
    assert record["calib_dataset"] == "synthetic_gen_train"


@pytest.mark.parametrize("uuid, limit", [("GPU-2b0c", "500.00 W"), ("1a7f", "700.00 W")])
def test_card_fields_read_the_cards_own_row(uuid, limit, monkeypatch):
    """nvidia-smi numbers the cards apart from CUDA_VISIBLE_DEVICES: the
    power limit comes from the row whose UUID is the device's, whether or
    not torch gives the UUID with nvidia-smi's "GPU-" prefix."""
    rows = "GPU-1a7f, 700.00 W\nGPU-2b0c, 500.00 W\n"
    monkeypatch.setattr(canary.subprocess, "run", lambda *a, **k: types.SimpleNamespace(stdout=rows))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "the card")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(uuid=uuid))
    assert canary.card_fields("cuda") == {"device": "the card", "power_limit": limit,
                                          "torch": torch.__version__}
    assert canary.card_fields("cpu")["power_limit"] is None


def test_params_to_flax_round_trip():
    jcfg, tcfg = narrow_cfgs()
    model = build_model(tcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    params, stats = params_to_flax(model)
    back = params_from_flax(params, stats)
    ref = model.state_dict()
    assert sorted(back) == sorted(ref)
    assert all(torch.equal(back[k], ref[k]) for k in ref)
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3)))
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), dict(shapes["params"]))
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), params))
    assert stats == {}


def test_params_to_flax_carries_bn_statistics():
    jcfg, tcfg = narrow_cfgs(["MODEL.DAFNE.NORM", "BN"])
    model = build_model(tcfg, device="cpu", generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.copy_(torch.rand_like(buf) + 0.5)
    params, stats = params_to_flax(copy.deepcopy(model))
    back = params_from_flax(params, stats)
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3)))
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), dict(shapes["batch_stats"]))
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), stats))
