"""The Detectron2 weight importer, port vs JAX.

The port's ``utils/weight_import.py`` fills the port's state dict; the JAX
package's fills the flax tree, which ``utils/weights.py::params_from_flax``
turns into the port's names.  On the same checkpoint files (the complete
key inventories of ``tests/test_weight_import_exhaustive.py`` at depths 50
and 101, a DDP ``module.`` prefix, no-norm towers, an MSRA ``R-50.pkl``)
the two must give equal tensors, exactly.  A narrow model imported both
ways gives the same forward within f32 atol 1e-3, rtol 1e-4 (the
tolerance of ``tests/test_full_forward_parity.py``).
"""

import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafne_tpu.models import build_model as jax_build_model
from dafne_tpu.utils import weight_import as JW

from dafne_torch.config import get_cfg
from dafne_torch.engine.checkpoint import Checkpointer, load_weights
from dafne_torch.models import build_model
from dafne_torch.utils import weight_import as W
from dafne_torch.utils.weights import params_from_flax

from chip_smoke import c2_name, reference_values, write_reference_checkpoints
from test_torch_model import narrow_cfgs, random_flax_params
from test_weight_import_exhaustive import _build_params, make_dafne_checkpoint, make_resnet_state

torch.set_num_threads(2)


def _port_model(depth, num_classes, extra=()):
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", str(depth), "MODEL.DAFNE.NUM_CLASSES",
                         str(num_classes), "TPU.COMPUTE_DTYPE", "float32", *extra])
    return build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(depth))


def _jax_state(sd, depth, num_classes):
    """JAX's import of `sd`, as the port's state dict, and its report."""
    _, params = _build_params(depth, num_classes)
    new, report = JW.import_state_dict(sd, params)
    return params_from_flax(jax.tree_util.tree_map(np.asarray, new)), report


def _save_pth(tmp_path, sd, name="model_final.pth"):
    path = str(tmp_path / name)
    torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                "iteration": 1}, path)
    return path


@pytest.mark.parametrize("depth,num_classes,prefix", [(50, 15, ""), (101, 54, ""),
                                                      (50, 15, "module.")])
def test_full_checkpoint_equals_jax_import(tmp_path, depth, num_classes, prefix):
    rng = np.random.RandomState(depth)
    # the pixel buffers keep their names: the importer drops "pixel_*" keys
    sd = {(k if k.startswith("pixel_") else f"{prefix}{k}"): v
          for k, v in make_dafne_checkpoint(depth, num_classes, rng).items()}
    path = _save_pth(tmp_path, sd)
    model = _port_model(depth, num_classes)
    report = W.load_reference_weights(path, model)
    assert report.unmatched == [] and report.unfilled == []
    assert len(report.used) == len(sd) - 2  # every tensor but the pixel buffers

    want, jax_report = _jax_state({k: v for k, v in sd.items() if "pixel_" not in k}, depth,
                                  num_classes)
    assert jax_report.unfilled == [] and jax_report.unmatched == []
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _c2_pickle(tmp_path, depth, rng):
    """make_resnet_state's backbone under MSRA's Caffe2 names, as R-50.pkl
    stores it: no FrozenBN statistics, and a classifier to skip."""
    sd = make_resnet_state(depth, rng, prefix="")
    port = {}
    for k, v in sd.items():
        m = re.match(r"res(\d)\.(\d+)\.(conv\d|shortcut)(\.norm)?\.(\w+)$", k)
        if m:
            name = f"backbone.res{m[1]}_{m[2]}.{m[3]}{'_norm' if m[4] else ''}.{m[5]}"
        else:
            name = "backbone." + k.replace("stem.conv1.norm", "stem_conv1_norm").replace(
                "stem.conv1", "stem_conv1")
        port[name] = v
    blobs = {c2_name(n): v for n, v in port.items() if c2_name(n)}
    assert len(blobs) == sum(1 for k in sd if "running" not in k)
    blobs["fc1000_w"] = rng.randn(1000, 2048).astype(np.float32)
    blobs["fc1000_b"] = rng.randn(1000).astype(np.float32)
    path = str(tmp_path / f"R-{depth}.pkl")
    with open(path, "wb") as f:
        pickle.dump(blobs, f)
    return path, blobs


@pytest.mark.parametrize("depth", [50, 101])
def test_c2_pickle_equals_jax_import(tmp_path, depth):
    """The backbone fills, conv weights and FrozenBN scale and bias; the
    statistics (not in the file) keep mean 0 and variance 1 on both sides;
    the FPN and head keep the model's own initial weights."""
    path, blobs = _c2_pickle(tmp_path, depth, np.random.RandomState(depth + 1))
    model = _port_model(depth, 15)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    report = W.load_reference_weights(path, model)
    assert report.unmatched == []
    assert sorted(report.filled) == sorted(
        k for k in init if k.startswith("backbone.") and "running_" not in k)
    assert report.unfilled == sorted(set(init) - report.filled)

    _, params = _build_params(depth, 15)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   JW.load_reference_weights(path, params)))
    got = model.state_dict()
    for k in init:
        if k.startswith("backbone."):
            assert torch.equal(got[k], want[k]), k
        else:
            assert torch.equal(got[k], init[k]), k
    assert float(got["backbone.res2_0.conv1_norm.running_var"].min()) == 1.0
    assert float(got["backbone.res2_0.conv1_norm.running_mean"].abs().max()) == 0.0


def test_no_norm_tower_strides_map_convs_like_jax(tmp_path):
    """NORM 'none' towers ([conv, relu] * N, convs at 2i): the port's GN
    model takes the convs at the places JAX's no-norm model takes them;
    only its GN affines stay unfilled."""
    rng = np.random.RandomState(11)
    sd = {k: v for k, v in make_dafne_checkpoint(50, 15, rng).items()
          if "_tower." not in k and "pixel_" not in k}
    head = "proposal_generator.dafne_head"
    for tower in ("cls", "corners", "center"):
        for i in range(4):
            conv = rng.randn(256, 256, 3, 3).astype(np.float32)
            sd[f"{head}.{tower}_tower.{2 * i}.weight"] = conv
            sd[f"{head}.{tower}_tower.{2 * i}.bias"] = rng.randn(256).astype(np.float32)
    assert W._tower_strides(sd) == JW._tower_strides(sd) == {"cls": 2, "corners": 2, "center": 2}
    model = _port_model(50, 15)
    got, report = W.import_state_dict(sd, model.state_dict())
    assert report.unmatched == []
    assert report.unfilled == sorted(
        f"head.{t}_tower.norm{i}.{leaf}" for t in ("cls", "corners", "center") for i in range(4)
        for leaf in ("weight", "bias"))
    cfg = _jax_no_norm_cfg()
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    new, _ = JW.import_state_dict(sd, params)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, new))
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _jax_no_norm_cfg():
    from dafne_tpu.config import get_cfg as jax_get_cfg

    cfg = jax_get_cfg()
    cfg.MODEL.DAFNE.NORM = "none"
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def test_shape_mismatch_is_skipped_or_raises_with_strict():
    rng = np.random.RandomState(3)
    sd = {k: v for k, v in make_dafne_checkpoint(50, 10, rng).items() if "pixel_" not in k}
    model = _port_model(50, 15)  # 15 classes: the 10-class logits do not fit
    init = model.state_dict()
    got, report = W.import_state_dict(sd, init)
    bad = ["proposal_generator.dafne_head.cls_logits.weight",
           "proposal_generator.dafne_head.cls_logits.bias"]
    assert report.unmatched == bad
    assert report.unfilled == ["head.cls_logits.bias", "head.cls_logits.weight"]
    assert torch.equal(got["head.cls_logits.weight"], init["head.cls_logits.weight"])
    _, params = _build_params(50, 15)
    assert JW.import_state_dict(sd, params)[1].unmatched == bad
    with pytest.raises(ValueError, match="shape mismatch"):
        W.import_state_dict(sd, init, strict=True)


def test_narrow_forward_after_import_matches_jax(tmp_path):
    jcfg, tcfg = narrow_cfgs()
    model = build_model(tcfg, device="cpu")
    values = reference_values(model.state_dict(), np.random.RandomState(4))
    pkl, pth = write_reference_checkpoints(values, str(tmp_path))
    load_weights(model, pth)
    for k, v in values.items():
        assert torch.equal(model.state_dict()[k], torch.from_numpy(v)), k

    jmodel = jax_build_model(jcfg)
    params = random_flax_params(jmodel, seed=9)
    params = JW.load_reference_weights(pth, params)
    images = np.random.RandomState(5).uniform(0, 255, (2, 128, 128, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(params, jnp.asarray(images))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    for key in ("logits", "corners", "center", "ctrness"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=1e-4,
                                       err_msg=key)


def test_checkpointer_tells_the_formats_apart_by_content(tmp_path, caplog):
    """MODEL.WEIGHTS: a port checkpoint (under any extension) loads as it
    is, a Detectron2 .pth and an MSRA .pkl through the importer, and a
    detectron2:// URL is skipped with a log line."""
    _, tcfg = narrow_cfgs()
    src = build_model(tcfg, device="cpu", generator=torch.Generator().manual_seed(1))
    own = str(tmp_path / "own.pkl")  # the port's own state dict, misleadingly named
    torch.save({"model": src.state_dict()}, own)
    values = reference_values(src.state_dict(), np.random.RandomState(6))
    pkl, pth = write_reference_checkpoints(values, str(tmp_path))
    for weights, want in ((own, src.state_dict()), (pth, values)):
        model = build_model(tcfg, device="cpu", generator=torch.Generator().manual_seed(2))
        tcfg.MODEL.WEIGHTS = weights
        assert Checkpointer(str(tmp_path / "out")).resume_or_load(model, tcfg, resume=True) == 0
        for k, v in model.state_dict().items():
            assert torch.equal(v, torch.as_tensor(want[k])), (weights, k)
    model = build_model(tcfg, device="cpu", generator=torch.Generator().manual_seed(2))
    load_weights(model, pkl)
    assert torch.equal(model.state_dict()["backbone.stem_conv1.weight"],
                       torch.from_numpy(values["backbone.stem_conv1.weight"]))
    assert W.looks_like_reference(W.read_weights_file(pkl))
    assert not W.looks_like_reference(src.state_dict())
    tcfg.MODEL.WEIGHTS = "detectron2://ImageNetPretrained/MSRA/R-50.pkl"
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with caplog.at_level("INFO", logger="dafne_torch"):
        Checkpointer(str(tmp_path / "out2")).resume_or_load(model, tcfg, resume=False)
    assert "is not a file here" in caplog.text
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


class _RunsCode:
    """A pickled object whose unpickling would call `record`."""

    def __reduce__(self):
        return (_record_unpickled, ())


_UNPICKLED = []


def _record_unpickled():
    _UNPICKLED.append(1)
    return {}


@pytest.mark.parametrize("zip_format", [True, False])
def test_torch_save_files_load_weights_only(tmp_path, zip_format):
    """A torch.save file, zip or pre-zip, loads through torch.load with
    weights_only=True: tensors load, an arbitrary pickled object is refused
    before its code runs."""
    good, bad = str(tmp_path / "good.pth"), str(tmp_path / "bad.pth")
    torch.save({"model": {"w": torch.arange(3.0)}, "iteration": 7}, good,
               _use_new_zipfile_serialization=zip_format)
    torch.save({"model": {}, "hook": _RunsCode()}, bad, _use_new_zipfile_serialization=zip_format)
    data = W.read_weights_file(good)
    assert data["iteration"] == 7 and torch.equal(data["model"]["w"], torch.arange(3.0))
    with pytest.raises(pickle.UnpicklingError):
        W.read_weights_file(bad)
    assert not _UNPICKLED
