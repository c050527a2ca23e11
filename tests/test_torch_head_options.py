"""Port's head options vs the flax model on the same weights and images.

Every corner strategy, the merged center-to-corner head, BN / SyncBN /
no-norm towers, Mish and the TOP_MODULE conv, on the narrow float32 R-50
of ``tests/test_torch_model.py`` (batch 2 at 192^2), in eval mode and in
train mode.  The flax params (and a BN model's ``batch_stats``) are drawn
with numpy, converted with ``params_from_flax(params, batch_stats)`` and
loaded with ``strict=True``.  In train mode the BN towers normalize with
the batch's statistics, and their updated running statistics are held to
JAX's mutated ``batch_stats``.  Tolerance: ``test_torch_model.py``'s (atol
max(1e-4, 5e-5 max|want|), rtol 1e-4).

Two choices keep float32 well conditioned (in float64 both sides agree to
the output's float32 rounding without them).  192^2 gives P7 2 x 2
locations: at 128^2 a train-mode BN on P7 takes its statistics over 2
values, where E[x^2] - E[x]^2 (flax's variance, which the port keeps)
cancels to a few bits.  BN scales are drawn in 0.2-0.4, as
``tests/test_full_forward_parity.py`` draws them: random running
statistics do not normalize, and with a gain near 1 the eval-mode
activations grow to ~1e6 over the towers.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dafne_tpu.models import build_model as jax_build_model

from dafne_torch.models import build_model
from dafne_torch.utils.weights import params_from_flax

from tests.test_torch_model import _assert_close, narrow_cfgs

torch.set_num_threads(2)

HW = 192
CASES = {
    "direct": ["MODEL.DAFNE.CORNER_PREDICTION", "direct"],
    "direct_no_centerness": ["MODEL.DAFNE.CORNER_PREDICTION", "direct",
                             "MODEL.DAFNE.CENTERNESS", "none"],
    "iterative": ["MODEL.DAFNE.CORNER_PREDICTION", "iterative"],
    "offset": ["MODEL.DAFNE.CORNER_PREDICTION", "offset"],
    "angle": ["MODEL.DAFNE.CORNER_PREDICTION", "angle"],
    "merged_center_to_corner": ["MODEL.DAFNE.MERGE_CORNER_CENTER_PRED", "True"],
    "bn": ["MODEL.DAFNE.NORM", "BN"],
    "syncbn": ["MODEL.DAFNE.NORM", "SyncBN"],
    "no_norm": ["MODEL.DAFNE.NORM", "none"],
    "mish": ["MODEL.DAFNE.USE_RELU", "False"],
    "top_module": ["MODEL.TOP_MODULE.NAME", "conv", "MODEL.TOP_MODULE.DIM", "12"],
}


def random_variables(jmodel, seed):
    """(params, batch_stats or None) drawn with numpy on the shapes of the
    flax variables (``jax.eval_shape``: no initializer runs): the params
    as ``random_flax_params`` draws them, but BN scales in 0.2-0.4 (see the
    module docstring); running means ~0.1, variances 0.5-1.5."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        names = [k.key for k in path]
        shape = leaf.shape
        if names[-1] == "kernel":
            fan_in = shape[0] * shape[1] * shape[2]
            return (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if names[-1] in ("running_var", "var"):
            return (rng.rand(*shape) + 0.5).astype(np.float32)
        if names[-1] in ("running_mean", "mean", "bias"):
            return (rng.randn(*shape) * 0.1).astype(np.float32)
        if names[-1] == "scale" and "_level" in names[-2]:
            return (rng.rand(*shape) * 0.2 + 0.2).astype(np.float32)
        return (rng.rand(*shape) * 0.5 + 0.75).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, dict(shapes))
    variables["params"]["head"]["cls_logits"]["bias"][:] = -2.0
    return variables["params"], variables.get("batch_stats")


@functools.lru_cache(maxsize=None)
def case_setup(case):
    """(JAX model, params, batch_stats, port cfg, images) of a case."""
    jcfg, tcfg = narrow_cfgs(CASES[case])
    jmodel = jax_build_model(jcfg)
    params, stats = random_variables(jmodel, seed=5)
    images = np.random.RandomState(8).uniform(0, 255, (2, HW, HW, 3)).astype(np.float32)
    return jmodel, params, stats, tcfg, images


def port_model(params, stats, tcfg):
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(params, stats), strict=True)
    return model


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_head_option_matches_flax(case, train):
    jmodel, params, stats, tcfg, images = case_setup(case)
    variables = {"params": params}
    if stats is not None:
        variables["batch_stats"] = stats
    new_stats = None
    if train and stats is not None:
        want, mutated = jmodel.apply(variables, jnp.asarray(images), train=True,
                                     mutable=["batch_stats"])
        new_stats = jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])
    else:
        want = jmodel.apply(variables, jnp.asarray(images), train=train)
    model = port_model(params, stats, tcfg)
    with torch.no_grad():
        got = model(torch.from_numpy(images), train=train)

    assert set(got) == set(want) and got["hw"] == want["hw"]
    for key in set(want) - {"hw"}:
        if want[key][0] is None:
            assert all(g is None for g in got[key]), key
            continue
        _assert_close(got[key], want[key], key)
    assert (want["center"][0] is None) == (case not in ("bn", "syncbn", "no_norm", "mish",
                                                        "top_module", "merged_center_to_corner"))
    running = {k: v for k, v in model.state_dict().items() if k.split(".")[-1].startswith("running_")
               and k.startswith("head.")}
    if stats is None:
        assert not running
        return
    # 3 towers x 4 convs x 5 levels x (mean, var)
    assert len(running) == 3 * 4 * 5 * 2
    ref = params_from_flax(params, new_stats if train else stats)
    moved = 0
    for name, value in running.items():
        _assert_close([value], [ref[name].numpy()], name)
        moved += not torch.equal(value, params_from_flax(params, stats)[name])
    assert moved == (len(running) if train else 0)


def test_top_module_outputs_dim_channels_per_level():
    jmodel, params, stats, tcfg, images = case_setup("top_module")
    model = port_model(params, stats, tcfg)
    with torch.no_grad():
        out = model(torch.from_numpy(images))
    assert [t.shape for t in out["top_feats"]] == [(2, h, w, 12) for h, w in out["hw"]]
    assert "top_module.weight" in model.state_dict()


def test_iterative_pred_convs_see_the_earlier_corners():
    """c{i}_pred's input is the tower output and the 2 * i corner channels
    before it: 256, 258, 260 and 262 channels at full width."""
    _, tcfg = narrow_cfgs(CASES["iterative"])
    tcfg.MODEL.FPN.OUT_CHANNELS = 256
    head = build_model(tcfg, device="cpu").head
    assert [getattr(head, f"c{i}_pred").weight.shape[1] for i in range(4)] == [256, 258, 260, 262]
    for absent in ("corners_pred", "center_pred", "center_tower", "xywha_pred"):
        assert not hasattr(head, absent), absent
