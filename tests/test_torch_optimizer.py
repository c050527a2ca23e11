"""Port's optimizer, parameter groups and schedule vs the JAX package.

The narrow R-50 detector's parameters (flax tree drawn with numpy, loaded
through ``params_from_flax``); gradients drawn with numpy and handed to
both.  The schedule and the updates at rtol 1e-6 (JAX keeps the LR in
float32, the port in float64; Adam's updates within ``ADAM_ATOL``); the
labels exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dafne_tpu.engine.optimizer import _freeze_labels as jax_freeze_labels
from dafne_tpu.engine.optimizer import _param_labels as jax_param_labels
from dafne_tpu.engine.optimizer import auto_scale_config as jax_auto_scale
from dafne_tpu.engine.optimizer import build_optimizer as jax_build_optimizer
from dafne_tpu.engine.optimizer import warmup_multistep_schedule as jax_schedule
from dafne_tpu.models import build_model as jax_build_model

from dafne_torch.models import build_model
from dafne_torch.engine.optimizer import (
    auto_scale_config,
    build_optimizer,
    clip_gradients_,
    flax_path,
    param_labels,
    warmup_multistep_schedule,
)
from dafne_torch.utils.weights import params_from_flax

from tests.test_torch_model import narrow_cfgs, port_model_from, random_flax_params

torch.set_num_threads(1)


@pytest.mark.parametrize("method", ["linear", "constant"])
def test_schedule_matches_jax(method):
    args = (0.02, (6, 9), 0.1, 0.25, 4, method)
    want = jax_schedule(*args)
    got = warmup_multistep_schedule(*args)
    for step in range(13):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, err_msg=str(step))


@pytest.fixture(scope="module")
def narrow():
    jcfg, tcfg = narrow_cfgs()
    params = random_flax_params(jax_build_model(jcfg), seed=3)
    return jcfg, tcfg, params


def _jax_labels(params, freeze_at):
    labels = jax_freeze_labels(jax_param_labels(params), params, freeze_at)
    flat = jax.tree_util.tree_flatten_with_path(labels)[0]
    return {"/".join(k.key for k in path): lab for path, lab in flat}


@pytest.mark.parametrize("freeze_at", [0, 2, 3])
def test_param_groups_match_jax_labels(narrow, freeze_at):
    jcfg, tcfg, params = narrow
    tcfg.MODEL.BACKBONE.FREEZE_AT = freeze_at
    model = port_model_from(params, tcfg)
    want = _jax_labels(params, freeze_at)
    got = {flax_path(n, p): lab for (n, p), lab in
           zip(model.named_parameters(), param_labels(tcfg, model).values())}
    for path, lab in got.items():
        assert want[path] == lab, path
    # the JAX leaves the port keeps as buffers (FrozenBN) are all frozen
    assert {want[p] for p in set(want) - set(got)} == {"frozen"}
    assert {"default", "bias", "norm"} <= set(got.values())
    assert got["head/scales"] == "default"
    assert got["head/cls_tower/norm0/bias"] == "bias"
    assert got["head/cls_tower/norm0/scale"] == "norm"
    optimizer, _ = build_optimizer(tcfg, model)
    in_groups = {id(p) for g in optimizer.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        frozen = got[flax_path(name, p)] == "frozen"
        assert p.requires_grad != frozen and (id(p) in in_groups) != frozen, name


def test_bn_tower_params_take_the_norm_group():
    """The per-level BatchNorms' scale is "norm" (WEIGHT_DECAY_NORM) and
    their bias "bias", as JAX's labels; their running statistics are
    buffers, in no group."""
    jcfg, tcfg = narrow_cfgs(["MODEL.DAFNE.NORM", "BN"])
    jmodel = jax_build_model(jcfg)
    params = random_flax_params(jmodel, seed=4)
    model = build_model(tcfg, device="cpu")
    want = _jax_labels(params, tcfg.MODEL.BACKBONE.FREEZE_AT)
    labels = param_labels(tcfg, model)
    params_ = dict(model.named_parameters())
    for name, lab in labels.items():
        assert want[flax_path(name, params_[name])] == lab, name
    assert labels["head.cls_tower.norm3_level4.weight"] == "norm"
    assert labels["head.center_tower.norm0_level2.bias"] == "bias"
    assert sum("_level" in n for n in labels) == 3 * 4 * 5 * 2


SOLVER_CASES = {
    "sgd": [],
    "nesterov": ["SOLVER.NESTEROV", "True"],
    "clip_value": ["SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_VALUE",
                   "0.05"],
    "clip_norm": ["SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE",
                  "norm", "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "0.5"],
    "nesterov_clip_norm": ["SOLVER.NESTEROV", "True", "SOLVER.CLIP_GRADIENTS.ENABLED", "True",
                           "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
                           "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "0.5"],
    "adam": ["SOLVER.OPTIMIZER", "adam"],
    "adam_clip_norm": ["SOLVER.OPTIMIZER", "adam", "SOLVER.CLIP_GRADIENTS.ENABLED", "True",
                       "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
                       "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "0.5"],
}


# optax's scale_by_adam forms the bias correction 1 - 0.999^t in float32
# (0.0010000467 at t = 1, 4.7e-5 off), torch in float64: each Adam update
# (~lr in size, whatever the gradient) differs by up to ~2.4e-5 of itself,
# ~1.2e-7 summed over these 3 steps' learning rates (bias group: x 2)
ADAM_ATOL = 2e-7


@pytest.mark.parametrize("case", sorted(SOLVER_CASES))
def test_three_steps_match_optax(narrow, case):
    _, _, params = narrow
    solver = ["SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_ITERS", "2", "SOLVER.WARMUP_FACTOR", "0.1",
              "SOLVER.STEPS", "(2,)", "SOLVER.BIAS_LR_FACTOR", "2.0",
              "SOLVER.WEIGHT_DECAY_NORM", "0.001"] + SOLVER_CASES[case]
    jcfg, tcfg = narrow_cfgs(solver)
    model = port_model_from(params, tcfg)
    optimizer, scheduler = build_optimizer(tcfg, model)
    tx, _ = jax_build_optimizer(jcfg, params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    rng = np.random.RandomState(7)
    pnames = dict(model.named_parameters())
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.randn(*a.shape) * 0.1).astype(np.float32), params)
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state,
                                       jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, g in params_from_flax(grads).items():
            if name in pnames and pnames[name].requires_grad:
                pnames[name].grad = g
        clip_gradients_(optimizer, tcfg)
        optimizer.step()
        scheduler.step()
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    moved = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=ADAM_ATOL if case.startswith("adam") else 1e-8,
                                   err_msg=name)
        moved += not np.array_equal(p.detach().numpy(), params_from_flax(params)[name].numpy())
    assert moved > 10


def test_unported_optimizer_raises(narrow):
    """A name that is neither sgd nor adam raises (JAX takes it as SGD)."""
    _, tcfg = narrow_cfgs(["SOLVER.OPTIMIZER", "rmsprop"])
    with pytest.raises(NotImplementedError, match="rmsprop"):
        build_optimizer(tcfg, port_model_from(narrow[2], tcfg))


def test_auto_scale_config_matches_jax():
    jcfg, tcfg = narrow_cfgs(["SOLVER.REFERENCE_WORLD_SIZE", "4", "SOLVER.IMS_PER_BATCH", "8",
                              "SOLVER.STEPS", "(60000, 80000)", "SOLVER.MAX_ITER", "90000"])
    for world in (1, 2, 8):
        want, got = jax_auto_scale(jcfg, world), auto_scale_config(tcfg, world)
        for key in ("IMS_PER_BATCH", "BASE_LR", "MAX_ITER", "WARMUP_ITERS", "STEPS",
                    "CHECKPOINT_PERIOD", "REFERENCE_WORLD_SIZE"):
            assert list(np.atleast_1d(got.SOLVER[key])) == list(np.atleast_1d(want.SOLVER[key])), key
    assert tcfg.SOLVER.IMS_PER_BATCH == 8  # the input config is left as it was
