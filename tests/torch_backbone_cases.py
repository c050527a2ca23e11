"""Shared setup of the backbone tests (``test_torch_backbones.py``,
``test_torch_backbone_families.py``): the flax params drawn with numpy on
``jax.eval_shape``'s shapes, converted with ``params_from_flax`` and
loaded into the port's detector with ``strict=True`` (which checks the
port's table of FPN input widths against JAX's lazily shaped FPN).

Tolerance: atol max(1e-4, 4e-4 max|want|), rtol 1e-4.  The deep
fixed-width trunks round further from the exact result than the narrow
R-50 of ``test_torch_model.py`` (5e-5 max|want|) does: against the same
trunk in float64, V-39-eSE's res5 (max 445) is off by 0.071 in JAX's
float32 and 0.036 in the port's, 1.6e-4 and 8e-5 of the max.
"""

import copy
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from dafne_tpu.engine.optimizer import _freeze_labels as jax_freeze_labels
from dafne_tpu.engine.optimizer import _param_labels as jax_param_labels
from dafne_tpu.models import build_model as jax_build_model

from dafne_torch.engine.optimizer import flax_paths, param_labels
from dafne_torch.models import build_model
from dafne_torch.utils.weights import params_from_flax

from tests.test_torch_model import narrow_cfgs

HW = 64


def draw_params(shapes, seed, trunk_offset_std=1e-5):
    """Flax params as numpy, drawn on `shapes`: kernels He-scaled on fan-in
    (Dense kernels on their input), FrozenBN and GN affines near 1, small
    biases and means, variances in 0.5-1.5, cls bias -2.  A deformable
    conv's offset kernels are scaled so its offsets are about a pixel: the
    trunk's activations are ~1e3 on raw pixels (`trunk_offset_std` 1e-5),
    the towers' ~1 after GN (0.1).
    Samples fall between pixels and off the map, as trained offsets do,
    and a block's gain through its offsets stays near 1: with offsets of
    ~100 px a 1e-6 change of the input moves the narrow interval trunk's
    res4 by ~400 of ~5e3 (chaos, not a fault of either side).  A VoVNet
    block's ``concat_bn`` scale is drawn in 0.2-0.4: with a gain near 1
    the deep bodies are chaotic too (V-99-eSE's res5, max 8e3, is off the
    float64 result by 2.7e3 in JAX's float32 and 3.7e3 in the port's; at
    0.2-0.4 both agree with it to ~1e-6 of the max)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        names = [k.key for k in path]
        shape = leaf.shape
        if names[-1] == "kernel":
            std = np.sqrt(2.0 / np.prod(shape[:-1]))
            if "offset_conv" in names:
                std = trunk_offset_std if names[0] == "backbone" else 0.1
            return (rng.randn(*shape) * std).astype(np.float32)
        if names[-1] in ("running_var", "var"):
            return (rng.rand(*shape) + 0.5).astype(np.float32)
        if names[-1] in ("running_mean", "mean", "bias"):
            return (rng.randn(*shape) * 0.1).astype(np.float32)
        if names[-2] == "concat_bn":
            return (rng.rand(*shape) * 0.2 + 0.2).astype(np.float32)
        return (rng.rand(*shape) * 0.5 + 0.75).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    if "head" in params:
        params["head"]["cls_logits"]["bias"][:] = -2.0
    return params


def assert_close(got_levels, want_levels, what):
    """Each level within atol max(1e-4, 4e-4 max|want|), rtol 1e-4."""
    assert len(got_levels) == len(want_levels)
    for lvl, (got, want) in enumerate(zip(got_levels, want_levels)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, (what, lvl)
        atol = max(1e-4, 4e-4 * float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=1e-4,
                                   err_msg=f"{what} level {lvl}")


@functools.lru_cache(maxsize=None)
def setup(overrides):
    """(JAX cfg, port cfg, flax model, params, port model with them loaded)
    of the narrow config with `overrides` (a tuple)."""
    jcfg, tcfg = narrow_cfgs(list(overrides))
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))
    params = draw_params(dict(shapes["params"]), seed=sum(map(ord, "".join(overrides))))
    model = build_model(tcfg, device="cpu")
    sd = params_from_flax(params)
    assert set(sd) == set(model.state_dict())  # params_from_flax fills every key
    model.load_state_dict(sd, strict=True)
    return jcfg, tcfg, jmodel, params, model


def check_detector(overrides):
    """The trunk's features (captured from the flax detector's ``backbone``)
    and the detector's outputs against JAX's, batch 2 at HW^2."""
    _, _, jmodel, params, model = setup(tuple(overrides))
    images = np.random.RandomState(7).uniform(0, 255, (2, HW, HW, 3)).astype(np.float32)
    want, state = jmodel.apply({"params": params}, jnp.asarray(images),
                               capture_intermediates=lambda m, _: m.name == "backbone",
                               mutable=["intermediates"])
    want_feats = state["intermediates"]["backbone"]["__call__"][0]
    feats = {}
    hook = model.backbone.register_forward_hook(lambda m, i, out: feats.update(out))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    hook.remove()
    assert sorted(feats) == sorted(want_feats)
    for name in sorted(want_feats):
        assert_close([feats[name].permute(0, 2, 3, 1)], [want_feats[name]], name)
    assert got["hw"] == want["hw"]
    for key in ("logits", "corners", "center", "ctrness"):
        assert_close(got[key], want[key], key)


def check_labels(overrides, freeze_at):
    """The port's optimizer labels are JAX's, label for label; the JAX
    leaves the port keeps as buffers (running stats, the ResNet trunks'
    FrozenBN affines) are all frozen."""
    _, tcfg, _, params, model = setup(tuple(overrides))
    tcfg = copy.deepcopy(tcfg)
    tcfg.MODEL.BACKBONE.FREEZE_AT = freeze_at
    labels = jax_freeze_labels(jax_param_labels(params), params, freeze_at)
    want = {"/".join(k.key for k in path): lab
            for path, lab in jax.tree_util.tree_flatten_with_path(labels)[0]}
    paths = flax_paths(model)
    got = {paths[name]: lab for name, lab in param_labels(tcfg, model).items()}
    assert set(got) <= set(want)
    for path, lab in got.items():
        assert want[path] == lab, path
    assert {want[p] for p in set(want) - set(got)} == {"frozen"}
    return got
