"""Port's detector forward vs the flax model on the same weights and images.

R-50 structure at narrow widths in float32: the flax params are drawn with
numpy (He fan-in magnitude so activations stay O(1) through the trunk),
converted with ``params_from_flax`` and loaded with ``strict=True``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dafne_tpu.config import get_cfg as jax_get_cfg
from dafne_tpu.models import build_model as jax_build_model
from dafne_tpu.models.head import compute_locations as jax_compute_locations

from dafne_torch.config import get_cfg
from dafne_torch.models import build_model
from dafne_torch.models.head import compute_locations
from dafne_torch.utils.weights import params_from_flax

torch.set_num_threads(1)

NARROW = [
    "MODEL.RESNETS.STEM_OUT_CHANNELS", 16,
    "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
    "MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
    "MODEL.FPN.OUT_CHANNELS", 32,
    "TPU.COMPUTE_DTYPE", "float32",
]


def narrow_cfgs(extra=()):
    """(JAX cfg, port cfg) with the same narrow R-50 overrides."""
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_list([str(v) if not isinstance(v, str) else v for v in NARROW + list(extra)])
    return jcfg, tcfg


def random_flax_params(jmodel, seed, hw=128):
    """Flax params as nested numpy dicts, drawn from numpy: He-scaled conv
    kernels, small biases, non-trivial FrozenBN/GN affines, cls bias -2."""
    shapes = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3)))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = "/".join(k.key for k in path)
        shape = leaf.shape
        if name.endswith("kernel"):
            fan_in = shape[0] * shape[1] * shape[2]
            return (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name.endswith("running_var"):
            return (rng.rand(*shape) + 0.5).astype(np.float32)
        if name.endswith("running_mean") or name.endswith("bias"):
            return (rng.randn(*shape) * 0.1).astype(np.float32)
        return (rng.rand(*shape) * 0.5 + 0.75).astype(np.float32)  # BN/GN weight, scales

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["head"]["cls_logits"]["bias"][:] = -2.0
    return params


def port_model_from(params, tcfg):
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(params), strict=True)
    return model


def _assert_close(got_levels, want_levels, what):
    assert len(got_levels) == len(want_levels)
    for lvl, (got, want) in enumerate(zip(got_levels, want_levels)):
        want = np.asarray(want)
        assert got.shape == want.shape, (what, lvl)
        # scale-aware floor: f32 resolution at the tensor's own magnitude
        atol = max(1e-4, 5e-5 * float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=1e-4,
                                   err_msg=f"{what} level {lvl}")


@pytest.mark.parametrize("hw", [128, 256])
def test_forward_matches_flax(hw):
    jcfg, tcfg = narrow_cfgs()
    jmodel = jax_build_model(jcfg)
    params = random_flax_params(jmodel, seed=hw)
    images = np.random.RandomState(hw + 1).uniform(0, 255, (2, hw, hw, 3)).astype(np.float32)

    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(params, jnp.asarray(images))
    with torch.no_grad():
        got = port_model_from(params, tcfg)(torch.from_numpy(images))

    assert got["hw"] == want["hw"]
    for key in ("logits", "corners", "center", "ctrness"):
        _assert_close(got[key], want[key], key)


def test_params_from_flax_fills_every_key():
    jcfg, tcfg = narrow_cfgs()
    params = random_flax_params(jax_build_model(jcfg), seed=0)
    sd = params_from_flax(params)
    model = build_model(tcfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k


def test_unported_options_raise():
    """What is still refused raises: MODEL.RESNETS.NORM other than FrozenBN
    (JAX reads no such key), and an unknown MODEL.BACKBONE.NAME raises
    ValueError as in JAX.  Deformable towers and every other backbone are
    ported (tests/test_torch_backbones.py, test_torch_deform_conv.py)."""
    _, tcfg = narrow_cfgs(["MODEL.RESNETS.NORM", "BN"])
    with pytest.raises(NotImplementedError, match="RESNETS.NORM"):
        build_model(tcfg, device="cpu")
    jcfg, tcfg = narrow_cfgs(["MODEL.BACKBONE.NAME", "build_unknown_backbone"])
    with pytest.raises(ValueError, match="BACKBONE.NAME"):
        jax_build_model(jcfg)
    with pytest.raises(ValueError, match="BACKBONE.NAME"):
        build_model(tcfg, device="cpu")


def test_compute_locations_matches_jax():
    for h, w, s in [(16, 12, 8), (1, 1, 128), (5, 7, 64)]:
        np.testing.assert_array_equal(compute_locations(h, w, s).numpy(),
                                      np.asarray(jax_compute_locations(h, w, s)))
