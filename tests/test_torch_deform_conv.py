"""Port's deformable convolution vs the JAX package's, on the CPU.

``bilinear_sample`` (positions drawn a few pixels past every border, so
corners fall off the map), the four offset generators, ``DeformConv2d``
with learned offsets and a mask, its gradients in x, the offsets, the mask
and the weights against ``jax.grad``, and zero offsets against a regular
3x3 conv.  Inputs are drawn with numpy and handed to both.

Tolerances: float32 outputs within rtol 1e-5 and atol 1e-5 of the output's
scale (the two sum the same products in other orders); the generators
exactly (the same float32 ops).  bfloat16 (``bilinear_sample``) bit for
bit: JAX's eager ops round each result to bfloat16 as torch's do (under
``jit`` XLA may keep a chain in float32 between roundings).  Gradients
within rtol 1e-4, atol 1e-5 of the gradient's scale.  On the card the
kernel is held to the plain version bit for bit (forward) by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from dafne_tpu.layers import deform_conv as JD

from dafne_torch.layers import deform_conv as TD
from dafne_torch.ops.kernels import deform_conv as K
from dafne_torch.utils.weights import params_from_flax

torch.set_num_threads(2)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def close(got, want, rtol=1e-5, scale=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scale * max(1.0, np.abs(want).max()))


def positions(rng, n, h, w):
    """Sample positions spread over the map and 3 px past every border."""
    px = rng.uniform(-3.0, w + 2.0, (n, h, w)).astype(np.float32)
    py = rng.uniform(-3.0, h + 2.0, (n, h, w)).astype(np.float32)
    return px, py


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilinear_sample_matches_jax(dtype):
    rng = np.random.RandomState(0)
    n, h, w, c = 2, 9, 11, 5
    x = rng.randn(n, h, w, c).astype(np.float32)
    px, py = positions(rng, n, h, w)
    px[0, 0, :4] = [0.0, w - 1.0, w - 1.0 + 0.5, -0.5]  # the last column's x1 = x0 + 1 is off
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    want = np.asarray(JD.bilinear_sample(jnp.asarray(x, jdt), jnp.asarray(px), jnp.asarray(py)),
                      np.float32)
    got = TD.bilinear_sample(nchw(x).to(tdt), torch.from_numpy(px), torch.from_numpy(py))
    assert got.dtype == tdt
    off = (px < -1) | (px > w) | (py < -1) | (py > h)
    assert off.any() and not off.all()
    assert np.all(to_nhwc(got)[off] == 0) and np.all(want[off] == 0)
    if dtype == "float32":
        close(to_nhwc(got), want)
    else:
        np.testing.assert_array_equal(to_nhwc(got), want)


def test_generators_match_jax_exactly():
    rng = np.random.RandomState(1)
    n, h, w = 2, 5, 7
    cases = [
        (JD.ltrb_to_offsets, TD.ltrb_to_offsets, rng.uniform(0, 20, (n, h, w, 4))),
        (JD.hbox_to_offsets, TD.hbox_to_offsets, rng.uniform(0, 40, (n, h, w, 4))),
        (JD.center_to_offsets, TD.center_to_offsets, rng.uniform(-9, 9, (n, h, w, 2))),
        (JD.corners_to_offsets, TD.corners_to_offsets, rng.uniform(-30, 30, (n, h, w, 8))),
    ]
    for jfn, tfn, a in cases:
        a = a.astype(np.float32)
        for stride in (1.0, 8.0):
            want = np.asarray(jfn(jnp.asarray(a), stride))
            got = tfn(torch.from_numpy(a), stride).numpy()
            assert got.shape == want.shape == (n, h, w, 18), tfn.__name__
            np.testing.assert_array_equal(got, want, err_msg=f"{tfn.__name__} {stride}")


def _jax_module(c, f, rng, learned, x_shape):
    jm = JD.DeformConv2d(f, with_learned_offsets=learned)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros(x_shape))["params"]
    params = {"weight": {"kernel": (rng.randn(1, 1, 9 * c, f) / np.sqrt(9 * c)).astype(np.float32)}}
    if learned:
        assert set(shapes) == {"weight", "offset_conv"}
        params["offset_conv"] = {
            "kernel": (rng.randn(3, 3, c, 18) * 0.4 / np.sqrt(9 * c)).astype(np.float32),
            "bias": (rng.randn(18) * 0.5).astype(np.float32)}
    return jm, params


def _port_module(c, f, params, learned):
    """The port's module with JAX's parameters; without learned offsets JAX
    declares no offset_conv, and the port's stays unused (offsets are
    passed)."""
    tm = TD.DeformConv2d(c, f)
    keys = tm.load_state_dict(params_from_flax(params), strict=False)
    assert not keys.unexpected_keys
    assert sorted(keys.missing_keys) == ([] if learned else ["offset_conv.bias",
                                                             "offset_conv.weight"])
    return tm


def test_deform_conv_matches_jax_with_learned_offsets_and_mask():
    rng = np.random.RandomState(2)
    n, h, w, c, f = 2, 8, 10, 6, 7
    x = rng.randn(n, h, w, c).astype(np.float32)
    mask = rng.uniform(0, 1, (n, h, w, 9)).astype(np.float32)
    jm, params = _jax_module(c, f, rng, True, x.shape)
    want = jm.apply({"params": params}, jnp.asarray(x), None, jnp.asarray(mask))
    tm = _port_module(c, f, params, True)
    with torch.no_grad():
        got = tm(nchw(x), None, nchw(mask))
        offsets = tm.offset_conv(nchw(x))
    assert offsets.abs().max() > 1.5  # samples leave the 3x3 grid and the map
    close(to_nhwc(got), want)


def test_zero_offsets_equal_a_regular_conv():
    """With zero offsets each tap lands on a pixel and an off-map corner
    weighs 0: a 3x3 conv with zero padding, border included."""
    rng = np.random.RandomState(3)
    n, c, h, w, f = 2, 4, 7, 9, 5
    x = torch.from_numpy(rng.randn(n, c, h, w).astype(np.float32))
    tm = TD.DeformConv2d(c, f)
    with torch.no_grad():
        tm.weight.weight.copy_(torch.from_numpy(rng.randn(f, 9 * c, 1, 1).astype(np.float32)))
        got = tm(x, torch.zeros((n, 18, h, w)))
        w3 = tm.weight.weight.reshape(f, 9, c).permute(0, 2, 1).reshape(f, c, 3, 3)
        want = F.conv2d(x, w3, padding=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("learned", [False, True], ids=["given_offsets", "learned_offsets"])
def test_gradients_match_jax(learned):
    """d/dx, d/d offsets (or the offset conv's weights), d/d mask and
    d/d weights of sum(out * cotangent)."""
    rng = np.random.RandomState(4 + learned)
    n, h, w, c, f = 2, 6, 7, 5, 4
    x = rng.randn(n, h, w, c).astype(np.float32)
    mask = rng.uniform(0, 1, (n, h, w, 9)).astype(np.float32)
    offsets = rng.uniform(-2.5, 2.5, (n, h, w, 18)).astype(np.float32)
    cot = rng.randn(n, h, w, f).astype(np.float32)
    jm, params = _jax_module(c, f, rng, learned, x.shape)

    def loss(p, xx, oo, mm):
        out = jm.apply({"params": p}, xx, None if learned else oo, mm)
        return jnp.sum(out * cot)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(params, jnp.asarray(x), jnp.asarray(offsets),
                                                jnp.asarray(mask))
    tm = _port_module(c, f, params, learned)
    tx, to, tmask = (nchw(a).requires_grad_() for a in (x, offsets, mask))
    out = tm(tx, None if learned else to, tmask)
    (out * nchw(cot)).sum().backward()

    gp, gx, goff, gmask = want
    close(to_nhwc(tx.grad), gx, rtol=1e-4)
    close(to_nhwc(tmask.grad), gmask, rtol=1e-4)
    close(tm.weight.weight.grad.numpy().transpose(2, 3, 1, 0), gp["weight"]["kernel"], rtol=1e-4)
    if learned:
        assert to.grad is None
        close(tm.offset_conv.weight.grad.numpy().transpose(2, 3, 1, 0),
              gp["offset_conv"]["kernel"], rtol=1e-4)
        close(tm.offset_conv.bias.grad.numpy(), gp["offset_conv"]["bias"], rtol=1e-4)
    else:
        close(to_nhwc(to.grad), goff, rtol=1e-4)


def test_dispatch_by_device():
    """A CPU tensor takes the plain version; the kernel's wrapper refuses
    a CPU tensor rather than run anything."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(1, 3, 4, 5).astype(np.float32))
    offsets = torch.from_numpy(rng.uniform(-1, 1, (1, 18, 4, 5)).astype(np.float32))
    assert torch.equal(TD.deform_im2col(x, offsets), TD.deform_im2col_plain(x, offsets))
    before = K.deform_im2col_forward_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        K.deform_im2col_forward_cuda(x, offsets)
    with pytest.raises(ValueError, match="CUDA"):
        K.deform_im2col_backward_cuda(x, offsets, None, torch.zeros(1, 27, 4, 5))
    assert K.deform_im2col_forward_cuda.launches == before
