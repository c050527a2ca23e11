"""Port's device warp (``ops/device_warp.py``) vs the JAX package's.

The same seeded uint8 base images and augmentations go through both
packages on the CPU.  The tap vectors must be equal field for field; the
rendered copies within 1e-3 of JAX's one-hot matmuls (0-255 scale) and
equal to a float64 restatement of the two taps rounded to float32 after
each operation (what IEEE float32 arithmetic gives), weights under
``TAP_EPS`` as 0; the color draws equal;
the color jitter within one intensity level of JAX's everywhere and equal
on at least 99.9% of the values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dafne_tpu.data import transforms as JT
from dafne_tpu.ops import device_warp as JW

from dafne_torch.data import transforms as T
from dafne_torch.ops import device_warp as W

torch.set_num_threads(1)

WARP_TOL = 1e-3  # 0-255 scale


def _augs(mod, w, h):
    """(name, aug) over scales, flips, rot90 . hflip, and a 90-degree
    rotation of a non-square image in its own frame (a non-canonical grid:
    zero border)."""
    up = mod.shortest_edge_resize(w, h, 2 * min(w, h), 4 * max(w, h))
    down = mod.shortest_edge_resize(w, h, min(w, h) // 2 + 3, 4 * max(w, h))
    return [
        ("identity", mod.identity(w, h)),
        ("upscale", up),
        ("downscale", down),
        ("hflip-down", mod.hflip(w, h).compose(down)),
        ("vflip-up", mod.vflip(w, h).compose(up)),
        ("rot90-hflip", mod.rotation(w, h, 90.0).compose(mod.hflip(w, h))),
        ("rot270-up", up.compose(mod.rotation(up.out_w, up.out_h, 270.0))),
        ("rot90-own-frame", mod.rotation(w, h, 90.0)),
    ]


def _fields(p):
    return {f: getattr(p, f) for f in ("transpose", "out_h", "out_w") + W.WARP_KEYS}


@pytest.mark.parametrize("w,h", [(48, 40), (40, 40)])
def test_separable_warp_params_equal_jax(w, h):
    canvas = (128, 128)
    seen_transpose, seen_zero_border = set(), False
    for (name, aug), (_, jaug) in zip(_augs(T, w, h), _augs(JT, w, h)):
        np.testing.assert_array_equal(aug.matrix, jaug.matrix)
        got = W.separable_warp_params(aug, w, h, canvas)
        want = JW.separable_warp_params(jaug, w, h, canvas)
        assert (got is None) == (want is None), name
        g, j = _fields(got), _fields(want)
        for key in g:
            np.testing.assert_array_equal(g[key], j[key], err_msg=f"{name} {key}")
            if key in W.WARP_KEYS:
                assert np.asarray(g[key]).dtype == np.asarray(j[key]).dtype, (name, key)
        seen_transpose.add(got.transpose)
        for axis, n in (("h", got.out_h), ("w", got.out_w)):
            live = getattr(got, "w0_" + axis)[:n] + getattr(got, "w1_" + axis)[:n]
            seen_zero_border |= bool((live == 0).any())
    assert seen_transpose == {False, True}
    assert seen_zero_border == (w != h)  # only the non-square rot90 crops its frame
    # a general angle is not separable
    assert W.separable_warp_params(T.rotation(w, h, 30.0), w, h, canvas) is None
    assert JW.separable_warp_params(JT.rotation(w, h, 30.0), w, h, canvas) is None


def _restated(img, p, transpose):
    """float64 two-tap restatement, rounded to float32 after every multiply
    and add, h first and then w; a weight under TAP_EPS is 0."""
    def rnd(v):
        return v.astype(np.float32).astype(np.float64)

    def weight(v):
        return np.where(v < W.TAP_EPS, 0.0, v.astype(np.float64))

    def taps(a0, a1, w0, w1):
        return rnd(rnd(weight(w0) * a0) + rnd(weight(w1) * a1))

    x = img.astype(np.float64)
    if transpose:
        x = x.transpose(1, 0, 2)
    k = p["idx0_h"].shape[0]
    out = []
    for c in range(k):
        y = taps(x[p["idx0_h"][c]], x[p["idx1_h"][c]], p["w0_h"][c][:, None, None],
                 p["w1_h"][c][:, None, None])
        out.append(taps(y[:, p["idx0_w"][c]], y[:, p["idx1_w"][c]], p["w0_w"][c][None, :, None],
                        p["w1_w"][c][None, :, None]))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_device_warp_matches_jax_and_restatement(seed):
    rng = np.random.RandomState(seed)
    h, w = 40, 48
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    canvas = (128, 128)
    groups = {}
    for name, aug in _augs(T, w, h):
        p = W.separable_warp_params(aug, w, h, canvas)
        groups.setdefault(p.transpose, []).append(p)
    for transpose, warps in groups.items():
        p = W.stack_warps(warps)
        got = W.device_warp(torch.from_numpy(img), W.warp_tensors(p, "cpu"), transpose).numpy()
        want = np.asarray(JW.device_warp(jnp.asarray(img), {k: jnp.asarray(v) for k, v in p.items()},
                                         transpose))
        assert got.shape == want.shape == (len(warps), *canvas, 3)
        assert np.abs(got - want).max() <= WARP_TOL, np.abs(got - want).max()
        np.testing.assert_array_equal(got, _restated(img, p, transpose))
        for i, wp in enumerate(warps):  # zero beyond each copy's output extent
            assert not got[i, wp.out_h:].any() and not got[i, :, wp.out_w:].any()


def test_device_warp_unit_scale_is_the_permutation():
    """Flips and 90-degree rotations at unit scale copy pixels exactly, also
    where a rotation's composed matrix puts a tap a hair past a center."""
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
    img[rng.rand(32, 32) < 0.3] = 0  # zeros beside non-zeros
    augs = [T.identity(32, 32), T.hflip(32, 32), T.vflip(32, 32)]
    augs += [T.rotation(32, 32, a).compose(T.hflip(32, 32)) for a in (90.0, 180.0, 270.0)]
    augs += [T.vflip(32, 32).compose(T.rotation(32, 32, a)) for a in (90.0, 270.0)]
    tiny = 0
    for aug in augs:
        p = W.separable_warp_params(aug, 32, 32, (32, 32))
        tiny += sum(int(((v > 0) & (v < W.TAP_EPS)).sum()) for k, v in vars(p).items()
                    if k.startswith("w"))
        got = W.device_warp(torch.from_numpy(img), W.warp_tensors(W.stack_warps([p]), "cpu"),
                            p.transpose)[0].numpy()
        np.testing.assert_array_equal(got, aug.apply_image(img).astype(np.float32))
    assert tiny > 0  # the case TAP_EPS is for was drawn


def test_device_warp_batch_matches_jax_and_restatement():
    rng = np.random.RandomState(3)
    s, canvas = 48, (64, 64)
    draws = [T.identity(s, s), T.rotation(s, s, 90.0).compose(T.resize(s, s, 40, 40)),
             T.hflip(s, s).compose(T.resize(s, s, 64, 64)), T.vflip(s, s).compose(T.resize(s, s, 30, 30))]
    imgs = rng.randint(0, 256, (len(draws), s, s, 3)).astype(np.uint8)
    warps = [W.separable_warp_params(a, s, s, canvas) for a in draws]
    # the batch form takes the base already transposed where a draw is anti-diagonal
    bases = np.stack([im.transpose(1, 0, 2) if wp.transpose else im for im, wp in zip(imgs, warps)])
    p = {k: np.stack([getattr(wp, k) for wp in warps]) for k in W.WARP_KEYS}
    got = W.device_warp_batch(torch.from_numpy(bases), W.warp_tensors(p, "cpu")).numpy()
    want = np.asarray(JW.device_warp_batch(jnp.asarray(bases), {k: jnp.asarray(v) for k, v in p.items()}))
    assert got.shape == want.shape == (len(draws), *canvas, 3)
    assert np.abs(got - want).max() <= WARP_TOL
    for i in range(len(draws)):
        one = {k: v[i:i + 1] for k, v in p.items()}
        np.testing.assert_array_equal(got[i], _restated(bases[i], one, False)[0])
    # int32 taps, as the loader ships them, give the same canvases
    p32 = {k: torch.from_numpy(v) for k, v in p.items()}
    np.testing.assert_array_equal(W.device_warp_batch(torch.from_numpy(bases), p32).numpy(), got)


def test_draw_color_params_equal_jax():
    for seed in range(5):
        got = W.draw_color_params(np.random.RandomState(seed))
        want = JW.draw_color_params(np.random.RandomState(seed))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype
        # the same stream position as the host path: the next draw agrees too
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        W.draw_color_params(a)
        T.apply_color_augmentations(np.zeros((2, 2, 3), np.uint8), b)
        assert a.rand() == b.rand()


def test_device_color_aug_matches_jax():
    rng = np.random.RandomState(4)
    b, c = 4, 96
    img = rng.uniform(0, 255, (b, c, c, 3)).astype(np.float32)
    out_hw = np.asarray([[96, 96], [80, 64], [50, 96], [33, 17]], np.int32)
    for i, (oh, ow) in enumerate(out_hw):
        img[i, oh:] = 0
        img[i, :, ow:] = 0
    draws = [W.draw_color_params(np.random.RandomState(10 + i)) for i in range(b)]
    light = np.stack([d["color_light"] for d in draws])
    wts = np.stack([d["color_w"] for d in draws])
    got = W.device_color_aug(torch.from_numpy(img), torch.from_numpy(light),
                             torch.from_numpy(wts), torch.from_numpy(out_hw)).numpy()
    want = np.asarray(JW.device_color_aug(jnp.asarray(img), jnp.asarray(light), jnp.asarray(wts),
                                          jnp.asarray(out_hw)))
    diff = np.abs(got - want)
    assert diff.max() <= 1.0, diff.max()
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()
    assert (got == np.floor(got)).all() and got.min() >= 0 and got.max() <= 255
    for i, (oh, ow) in enumerate(out_hw):
        assert not got[i, oh:].any() and not got[i, :, ow:].any()
