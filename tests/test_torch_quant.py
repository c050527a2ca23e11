"""int8 (w8a8) eval convs: ``dafne_torch/layers/quant.py`` and the plain
versions of its two kernels against ``dafne_tpu/layers/quant.py``.

Per function, bit for bit: the same numpy inputs through JAX's functions
(eager, as ``tests/test_quant.py`` calls them: under ``jit`` XLA turns a
division by a constant into a product with its reciprocal, which the
model-level test of ``test_torch_int8_eval.py`` meets) and the port's, for
the quantizers (f32 and bf16 input, an all-zero image, images of unequal
range, static scales that saturate) and ``int8_conv`` over 1x1 and 3x3,
strides 1 and 2, dilations 1 and 2, with and without bias, f32 and bf16
out, channel counts that are not multiples of 32, dynamic and static.

The quantized sites: the port's plan (``int8_site_plan``) equals the set
of sites at which JAX's interceptor runs its int8 call, site for site and
mode for mode, on the 64-wide tiny model of ``tests/test_quant.py``, DLA34,
VoVNet V-19-eSE and MobileNetV2, at min 64 and 256, dynamic and static
(a table with an amax of 0 and an uncalibrated narrow site).  JAX's set is
read by tracing its apply abstractly (``jax.eval_shape``) with
``_quantized_call`` wrapped: the interceptor decides at trace time.
Calibration on the same parameters gives JAX's keys and values within
1e-5 relative (the float32 forwards' drift, ``test_torch_model.py``), and
a scales JSON written by either package loads in the other.

``int8_conv``'s two CUDA kernels, without a card: the path chosen by shape
(every site of the four models above goes to the wgmma kernel; the shapes
that stay on the mma.sync kernel are named), the wrapper raising on a
failed launch (a stubbed library), and the tile geometry the wrapper hands
the tensor maps reproducing ``int8_conv_plain`` through a plain emulation
of the TMA boxes.
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dafne_tpu.config import get_cfg as jax_get_cfg
from dafne_tpu.layers import quant as JQ
from dafne_tpu.models import build_model as jax_build_model

from dafne_torch.config import get_cfg
from dafne_torch.layers import quant as Q
from dafne_torch.models import build_model
from dafne_torch.models.layers import Conv2d
from dafne_torch.ops.kernels import quant as K
from dafne_torch.utils.weights import params_from_flax

from torch_backbone_cases import draw_params

torch.set_num_threads(2)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _to_numpy(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---- the quantizers -----------------------------------------------------------

def _act_cases():
    x = _rand((3, 6, 5, 40), 1, 3.0)
    x[0] *= 1000.0  # an outlier image must not coarsen its batchmates
    return {"ranges": x, "zero": np.zeros((2, 4, 4, 8), np.float32),
            "small": _rand((2, 7, 9, 67), 2, 1e-3)}


@pytest.mark.parametrize("case", ["ranges", "zero", "small"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_tensor_dynamic_equals_jax(case, dtype):
    x = _act_cases()[case]
    jx = jnp.asarray(x).astype(dtype)
    want_q, want_s = JQ.quantize_tensor_dynamic(jx)
    tx = _nchw(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got_q, got_s = Q.quantize_tensor_dynamic(tx)
    assert got_q.dtype == torch.int8 and got_s.shape == (x.shape[0], 1, 1, 1)
    np.testing.assert_array_equal(got_q.permute(0, 2, 3, 1).numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.reshape(-1).numpy(), np.asarray(want_s).reshape(-1))
    # the op's plain version: the same values in the NHWC layout the conv reads
    op_q, op_s = torch.ops.dafne.quantize_act(tx, 0.0)
    np.testing.assert_array_equal(op_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(op_s.numpy(), np.asarray(want_s).reshape(-1))
    if case == "ranges":  # per-image isolation, as tests/test_quant.py:41-52
        solo_q, solo_s = Q.quantize_tensor_dynamic(tx[1:])
        assert torch.equal(solo_q, got_q[1:]) and torch.equal(solo_s, got_s[1:])
    if case == "zero":
        assert float(got_s.min()) > 0 and int(got_q.abs().max()) == 0


@pytest.mark.parametrize("amax", [9.1234, 0.5, 1e-12, 3.3e4])
def test_quantize_tensor_static_equals_jax(amax):
    x = _act_cases()["ranges"][1:]
    want_q, want_s = JQ.quantize_tensor_static(jnp.asarray(x), amax)
    got_q, got_s = Q.quantize_tensor_static(_nchw(x), amax)
    np.testing.assert_array_equal(got_q.permute(0, 2, 3, 1).numpy(), np.asarray(want_q))
    assert float(got_s) == float(want_s)
    op_q, op_s = torch.ops.dafne.quantize_act(_nchw(x), K.static_act_scale(amax))
    np.testing.assert_array_equal(op_q.numpy(), np.asarray(want_q))
    assert set(op_s.tolist()) == {float(want_s)}
    if amax == 0.5:
        assert int(got_q.abs().max()) == 127  # saturates, not NaN


def test_quantize_kernel_per_channel_equals_jax():
    w = _rand((3, 3, 72, 24), 3)
    w[..., 5] *= 100.0  # per-channel scales absorb a large channel
    w[..., 7] = 0.0  # a zero channel stays finite
    want_q, want_s = JQ.quantize_kernel_per_channel(jnp.asarray(w))
    got_q, got_s = Q.quantize_kernel_per_channel(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_array_equal(got_q.permute(2, 3, 1, 0).numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert int(got_q[7].abs().max()) == 0 and float(got_s[7]) > 0


# ---- int8_conv ----------------------------------------------------------------

#: (kernel, stride, dilation, bias, out dtype, cin, cout, act_amax)
CONV_CASES = [
    (1, 1, 1, True, "float32", 64, 64, None),
    (1, 2, 1, False, "float32", 72, 96, None),
    (3, 1, 1, True, "float32", 64, 80, None),
    (3, 2, 1, False, "bfloat16", 96, 64, None),
    (3, 1, 2, True, "bfloat16", 67, 72, None),
    (3, 2, 2, True, "float32", 80, 64, None),
    (3, 1, 1, True, "bfloat16", 64, 64, 2.5),
    (1, 1, 1, False, "float32", 100, 70, 7.0),
]


@pytest.mark.parametrize("k,stride,dil,bias,out,cin,cout,amax", CONV_CASES)
def test_int8_conv_equals_jax(k, stride, dil, bias, out, cin, cout, amax):
    seed = k * 1000 + stride * 100 + dil * 10 + cin
    x = _rand((2, 11, 13, cin), seed, 2.0)
    x[1] *= 0.01
    w = _rand((k, k, cin, cout), seed + 1, np.sqrt(2.0 / (k * k * cin)))
    b = _rand((cout,), seed + 2, 0.1) if bias else None
    pad = dil * (k // 2)
    want = JQ.int8_conv(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                        (stride, stride), [(pad, pad), (pad, pad)], (dil, dil),
                        getattr(jnp, out), act_amax=amax)
    got = Q.int8_conv(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                      None if b is None else torch.from_numpy(b), stride, pad, dil,
                      getattr(torch, out), act_amax=amax)
    assert got.dtype == getattr(torch, out)
    np.testing.assert_array_equal(_to_numpy(got.permute(0, 2, 3, 1).contiguous()),
                                  np.asarray(want.astype(jnp.float32)))


def test_int8_conv2d_module_equals_int8_conv_and_weights_at_call():
    conv = Conv2d(72, 64, 3, 2, padding=1)
    torch.nn.init.normal_(conv.weight, std=0.05)
    torch.nn.init.normal_(conv.bias, std=0.1)
    x = torch.from_numpy(_rand((2, 72, 9, 10), 4))
    want = Q.int8_conv(x, conv.weight, conv.bias, 2, 1, 1, torch.float32)
    once = Q.Int8Conv2d(conv, None, quantize_weights=True)
    per_call = Q.Int8Conv2d(conv, None, quantize_weights=False)
    assert once.weight is None and once.weight_q.shape == (64, 3, 3, 72)
    assert per_call.weight is conv.weight and per_call.weight_q is None
    with torch.no_grad():
        assert torch.equal(once(x), want) and torch.equal(per_call(x), want)


# ---- eligibility and the sites ------------------------------------------------

def test_conv_is_quantizable():
    ok = Conv2d(64, 64, 3, padding=1)
    assert Q.conv_is_quantizable(ok)
    assert not Q.conv_is_quantizable(Conv2d(64, 15, 3, padding=1))  # a predictor
    assert not Q.conv_is_quantizable(Conv2d(3, 64, 7, 2, padding=3))  # a stem
    assert not Q.conv_is_quantizable(Conv2d(64, 64, 3, padding=1, groups=64))  # depthwise
    assert not Q.conv_is_quantizable(Conv2d(64, 64, 3, padding=1, groups=2))  # grouped
    assert not Q.conv_is_quantizable(Conv2d(64, 64, 3, padding="same"))  # padding as a word
    assert not Q.conv_is_quantizable(torch.nn.Conv2d(64, 64, 3, padding=1))  # not the port's
    assert not Q.conv_is_quantizable(ok, 128) and Q.conv_is_quantizable(Conv2d(256, 256, 1), 256)
    assert Q.resolve_min_channels(None, None) == 64
    assert Q.resolve_min_channels(0, None) == 256 and Q.resolve_min_channels(0, {"a": 1.0}) == 64
    assert Q.resolve_min_channels(128, None) == 128


#: (name, overrides): the 64-wide tiny model of tests/test_quant.py:300-311
#: and the families of tests/test_quant.py:341-371
MODELS = {
    "tiny64": ["MODEL.RESNETS.DEPTH", "18", "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
               "MODEL.RESNETS.STEM_OUT_CHANNELS", "64", "MODEL.FPN.OUT_CHANNELS", "64",
               "MODEL.DAFNE.NUM_CLASSES", "3", "MODEL.DAFNE.NUM_CLS_CONVS", "1",
               "MODEL.DAFNE.NUM_BOX_CONVS", "1"],
    **{name: ["MODEL.BACKBONE.NAME", backbone, "MODEL.VOVNET.CONV_BODY", "V-19-eSE",
              "MODEL.FPN.OUT_CHANNELS", "64", "MODEL.DAFNE.NUM_CLASSES", "2",
              "MODEL.DAFNE.NUM_CLS_CONVS", "1", "MODEL.DAFNE.NUM_BOX_CONVS", "1"]
       for name, backbone in (("dla34", "build_dafne_dla_fpn_backbone"),
                              ("vovnet19", "build_vovnet_fpn_backbone"),
                              ("mnv2", "build_mnv2_backbone"))},
}
HW = 64
PREDICTORS = ("cls_logits", "ctrness", "corners_pred", "center_pred")


def _models(name):
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_list(MODELS[name] + ["TPU.COMPUTE_DTYPE", "float32"])
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))
    params = draw_params(dict(shapes["params"]), seed=7)
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(params), strict=True)
    return jmodel, params, model.eval()


def _jax_plan(jmodel, params, min_channels, scales, monkeypatch):
    """{site: amax or None} at which JAX's interceptor quantizes."""
    seen = {}
    real = JQ._quantized_call

    def recording(next_fun, args, kwargs, mod, x, act_amax=None):
        seen[JQ.module_site(mod)] = act_amax
        return real(next_fun, args, kwargs, mod, x, act_amax)

    monkeypatch.setattr(JQ, "_quantized_call", recording)

    def apply(p, x):
        with JQ.quantized_eval_scope(enabled=True, min_channels=min_channels, act_scales=scales):
            return jmodel.apply({"params": p}, x)

    jax.eval_shape(apply, params, jnp.zeros((1, HW, HW, 3)))
    return seen


def _jax_calibrate(jmodel, params, images, min_channels=64):
    return JQ.calibrate_act_scales(jmodel, {"params": params}, [jnp.asarray(images)],
                                   min_channels=min_channels)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_sites_equal_jax(name, monkeypatch):
    jmodel, params, model = _models(name)
    images = np.random.RandomState(3).uniform(0, 255, (1, HW, HW, 3)).astype(np.float32)
    table = _jax_calibrate(jmodel, params, images)
    sites = sorted(table)
    # static tables: the whole calibration, and one with an all-zero site
    # and the narrowest calibrated sites left out (uncalibrated: full
    # precision below 256, dynamic at 256 and wider)
    partial = {k: v for k, v in table.items() if k not in sites[1:4]}
    partial[sites[0]] = 0.0
    cases = [(mc, s) for mc in (64, 256) for s in (None, table, partial)]
    for min_channels, scales in cases:
        want = _jax_plan(jmodel, params, min_channels, scales, monkeypatch)
        got = {Q.module_site(n): a for n, a in
               Q.int8_site_plan(model, min_channels, scales).items()}
        assert got == want, (min_channels, None if scales is None else len(scales))
        assert not any(p in s for s in got for p in PREDICTORS)
    # the config's auto rule picks 256 dynamic and 64 static, as JAX's scope
    assert set(Q.int8_site_plan(model, Q.resolve_min_channels(0, None))) == set(
        Q.int8_site_plan(model, 256))
    assert set(Q.int8_site_plan(model, Q.resolve_min_channels(0, table), table)) == set(
        Q.int8_site_plan(model, 64, table))
    if name == "tiny64":
        assert len(Q.int8_site_plan(model, 64)) >= 5


def test_calibration_equals_jax_and_json_crosses(tmp_path):
    jmodel, params, model = _models("tiny64")
    images = np.random.RandomState(4).uniform(0, 255, (2, HW, HW, 3)).astype(np.float32)
    batches = [images[:1], images[1:]]
    want = JQ.calibrate_act_scales(jmodel, {"params": params},
                                   [jnp.asarray(b) for b in batches], min_channels=64)
    got = Q.calibrate_act_scales(model, [torch.from_numpy(b) for b in batches], min_channels=64)
    assert sorted(got) == sorted(want) and len(got) >= 5
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert all(v > 0 for v in got.values())
    # a scales table carries every calibrated site into the plan
    assert set(Q.int8_site_plan(model, 64, got)) == {k.replace("/", ".") for k in got}
    # and each package reads the other's JSON
    Q.save_act_scales(str(tmp_path / "port.json"), got)
    JQ.save_act_scales(str(tmp_path / "jax.json"), want)
    assert JQ.load_act_scales(str(tmp_path / "port.json")) == got
    assert Q.load_act_scales(str(tmp_path / "jax.json")) == want
    assert (tmp_path / "port.json").read_text().startswith('{\n "backbone/')
    # slack multiplies, as JAX's
    slack = Q.calibrate_act_scales(model, [torch.from_numpy(images[:1])], slack=1.5)
    first = Q.calibrate_act_scales(model, [torch.from_numpy(images[:1])])
    assert slack == {k: v * 1.5 for k, v in first.items()}


# ---- int8_conv's kernels: the path by shape, the tile geometry ------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_every_int8_site_takes_the_wgmma_kernel(name):
    """Every site of each model, at min 64 and 256, maps to one kernel:
    the wgmma one (their channel counts are multiples of 16, their strides
    1 or 2).  Random weights: only the sites' shapes matter."""
    cfg = get_cfg()
    cfg.merge_from_list(MODELS[name] + ["TPU.COMPUTE_DTYPE", "float32"])
    model = build_model(cfg, device="cpu")
    modules = dict(model.named_modules())
    for min_channels in (64, 256):
        paths = {site: K.int8_conv_path(modules[site].in_channels, modules[site].stride)
                 for site in Q.int8_site_plan(model, min_channels)}
        assert paths and set(paths.values()) == {"wgmma"}, (min_channels, paths)


#: (C, stride, kernel): x_q rows of C bytes need C a multiple of 16 for a
#: tensor map, and a run of 128 output pixels spans at most 256 input
#: columns; the mma.sync kernel takes the rest
PATHS = [(16, (1, 1), "wgmma"), (64, (2, 2), "wgmma"), (1440, (1, 2), "wgmma"),
         (67, (1, 1), "mma_sync"), (72, (1, 1), "mma_sync"), (100, (2, 2), "mma_sync"),
         (8, (1, 1), "mma_sync"), (64, (3, 3), "mma_sync"), (64, (1, 4), "mma_sync")]


@pytest.mark.parametrize("c,stride,path", PATHS)
def test_int8_conv_path_by_shape(c, stride, path):
    assert K.int8_conv_path(c, stride) == path


class _FailingLib:
    """A stand-in for the built library whose conv launch fails, keeping
    the geometry each call hands it."""

    def __init__(self, code):
        self.code, self.geometry = code, []

    def dafne_int8_conv(self, *args):
        self.geometry.append(list(ctypes.cast(args[6], ctypes.POINTER(ctypes.c_int))[:26]))
        return self.code


def _no_card(monkeypatch, module, lib):
    """Let a CUDA wrapper run its host code on CPU tensors: the stubbed
    library, no device checks, no device context, stream 0."""
    monkeypatch.setattr(module, "_lib", lambda: lib)
    monkeypatch.setattr(module, "check_cuda", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))


@pytest.mark.parametrize("c,path", [(64, "wgmma"), (72, "mma_sync")])
def test_int8_conv_wrapper_raises_on_a_failed_launch(monkeypatch, c, path):
    """A non-zero code from the library raises and counts no launch: no
    other kernel and no plain version stands in.  The wgmma path gets the
    tile geometry of ``int8_conv_tiles``."""
    lib = _FailingLib(700)
    _no_card(monkeypatch, K, lib)
    xq = torch.zeros((2, 13, 11, c), dtype=torch.int8)
    wq = torch.zeros((40, 3, 3, c), dtype=torch.int8)
    xs, ws = torch.ones(2), torch.ones(40)
    before = (K.int8_conv_cuda.launches, dict(K.int8_conv_cuda.launches_by_path))
    with pytest.raises(RuntimeError, match=f"the {path} kernel's launch failed with code 700"):
        K.int8_conv_cuda(xq, xs, wq, ws, None, [1, 1], [1, 1], [1, 1], torch.bfloat16)
    assert (K.int8_conv_cuda.launches, K.int8_conv_cuda.launches_by_path) == before
    (geometry,) = lib.geometry
    assert geometry[:15] == [2, 13, 11, c, 40, 3, 3, 1, 1, 1, 1, 1, 1, 13, 11]
    if path == "wgmma":  # 11 whole rows of 11 pixels a tile; boxes of 128 channels
        tiles = K.int8_conv_tiles(2, (1, 1), 13, 11)
        assert tiles["tile"] == (11, 11) and tiles["pixel_tiles"] == 4
        assert geometry[15:] == [1, 11, 11, 128, 11, 11, 1, 1, 1, 1, 1]
    else:
        assert geometry[15:] == [0] * 11


def _tma_box(xq, origin, box, element_strides):
    """The box TMA loads from x_q [N, H, W, C] at `origin` (c, w, h, n):
    ceil(box / stride) elements a dimension, `stride` apart, zeros outside
    the map -> [box rows x box columns, box channels] as float64."""
    dims = (xq.shape[3], xq.shape[2], xq.shape[1], xq.shape[0])  # (C, W, H, N)
    idx = [origin[d] + np.arange(-(-box[d] // element_strides[d])) * element_strides[d]
           for d in range(4)]
    ok = [(i >= 0) & (i < dims[d]) for d, i in enumerate(idx)]
    out = np.zeros([len(i) for i in idx[::-1]], np.float64)  # [n, h, w, c]
    x = xq.numpy()
    out[np.ix_(*ok[::-1])] = x[np.ix_(*(i[m] for i, m in zip(idx[::-1], ok[::-1])))]
    return out[0].reshape(-1, len(idx[0]))


def _box_origin(tiles, pixel_tile, r, q, c0, stride, padding, dilation):
    """((c, w, h, n) coordinates of x_q's box, (ho0, wo0) the tile's first
    output pixel), as csrc/int8_conv.cu's producer computes them."""
    bh, bw = tiles["tile"]
    n, rest = divmod(pixel_tile, tiles["tiles_h"] * tiles["tiles_w"])
    th, tw = divmod(rest, tiles["tiles_w"])
    ho0, wo0 = th * bh, tw * bw
    return (c0, wo0 * stride[1] - padding[1] + q * dilation[1],
            ho0 * stride[0] - padding[0] + r * dilation[0], n), (ho0, wo0)


def _tiled_conv(xq, xs, wq, ws, bias, stride, padding, dilation, out_dtype):
    """int8_conv as the wgmma kernel computes it, from the wrapper's tile
    geometry: per pixel tile, per tap and 128-channel slice, the box at
    the kernel's origin times w_q's slice (channels past C zero), summed exactly;
    then the epilogue over the tile's contiguous run of the output plane."""
    n, h, w, c = xq.shape
    o, kh, kw = wq.shape[:3]
    ho, wo = K.conv_out_hw(h, w, kh, kw, stride, padding, dilation)
    tiles = K.int8_conv_tiles(n, stride, ho, wo)
    bh, bw = tiles["tile"]
    slices = -(-c // K.WGMMA_TILE_K)
    wpad = np.zeros((o, kh, kw, slices * K.WGMMA_TILE_K))
    wpad[..., :c] = wq.numpy()
    y = torch.zeros((n, o, ho * wo), dtype=out_dtype)
    for t in range(tiles["pixel_tiles"]):
        acc = np.zeros((K.WGMMA_TILE_M, o))
        for r in range(kh):
            for q in range(kw):
                for c0 in range(0, slices * K.WGMMA_TILE_K, K.WGMMA_TILE_K):
                    origin, (ho0, wo0) = _box_origin(tiles, t, r, q, c0, stride, padding,
                                                     dilation)
                    a = _tma_box(xq, origin, tiles["box"], tiles["element_strides"])
                    acc[:len(a)] += a @ wpad[:, r, q, c0:c0 + K.WGMMA_TILE_K].T
        img = origin[3]
        valid = min(bw, wo - wo0) if bh == 1 else min(bh, ho - ho0) * bw
        v = torch.from_numpy(acc[:valid]).to(torch.int32).float() * (xs[img] * ws[None, :])
        if bias is not None:
            v = v + bias[None, :]
        y[img, :, ho0 * wo + wo0:ho0 * wo + wo0 + valid] = v.to(out_dtype).t()
    return y.reshape(n, o, ho, wo)


#: (H, W, stride, padding, dilation): Wo above 128 (two runs of a row, the
#: second part full) and Wo below it (11 or 6 whole rows a tile)
TILE_CASES = [(h, w, s, p, 1) for h, w in ((5, 140), (11, 13)) for s in (1, 2) for p in (0, 1)]
TILE_CASES.append((9, 21, 1, 2, 2))


@pytest.mark.parametrize("h,w,stride,pad,dil", TILE_CASES)
def test_tma_tile_geometry_reproduces_the_conv(h, w, stride, pad, dil):
    """The boxes, element strides and out-of-range origins the wrapper
    hands the tensor maps give int8_conv_plain's output bit for bit: C =
    144 (a second, partly empty slice), O = 40, bias, bf16 out."""
    rng = np.random.RandomState(h * 100 + w + stride + 7 * pad)
    c, o = 144, 40
    xq = torch.from_numpy(rng.randint(-127, 128, (2, h, w, c)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (o, 3, 3, c)).astype(np.int8))
    xs = torch.from_numpy(rng.uniform(1e-3, 1e-2, 2).astype(np.float32))
    ws = torch.from_numpy(rng.uniform(1e-3, 1e-2, o).astype(np.float32))
    bias = torch.from_numpy(rng.randn(o).astype(np.float32))
    args = (xq, xs, wq, ws, bias, (stride, stride), (pad, pad), (dil, dil), torch.bfloat16)
    want = K.int8_conv_plain(*args)
    assert torch.equal(_tiled_conv(*args), want)
