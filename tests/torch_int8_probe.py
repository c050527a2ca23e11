"""One set of trained canary weights, int8 in both packages on the CPU.

Does the port's int8 eval fall further under float than the JAX
package's on the same weights?  Both packages evaluate the same
checkpoint of the synthetic canary recipe (``configs/synthetic/base.yaml``,
32 overfit scenes, scored on those scenes) three times on the CPU: float32,
int8 with dynamic scales and int8 with static scales, in float32
(``TPU.COMPUTE_DTYPE``; trailing KEY VALUE overrides of both configs, such
as ``TPU.COMPUTE_DTYPE bfloat16``, the recipe's own, come after it).  The
static scales are one JSON (the port's ``calibrate_act_scales`` on 2 eval
batches of the 32 scenes), which both packages load.  The port is
evaluated once more in both int8 modes with JAX's jitted static rounding
(``round(x * f32(1 / s))``: under ``jit`` XLA divides by a constant scale
through its reciprocal, where the port and JAX's eager call divide), and
in all three modes at ALT_THREADS torch threads (oneDNN's convs round
differently by thread count: another float path into the same int8
sites, so int8's own noise within one package).  The
share of int8 values that differ between the packages is measured on
FLIP_IMAGES scenes: each int8 site's first input in each package,
quantized by JAX's function (static: the port's divide against JAX's
jitted reciprocal).

A checkpoint of the full-width R-50 (138 MB) can travel from the card's
machine in parts of about 46 MB:

    python tests/torch_int8_probe.py split --checkpoint-dir output/int8_canary \
        --part 0 --parts 3 --out output/probe_w0.pt     # on the card's machine

writes part `--part` of the newest checkpoint's model state (the tensors
in name order, cut by bytes) with a SHA-256 of the whole state.  Two
trainings at one seed under the same settings give one checkpoint only if
the hashes agree, and ``probe`` refuses parts whose hashes differ:

    JAX_PLATFORMS=cpu python tests/torch_int8_probe.py probe \
        --weights probe_w0.pt probe_w1.pt probe_w2.pt --out output/int8_probe.json

prints one JSON line per measurement and the summary, and writes it to
``--out``.  ``--tta`` adds both packages' TTA mAP on the same weights (the
TTA canary's ladder).

    JAX_PLATFORMS=cpu python tests/torch_int8_probe.py spread \
        --weights probe_w0.pt probe_w1.pt probe_w2.pt [--seeds 0,1,2,3] [--eps 1e-7]

measures how far int8 mAP moves between equivalent programs on the same
checkpoint and scales JSON: JAX's eval eager against jitted, and both
packages on the weights drifted by about an ulp (each float tensor times
1 + eps * N(0, 1)), in float32, int8 dynamic and int8 static
(``--modes int8_dynamic --drift-only``: float32 and dynamic int8 on the
drifted weights alone).

    JAX_PLATFORMS=cpu python tests/torch_int8_probe.py parting \
        --weights probe_w0.pt probe_w1.pt probe_w2.pt [--out output/int8_parting.json]

finds, scene by scene in dynamic int8, where the two packages part: each
package's model runs free on one scene, and the first int8 site whose
quantized input differs is the parting site, with the module that
produced that input.  Every float module (conv, FrozenBN, GroupNorm) and
every int8 site is also run on the other package's input: the port's
module on JAX's input to the same module, against JAX's output, as
max |port - JAX| in float32 spacings (ulps) at the output's largest
magnitude, so that an op that computes another function shows as more
than rounding.

    JAX_PLATFORMS=cpu python tests/torch_int8_probe.py gn --weights ... [--scenes 2]

holds each GroupNorm of the head, on the port's inputs to it (float32, the
first scenes), against float64: the port's module and flax's
``GroupNorm`` (jitted, as JAX's eval step runs it), in float32 spacings at
the output's largest magnitude.  flax computes var = E[x^2] - E[x]^2
(``use_fast_variance``), whose rounding grows with mean / std; the port's
``F.group_norm`` computes E[(x - mean)^2].  ``split`` needs only torch;
``probe``, ``spread``, ``parting`` and ``gn`` need both packages.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CANARY_OPTS = ["DEBUG.OVERFIT_NUM_IMAGES", "32", "DATASETS.TEST", "('synthetic_train',)",
               "TPU.COMPUTE_DTYPE", "float32"]
CALIB_BATCHES = 2
MIN_CHANNELS = 64
FLIP_IMAGES = 4  # scenes of the dynamic flip count
ALT_THREADS = 1  # the port's evaluations again at this torch thread count
DRIFT_EPS = 1e-7  # spread: the weights' relative drift, about an ulp of float32
#: --tta: the TTA canary's ladder (dafne_torch/tools/tta_canary.py)
TTA_OPTS = ["TEST.AUG.ENABLED", "True", "TEST.AUG.MIN_SIZES", "(192, 256, 320)",
            "TEST.AUG.MAX_SIZE", "512"]


def state_hash(sd) -> str:
    """SHA-256 over every tensor's name, dtype, shape and bytes, in name order."""
    h = hashlib.sha256()
    for k in sorted(sd):
        t = sd[k].detach().cpu().contiguous()
        h.update(f"{k}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def split(checkpoint_dir: str, part: int, parts: int, out: str) -> None:
    from dafne_torch.engine.checkpoint import Checkpointer

    ck = Checkpointer(checkpoint_dir)
    step = ck.latest_step()
    sd = torch.load(ck._path(step), map_location="cpu", weights_only=True)["model"]
    keys = sorted(sd)
    total = sum(sd[k].numel() * sd[k].element_size() for k in keys)
    lo, hi = total * part // parts, total * (part + 1) // parts
    mine, at = {}, 0
    for k in keys:  # a tensor goes to the part its first byte falls in
        if lo <= at < hi:
            mine[k] = sd[k]
        at += sd[k].numel() * sd[k].element_size()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save({"sha256": state_hash(sd), "step": step, "part": part, "parts": parts,
                "keys": keys, "tensors": mine}, out)
    print(json.dumps({"sha256": state_hash(sd), "step": step, "part": part,
                      "tensors": len(mine), "bytes": os.path.getsize(out)}), flush=True)


def join(paths):
    parts = [torch.load(p, map_location="cpu", weights_only=True) for p in paths]
    hashes = {p["sha256"] for p in parts}
    if len(hashes) != 1:
        raise SystemExit(f"the parts come from different checkpoints: {sorted(hashes)}")
    sd = {}
    for p in parts:
        sd.update(p["tensors"])
    if sorted(sd) != parts[0]["keys"] or state_hash(sd) != parts[0]["sha256"]:
        raise SystemExit("the joined parts are not the checkpoint they were cut from")
    return sd, parts[0]["sha256"], parts[0]["step"]


def probe(weight_paths, out: str, opts=(), tta: bool = False) -> dict:
    import jax
    import jax.numpy as jnp

    from dafne_tpu.config import load_config
    from dafne_tpu.data.registry import get_dataset as jax_get_dataset
    from dafne_tpu.data.registry import register_all_datasets as jax_register
    from dafne_tpu.engine.train_loop import do_test as jax_do_test
    from dafne_tpu.engine.tta import do_test_with_tta as jax_do_test_with_tta
    from dafne_tpu.layers import quant as JQ
    from dafne_tpu.engine.trainer import make_eval_step as jax_make_eval_step
    from dafne_tpu.models import build_model as jax_build_model

    from dafne_torch.config import get_cfg
    from dafne_torch.data import get_dataset, register_all_datasets
    from dafne_torch.engine.inference import make_eval_step
    from dafne_torch.engine.train_loop import do_test
    from dafne_torch.engine.tta import do_test_with_tta
    from dafne_torch.layers import quant as Q
    from dafne_torch.models import build_model
    from dafne_torch.ops.kernels import quant as QK
    from dafne_torch.tools.calibrate_int8 import calibrate
    from dafne_torch.utils.weights import params_to_flax

    sd, digest, step = join(weight_paths)
    recipe = os.path.join(ROOT, "configs", "synthetic", "base.yaml")
    tcfg = get_cfg()
    tcfg.merge_from_file(recipe)
    tcfg.merge_from_list(CANARY_OPTS + list(opts))
    work = os.path.join(ROOT, "output", "int8_probe", tcfg.TPU.COMPUTE_DTYPE)
    os.makedirs(work, exist_ok=True)
    tcfg.OUTPUT_DIR = work
    jcfg = load_config(recipe, freeze=False)
    jcfg.merge_from_list(CANARY_OPTS + list(opts) + ["OUTPUT_DIR", work])
    register_all_datasets(tcfg)
    jax_register(jcfg)
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    model.eval()
    params, batch_stats = params_to_flax(model)
    jmodel = jax_build_model(jcfg)

    (name,) = tcfg.DATASETS.TEST
    records, jrecords = get_dataset(name, tcfg), jax_get_dataset(name, jcfg)
    same_images = len(records) == len(jrecords) and all(
        np.array_equal(a["image"], b["image"]) for a, b in zip(records, jrecords))
    scales_path = os.path.join(work, "int8_scales.json")
    Q.save_act_scales(scales_path, calibrate(tcfg, model, records, CALIB_BATCHES, MIN_CHANNELS))
    modes = {"float32": {}, "int8_dynamic": {"EVAL_INT8": True},
             "int8_static": {"EVAL_INT8": True, "EVAL_INT8_SCALES": scales_path}}
    maps = {"torch": {}, "jax": {}}
    for mode, keys in modes.items():
        for pkg in ("torch", "jax"):
            c = copy.deepcopy(tcfg if pkg == "torch" else jcfg)
            for k, v in keys.items():
                c.TPU[k] = v
            t0 = time.perf_counter()
            if pkg == "torch":
                res = do_test(c, model, os.path.join(work, f"torch_{mode}"))[name]
            else:
                res = jax_do_test(c, jmodel, params, os.path.join(work, f"jax_{mode}"),
                                  batch_stats=batch_stats or None)[name]
            maps[pkg][mode] = float(res["mAP"])
            print(json.dumps({"package": pkg, "mode": mode, "mAP": maps[pkg][mode],
                              "s": round(time.perf_counter() - t0, 1)}), flush=True)

    # the port again with JAX's jitted static rounding: under jit XLA
    # divides by the constant scale through its reciprocal,
    # round(x * f32(1 / s)), where both the port and JAX's eager call
    # compute round(x / s) (dynamic scales are tensors and keep the divide
    # under jit; there the same rounding is one more int8 realization)
    real_q = QK.quantize_with_scale

    def reciprocal_q(xf, scale):
        return torch.clamp(torch.round(xf * (1.0 / scale)), -127, 127).to(torch.int8)

    for mode in ("int8_dynamic", "int8_static"):
        c = copy.deepcopy(tcfg)
        for k, v in modes[mode].items():
            c.TPU[k] = v
        QK.quantize_with_scale = reciprocal_q
        try:
            res = do_test(c, model, os.path.join(work, f"torch_{mode}_reciprocal"))[name]
        finally:
            QK.quantize_with_scale = real_q
        maps["torch"][f"{mode}_reciprocal"] = float(res["mAP"])
        print(json.dumps({"package": "torch", "mode": f"{mode}_reciprocal",
                          "mAP": float(res["mAP"])}), flush=True)

    # int8's own noise within the port: the same evaluations with another
    # torch thread count, whose oneDNN convs round differently
    threads = torch.get_num_threads()
    torch.set_num_threads(ALT_THREADS)
    try:
        for mode in ("float32", "int8_dynamic", "int8_static"):
            c = copy.deepcopy(tcfg)
            for k, v in modes[mode].items():
                c.TPU[k] = v
            res = do_test(c, model, os.path.join(work, f"torch_{mode}_threads"))[name]
            maps["torch"][f"{mode}_{ALT_THREADS}_threads"] = float(res["mAP"])
            print(json.dumps({"package": "torch", "mode": f"{mode}_{ALT_THREADS}_threads",
                              "mAP": float(res["mAP"])}), flush=True)
    finally:
        torch.set_num_threads(threads)

    # the flips: each int8 site's first input in each package on
    # FLIP_IMAGES scenes (JAX's eval step eager, its site calls recorded),
    # in float32 (a bfloat16 input exactly), quantized by JAX's function
    # (which both packages' quantizers equal bit for bit): dynamic, and
    # static with the divide against JAX's jitted reciprocal
    images = np.stack([r["image"] for r in records[:FLIP_IMAGES]]).astype(np.float32)
    hw = tuple(images.shape[1:3])
    scales = Q.load_act_scales(scales_path)
    flips = {}
    for mode in ("int8_dynamic", "int8_static"):
        dcfg, jdcfg = copy.deepcopy(tcfg), copy.deepcopy(jcfg)
        for k, v in modes[mode].items():
            dcfg.TPU[k] = jdcfg.TPU[k] = v
        step_t = make_eval_step(model, dcfg, hw)
        mine = {}

        def first_input(site):
            def pre(mod, args):
                mine.setdefault(site, args[0].float().permute(0, 2, 3, 1).numpy())
            return pre

        hooks = [m.register_forward_pre_hook(first_input(Q.module_site(n)))
                 for n, m in step_t.program.model.named_modules()
                 if isinstance(m, Q.Int8Conv2d)]
        step_t(torch.from_numpy(images))
        for h in hooks:
            h.remove()
        theirs = {}
        real = JQ._quantized_call

        def recording(next_fun, args, kwargs, mod, x, act_amax=None):
            theirs.setdefault(JQ.module_site(mod), np.asarray(x, dtype=np.float32))
            return real(next_fun, args, kwargs, mod, x, act_amax)

        JQ._quantized_call = recording
        try:
            jax_make_eval_step(jmodel, jdcfg, hw)(params, jnp.asarray(images))
        finally:
            JQ._quantized_call = real
        flipped = total = 0
        per_site = []
        for site in theirs:
            if mode == "int8_dynamic":
                q_mine = np.asarray(JQ.quantize_tensor_dynamic(jnp.asarray(mine[site]))[0])
                q_theirs = np.asarray(JQ.quantize_tensor_dynamic(jnp.asarray(theirs[site]))[0])
            else:
                q_mine = np.asarray(JQ.quantize_tensor_static(jnp.asarray(mine[site]),
                                                              scales[site])[0])
                q_theirs = np.asarray(jax.jit(lambda x, a=scales[site]: JQ.quantize_tensor_static(
                    x, a)[0])(jnp.asarray(theirs[site])))
            f = int((q_mine != q_theirs).sum())
            flipped, total = flipped + f, total + q_mine.size
            per_site.append([site, f, int(q_mine.size)])
        flips[mode] = {"flipped": flipped, "values": total, "share": flipped / max(total, 1),
                       "images": FLIP_IMAGES, "sites": len(per_site),
                       "sites_in_both": sorted(mine) == sorted(theirs),
                       "first_flipped_sites": [x for x in per_site if x[1]][:5]}
        print(json.dumps({"flips": mode, **flips[mode]}), flush=True)
    if tta:  # both packages' TTA on the same weights: the TTA canary's ladder
        for pkg in ("torch", "jax"):
            c = copy.deepcopy(tcfg if pkg == "torch" else jcfg)
            c.merge_from_list(TTA_OPTS)
            t0 = time.perf_counter()
            if pkg == "torch":
                res = do_test_with_tta(c, model, os.path.join(work, "torch_tta"))[name]
            else:
                res = jax_do_test_with_tta(c, jmodel, params, os.path.join(work, "jax_tta"),
                                           batch_stats=batch_stats or None)[name]
            maps[pkg]["tta"] = float(res["mAP"])
            print(json.dumps({"package": pkg, "mode": "tta", "mAP": maps[pkg]["tta"],
                              "s": round(time.perf_counter() - t0, 1)}), flush=True)
    drops = {pkg: {m: maps[pkg]["float32"] - maps[pkg][m] for m in maps[pkg]
                   if m.startswith("int8") and "threads" not in m} for pkg in maps}
    alt = f"_{ALT_THREADS}_threads"
    drops["torch"].update({m + alt: maps["torch"]["float32" + alt] - maps["torch"][m + alt]
                           for m in ("int8_dynamic", "int8_static")})
    result = {"checkpoint_sha256": digest, "checkpoint_step": step, "images": len(records),
              "images_equal": bool(same_images), "calibration_batches": CALIB_BATCHES,
              "compute_dtype": tcfg.TPU.COMPUTE_DTYPE, "maps": maps, "drops": drops,
              "drop_diff": {m: drops["torch"][m] - drops["jax"][m] for m in drops["jax"]},
              "flips": flips}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


def spread(weight_paths, out: str, seeds, eps: float = DRIFT_EPS,
           int8_modes=("int8_dynamic", "int8_static"), drift_only: bool = False) -> dict:
    """How far int8 mAP moves between equivalent programs, on the CPU in
    float32, with one scales JSON (the port's calibration on 2 batches):
    JAX's ``do_test`` eager (``jax.disable_jit``) against jitted (unless
    `drift_only`), and both packages on the weights drifted by an ulp,
    each float tensor times (1 + `eps` * N(0, 1)) at each of `seeds`
    (torch generators), in float32 and each of `int8_modes`."""
    import jax

    from dafne_tpu.config import load_config
    from dafne_tpu.data.registry import register_all_datasets as jax_register
    from dafne_tpu.engine.train_loop import do_test as jax_do_test
    from dafne_tpu.models import build_model as jax_build_model

    from dafne_torch.config import get_cfg
    from dafne_torch.data import get_dataset, register_all_datasets
    from dafne_torch.engine.train_loop import do_test
    from dafne_torch.layers import quant as Q
    from dafne_torch.models import build_model
    from dafne_torch.tools.calibrate_int8 import calibrate
    from dafne_torch.utils.weights import params_to_flax

    sd, digest, step = join(weight_paths)
    recipe = os.path.join(ROOT, "configs", "synthetic", "base.yaml")
    work = os.path.join(ROOT, "output", "int8_spread")
    os.makedirs(work, exist_ok=True)
    tcfg = get_cfg()
    tcfg.merge_from_file(recipe)
    tcfg.merge_from_list(CANARY_OPTS + ["OUTPUT_DIR", work])
    jcfg = load_config(recipe, freeze=False)
    jcfg.merge_from_list(CANARY_OPTS + ["OUTPUT_DIR", work])
    register_all_datasets(tcfg)
    jax_register(jcfg)
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    model.eval()
    jmodel = jax_build_model(jcfg)
    (name,) = tcfg.DATASETS.TEST
    scales_path = os.path.join(work, "int8_scales.json")
    Q.save_act_scales(scales_path, calibrate(tcfg, model, get_dataset(name, tcfg), CALIB_BATCHES,
                                             MIN_CHANNELS))
    modes = {"float32": {}, "int8_dynamic": {"EVAL_INT8": True},
             "int8_static": {"EVAL_INT8": True, "EVAL_INT8_SCALES": scales_path}}
    modes = {m: v for m, v in modes.items() if m == "float32" or m in int8_modes}

    def evaluate(pkg, mode, tag, params=None, batch_stats=None, eager=False):
        c = copy.deepcopy(tcfg if pkg == "torch" else jcfg)
        for k, v in modes[mode].items():
            c.TPU[k] = v
        t0 = time.perf_counter()
        where = os.path.join(work, f"{pkg}_{mode}_{tag}")
        if pkg == "torch":
            res = do_test(c, model, where)[name]
        elif eager:
            with jax.disable_jit():
                res = jax_do_test(c, jmodel, params, where, batch_stats=batch_stats)[name]
        else:
            res = jax_do_test(c, jmodel, params, where, batch_stats=batch_stats)[name]
        print(json.dumps({"package": pkg, "mode": mode, "run": tag, "mAP": float(res["mAP"]),
                          "s": round(time.perf_counter() - t0, 1)}), flush=True)
        return float(res["mAP"])

    params, batch_stats = params_to_flax(model)
    jax_programs = {} if drift_only else {
        how: {mode: evaluate("jax", mode, how, params, batch_stats or None,
                             eager=how == "eager") for mode in modes}
        for how in ("eager", "jit")}
    drift = {}
    for seed in seeds:
        g = torch.Generator().manual_seed(seed)
        model.load_state_dict({k: (v.double() * (1 + eps * torch.randn(
            v.shape, generator=g, dtype=torch.float64))).to(v.dtype)
            if v.is_floating_point() else v for k, v in sd.items()}, strict=True)
        model.eval()
        params, batch_stats = params_to_flax(model)
        drift[str(seed)] = {pkg: {mode: evaluate(pkg, mode, f"drift{seed}", params,
                                                 batch_stats or None) for mode in modes}
                            for pkg in ("torch", "jax")}

    int8 = [m for m in modes if m != "float32"]

    def drops(maps):
        return {m: maps["float32"] - maps[m] for m in int8}

    ranges = {pkg: {m: [min(drops(d[pkg])[m] for d in drift.values()),
                        max(drops(d[pkg])[m] for d in drift.values())]
                    for m in int8} for pkg in ("torch", "jax")}
    result = {"checkpoint_sha256": digest, "checkpoint_step": step, "calibration_batches":
              CALIB_BATCHES, "jax_programs": jax_programs,
              "jax_eager_minus_jit": {m: jax_programs["eager"][m] - jax_programs["jit"][m]
                                      for m in modes} if jax_programs else {},
              "drift_eps": eps, "drift": drift, "drift_drop_ranges": ranges}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


def ulps(got: np.ndarray, want: np.ndarray) -> dict:
    """max |got - want| in float32 spacings at max |want|, with the count of
    elements that differ."""
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    top = float(np.abs(want).max()) if want.size else 0.0
    spacing = float(np.spacing(np.float32(top))) if top > 0 else float(np.spacing(np.float32(1)))
    return {"max_abs": float(d.max()) if d.size else 0.0, "ulps": float(d.max() / spacing)
            if d.size else 0.0, "differ": int((d > 0).sum()), "of": int(d.size),
            "max_out": top}


def parting(weight_paths, out: str, n_scenes: int = 32, opts=()) -> dict:
    """Dynamic int8, scene by scene: where the packages part, and each
    module's own disagreement on the other package's input (module
    docstring)."""
    import jax.numpy as jnp
    import flax.linen as fnn

    from dafne_tpu.config import load_config
    from dafne_tpu.data.registry import register_all_datasets as jax_register
    from dafne_tpu.layers import quant as JQ
    from dafne_tpu.models import build_model as jax_build_model

    from dafne_torch.config import get_cfg
    from dafne_torch.data import get_dataset, register_all_datasets
    from dafne_torch.engine.inference import make_eval_step
    from dafne_torch.layers import quant as Q
    from dafne_torch.models import build_model
    from dafne_torch.models.layers import FrozenBN
    from dafne_torch.utils.weights import params_to_flax

    sd, digest, step = join(weight_paths)
    recipe = os.path.join(ROOT, "configs", "synthetic", "base.yaml")
    tcfg = get_cfg()
    tcfg.merge_from_file(recipe)
    tcfg.merge_from_list(CANARY_OPTS + list(opts) + ["TPU.EVAL_INT8", "True"])
    jcfg = load_config(recipe, freeze=False)
    jcfg.merge_from_list(CANARY_OPTS + list(opts) + ["TPU.EVAL_INT8", "True"])
    register_all_datasets(tcfg)
    jax_register(jcfg)
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    model.eval()
    params, batch_stats = params_to_flax(model)
    variables = {"params": params, **({"batch_stats": batch_stats} if batch_stats else {})}
    jmodel = jax_build_model(jcfg)
    (name,) = tcfg.DATASETS.TEST
    records = get_dataset(name, tcfg)[:n_scenes]
    hw = tuple(records[0]["image"].shape[:2])
    qmodel = make_eval_step(model, tcfg, hw).program.model
    modules = dict(qmodel.named_modules())
    kinds = (torch.nn.Conv2d, torch.nn.GroupNorm, FrozenBN, Q.Int8Conv2d)
    checked = {n for n, m in modules.items() if isinstance(m, kinds)}

    scenes, per_module = [], {}
    for i, rec in enumerate(records):
        image = np.ascontiguousarray(rec["image"][None].astype(np.float32))
        # the port, free-running: each int8 site's input, and which module produced it
        producer, sites_t = {}, {}

        def record_output(mod_name):
            def hook(mod, args, output):
                if isinstance(output, torch.Tensor):
                    producer[id(output)] = mod_name
            return hook

        def record_site(mod_name):
            def pre(mod, args):
                sites_t.setdefault(Q.module_site(mod_name), (
                    args[0].float().permute(0, 2, 3, 1).numpy().copy(),
                    producer.get(id(args[0]), "?")))
            return pre

        hooks = [m.register_forward_hook(record_output(n)) for n, m in modules.items() if n]
        hooks += [m.register_forward_pre_hook(record_site(n)) for n, m in modules.items()
                  if isinstance(m, Q.Int8Conv2d)]
        with torch.inference_mode():
            qmodel(torch.from_numpy(image))
        for h in hooks:
            h.remove()
        # JAX, free-running (eager): every module call's first input and output
        calls, order = {}, []

        def recorder(next_fun, args, kwargs, context):
            y = next_fun(*args, **kwargs)
            path = "/".join(context.module.path or ())
            if (context.method_name == "__call__" and args and path not in calls
                    and hasattr(args[0], "shape") and hasattr(y, "shape")):
                calls[path] = (np.asarray(args[0], np.float32), np.asarray(y, np.float32))
            return y

        real = JQ._quantized_call

        def site_order(next_fun, args, kwargs, mod, x, act_amax=None):
            order.append(JQ.module_site(mod))
            return real(next_fun, args, kwargs, mod, x, act_amax)

        JQ._quantized_call = site_order
        try:
            with fnn.intercept_methods(recorder):
                with JQ.quantized_eval_scope(
                        enabled=True, min_channels=int(jcfg.TPU.EVAL_INT8_MIN_CHANNELS)):
                    jmodel.apply(variables, jnp.asarray(image))
        finally:
            JQ._quantized_call = real
        # the first site whose quantized input differs
        first = None
        for site in order:
            x_t, prod = sites_t[site]
            x_j = calls[site][0]
            q_t = np.asarray(JQ.quantize_tensor_dynamic(jnp.asarray(x_t))[0])
            q_j = np.asarray(JQ.quantize_tensor_dynamic(jnp.asarray(x_j))[0])
            flipped = int((q_t != q_j).sum())
            if flipped:
                first = {"site": site, "flipped": flipped, "values": int(q_t.size),
                         "input": ulps(x_t, x_j), "producer": prod,
                         "sites_before": order.index(site)}
                break
        # every module on the other package's input
        own = {}
        with torch.inference_mode():
            for n in sorted(checked):
                path = n.replace(".", "/")
                if path not in calls:
                    continue
                x_j, y_j = calls[path]
                y_t = modules[n](torch.from_numpy(np.ascontiguousarray(
                    x_j.transpose(0, 3, 1, 2)))).float().permute(0, 2, 3, 1).numpy()
                own[n] = ulps(y_t, y_j)
                worst = per_module.setdefault(n, {"type": type(modules[n]).__name__,
                                                  "ulps": 0.0, "max_abs": 0.0})
                worst["ulps"] = max(worst["ulps"], own[n]["ulps"])
                worst["max_abs"] = max(worst["max_abs"], own[n]["max_abs"])
        if first is not None:  # the producer (a block, say) alone on JAX's input, and its parts
            prod = first["producer"]
            path = prod.replace(".", "/")
            if prod in own:
                first["producer_on_jax_input"] = own[prod]
            elif path in calls:
                with torch.inference_mode():
                    y_t = modules[prod](torch.from_numpy(np.ascontiguousarray(
                        calls[path][0].transpose(0, 3, 1, 2)))).float().permute(0, 2, 3, 1)
                first["producer_on_jax_input"] = ulps(y_t.numpy(), calls[path][1])
            first["producer_parts_on_jax_input"] = {
                n: own[n] for n in own if n.startswith(prod + ".")}
        scene = {"scene": i, "image_id": rec.get("image_id"), "first_parting": first,
                 "sites": len(order),
                 "int8_sites_bit_equal_on_jax_input": all(
                     own[n]["differ"] == 0 for n in own if isinstance(modules[n], Q.Int8Conv2d))}
        scenes.append(scene)
        print(json.dumps(scene), flush=True)

    by_type = {}
    for n, w in per_module.items():
        t = by_type.setdefault(w["type"], {"modules": 0, "max_ulps": 0.0, "worst": None})
        t["modules"] += 1
        if w["ulps"] >= t["max_ulps"]:
            t["max_ulps"], t["worst"] = w["ulps"], n
    result = {"checkpoint_sha256": digest, "checkpoint_step": step, "mode": "int8_dynamic",
              "compute_dtype": tcfg.TPU.COMPUTE_DTYPE, "scenes": scenes,
              "parting_sites": sorted({(s["first_parting"] or {}).get("site") or "none"
                                       for s in scenes}),
              "module_ulps_by_type": by_type, "module_ulps": per_module}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k not in ("scenes", "module_ulps")}),
          flush=True)
    return result


def gn_rounding(weight_paths, n_scenes: int = 2) -> dict:
    """Each head GroupNorm against float64 on the port's inputs to it
    (module docstring): {module: port ulps, JAX ulps, port - JAX ulps,
    largest |mean| / std of a group}, and the worst of each."""
    import jax
    import jax.numpy as jnp
    import flax.linen as fnn

    from dafne_torch.config import get_cfg
    from dafne_torch.data import get_dataset, register_all_datasets
    from dafne_torch.models import build_model

    sd, digest, step = join(weight_paths)
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic", "base.yaml"))
    cfg.merge_from_list(CANARY_OPTS)
    register_all_datasets(cfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    model.eval()
    (name,) = cfg.DATASETS.TEST
    images = np.stack([r["image"] for r in get_dataset(name, cfg)[:n_scenes]]).astype(np.float32)
    inputs = {}

    def record(mod_name):
        def pre(mod, args):
            inputs.setdefault(mod_name, args[0].detach().float().clone())
        return pre

    hooks = [m.register_forward_pre_hook(record(n)) for n, m in model.named_modules()
             if isinstance(m, torch.nn.GroupNorm)]
    with torch.inference_mode():
        model(torch.from_numpy(images))
    for h in hooks:
        h.remove()
    rows = {}
    for n, x in inputs.items():
        m = model.get_submodule(n)
        g = x.double().reshape(x.shape[0], m.num_groups, -1)
        mu = g.mean(-1, keepdim=True)
        y64 = ((g - mu) / torch.sqrt(((g - mu) ** 2).mean(-1, keepdim=True) + m.eps)).reshape(
            x.shape) * m.weight.double()[None, :, None, None] + m.bias.double()[None, :, None, None]
        with torch.inference_mode():
            y_t = m(x).double()
        flax_gn = fnn.GroupNorm(num_groups=m.num_groups, epsilon=m.eps)
        v = {"params": {"scale": jnp.asarray(m.weight.detach().numpy()),
                        "bias": jnp.asarray(m.bias.detach().numpy())}}
        y_j = torch.from_numpy(np.asarray(jax.jit(flax_gn.apply)(
            v, jnp.asarray(x.permute(0, 2, 3, 1).numpy())))).permute(0, 3, 1, 2).double()
        spacing = float(np.spacing(np.float32(y64.abs().max().item())))
        rows[n] = {"port_ulps": float((y_t - y64).abs().max()) / spacing,
                   "jax_ulps": float((y_j - y64).abs().max()) / spacing,
                   "port_minus_jax_ulps": float((y_t - y_j).abs().max()) / spacing,
                   "max_mean_over_std": float((g.mean(-1).abs() / g.std(-1)).max())}
    result = {"checkpoint_sha256": digest, "scenes": n_scenes, "modules": rows,
              "worst": {k: max(r[k] for r in rows.values()) for k in next(iter(rows.values()))}}
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("split")
    s.add_argument("--checkpoint-dir", required=True)
    s.add_argument("--part", type=int, required=True)
    s.add_argument("--parts", type=int, default=3)
    s.add_argument("--out", required=True)
    q = sub.add_parser("probe")
    q.add_argument("--weights", nargs="+", required=True)
    q.add_argument("--out", default=os.path.join(ROOT, "output", "int8_probe.json"))
    q.add_argument("--tta", action="store_true",
                   help="also both packages' TTA (the TTA canary's ladder) on the weights")
    q.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                   help="KEY VALUE overrides of both packages' configs (a rehearsal at a "
                   "narrow width)")
    r = sub.add_parser("spread")
    r.add_argument("--weights", nargs="+", required=True)
    r.add_argument("--seeds", default="0,1,2,3", help="the drifted weights' generator seeds")
    r.add_argument("--eps", type=float, default=DRIFT_EPS)
    r.add_argument("--out", default=os.path.join(ROOT, "output", "int8_spread.json"))
    r.add_argument("--modes", default="int8_dynamic,int8_static",
                   help="the int8 modes evaluated beside float32")
    r.add_argument("--drift-only", action="store_true",
                   help="only the drifted weights (no JAX eager against jitted)")
    t = sub.add_parser("parting")
    t.add_argument("--weights", nargs="+", required=True)
    t.add_argument("--scenes", type=int, default=32, help="the first N of the 32 scenes")
    t.add_argument("--out", default=os.path.join(ROOT, "output", "int8_parting.json"))
    t.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                   help="KEY VALUE overrides of both packages' configs (a rehearsal at a "
                   "narrow width)")
    u = sub.add_parser("gn")
    u.add_argument("--weights", nargs="+", required=True)
    u.add_argument("--scenes", type=int, default=2)
    a = p.parse_args(argv)
    if a.cmd == "split":
        split(a.checkpoint_dir, a.part, a.parts, a.out)
    elif a.cmd == "spread":
        spread(a.weights, a.out, [int(x) for x in a.seeds.split(",")], a.eps,
               a.modes.split(","), a.drift_only)
    elif a.cmd == "gn":
        gn_rounding(a.weights, a.scenes)
    elif a.cmd == "parting":
        parting(a.weights, a.out, a.scenes, a.opts)
    else:
        probe(a.weights, a.out, a.opts, a.tta)
    return 0


if __name__ == "__main__":
    sys.exit(main())
