"""Port's train step vs the JAX package's on the deformable model, float32.

The narrow R-50 of ``tests/test_torch_model.py`` as
``build_resnet_interval_backbone`` at DEFORM_INTERVAL 3 (deformable 3x3s in
res3_0, res3_3, res4_0, res4_3 and res5_0) with deformable head towers of
2 convs (MODEL.DAFNE.USE_DEFORMABLE), batch 2 at 128^2: the forward
outputs in eval mode, then one train step from the same weights on the
same batch (the port's targets handed to JAX's host-assignment branch), as
``tests/test_torch_train_options.py`` does.  Weights as
``tests/torch_backbone_cases.py`` draws them (offsets of about a pixel),
pixels scaled by torchvision's std.  Tolerances: the outputs at
``torch_backbone_cases.assert_close``'s, the losses and num_pos at rtol
1e-4, the parameters after the step within atol 1e-5 (the first step of
``test_torch_train_options.py``).  At DEFORM_INTERVAL 1 with 4-conv
towers on raw pixels the trunk's offset convs take updates of ~1e2 whose
float32 sums (large cancelling terms) differ by ~1% between the two
frameworks, and each side's forward is ~6e-4 of the output's scale from
float64: chaos of the random weights, not a fault of either side.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from dafne_tpu.engine.optimizer import build_optimizer as jax_build_optimizer
from dafne_tpu.engine.trainer import TrainState
from dafne_tpu.engine.trainer import make_train_step as jax_make_train_step
from dafne_tpu.models import build_model as jax_build_model

from dafne_torch.data.loader import GT_KEYS
from dafne_torch.data.mapper import DatasetMapper
from dafne_torch.data.synthetic import load_synthetic_gen
from dafne_torch.engine.optimizer import build_optimizer
from dafne_torch.engine.trainer import batch_targets, make_location_tables, make_train_step
from dafne_torch.layers.deform_conv import DeformConv2d
from dafne_torch.models import build_model
from dafne_torch.ops.targets import AssignmentSpec
from dafne_torch.utils.weights import params_from_flax

from tests.test_torch_model import narrow_cfgs
from tests.torch_backbone_cases import assert_close, draw_params

torch.set_num_threads(2)

HW = (128, 128)
# test_torch_train_options.py's settings at 128^2, and pixels scaled to
# ~unit size (torchvision's std): trunk activations ~10 rather than ~1e3,
# so the trunk's offset gradients are not ~1e4 times larger than the rest
TRAIN = ["SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_ITERS", "0", "TPU.MAX_INSTANCES", "16",
         "INPUT.MIN_SIZE_TRAIN", "(128,)", "INPUT.MAX_SIZE_TRAIN", "128",
         "MODEL.DAFNE.LOSS_LAMBDA.CLS", "10.0", "MODEL.PIXEL_STD", "[58.395, 57.12, 57.375]"]
DEFORMABLE = ["MODEL.BACKBONE.NAME", "build_resnet_interval_backbone",
              "MODEL.RESNETS.DEFORM_INTERVAL", "3", "MODEL.DAFNE.USE_DEFORMABLE", "True",
              "MODEL.DAFNE.NUM_CLS_CONVS", "2", "MODEL.DAFNE.NUM_BOX_CONVS", "2"]


def mapped_batch(cfg):
    mapper = DatasetMapper(cfg, HW)
    recs = load_synthetic_gen("train", 2, hw=HW[0], max_boxes=12)
    ex = [mapper(r, np.random.RandomState(i)) for i, r in enumerate(recs)]
    batch = {k: np.stack([e[k] for e in ex]) for k in ("image",) + GT_KEYS}
    batch["image"] = batch["image"].astype(np.float32)
    return batch


def test_deformable_model_forward_and_train_step_match_jax():
    jcfg, tcfg = narrow_cfgs(TRAIN + DEFORMABLE)
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1,) + HW + (3,)))
    params = draw_params(dict(shapes["params"]), seed=15, trunk_offset_std=1e-3)
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(params), strict=True)
    n_deform = sum(isinstance(m, DeformConv2d) for m in model.modules())
    assert n_deform == 5 + 3  # res3_0, res3_3, res4_0, res4_3, res5_0 and three towers
    batch = mapped_batch(tcfg)

    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(batch["image"]))
    with torch.no_grad():
        got = model(torch.from_numpy(batch["image"]))
    for key in ("logits", "corners", "center", "ctrness"):
        assert_close(got[key], want[key], key)

    tx, sched = jax_build_optimizer(jcfg, params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       opt_state=tx.init(jparams), tx=tx, batch_stats=None)
    jstep = jax.jit(jax_make_train_step(jmodel, jcfg, HW, tx, sched))
    optimizer, scheduler = build_optimizer(tcfg, model)
    step = make_train_step(model, tcfg, HW, optimizer, scheduler)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    spec = AssignmentSpec.from_config(tcfg)
    targets = batch_targets(tbatch, spec, make_location_tables(HW, spec))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch.update({f"tgt_{k}": jnp.asarray(targets[k].numpy())
                   for k in ("labels", "reg_corners", "reg_abcd")})
    start = {k: v.clone() for k, v in model.state_dict().items()}

    state, want = jstep(state, jbatch)
    got = step(tbatch)
    assert set(want) == set(got)
    assert float(want["num_pos"]) > 10
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, err_msg=key)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, state.params))
    sd = model.state_dict()
    assert set(sd) == set(ref)
    for name, p in sd.items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    for name in ("backbone.res3_0.conv2.offset_conv.weight", "backbone.res5_0.conv2.weight.weight",
                 "head.cls_tower.conv1.offset_conv.bias", "head.corners_tower.conv1.weight.weight"):
        assert not torch.equal(sd[name], start[name]), name
