"""Port's train step vs the JAX package's on the new head options, float32.

As ``tests/test_torch_train_step.py``, for the paper's ablation head
(direct corners, CENTERNESS "none": no center, no centerness), angle
corners and BN towers: the narrow R-50, batch 2 at 192^2 (P7 2 x 2: the
BN statistics of a level come from at least 8 values), the same weights
(and running statistics), the port's targets handed to JAX's
host-assignment branch; three steps.  Each step's losses and num_pos at
rtol 1e-4, the parameters after each step within ``PARAM_ATOL``, and a BN
model's running statistics (~1e4 in size here: the narrow trunk's
activations of raw pixels) after each step against JAX's mutated
``batch_stats`` (one forward, one update per step) at
``test_torch_model.py``'s tolerance, atol max(1e-4, 5e-5 max|want|) and
rtol 1e-4.
"""

import numpy as np
import pytest
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
from dafne_torch.ops.targets import AssignmentSpec
from dafne_torch.utils.weights import params_from_flax

from tests.test_torch_head_options import port_model, random_variables
from tests.test_torch_model import _assert_close, narrow_cfgs

torch.set_num_threads(2)

HW = (192, 192)
TRAIN = ["SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_ITERS", "0", "TPU.MAX_INSTANCES", "16",
         "INPUT.MIN_SIZE_TRAIN", "(192,)", "INPUT.MAX_SIZE_TRAIN", "192",
         "MODEL.DAFNE.LOSS_LAMBDA.CLS", "10.0"]
CASES = {
    "ablation_direct_no_centerness": ["MODEL.DAFNE.CORNER_PREDICTION", "direct",
                                      "MODEL.DAFNE.CENTERNESS", "none"],
    "angle": ["MODEL.DAFNE.CORNER_PREDICTION", "angle"],
    "bn": ["MODEL.DAFNE.NORM", "BN"],
}
# the two frameworks' rounding grows ~10x a step through the trunk: the GN
# model of test_torch_train_step.py at 192^2 reads 2.4e-7, 2.4e-6, 2.4e-5
PARAM_ATOL = (1e-5, 1e-5, 5e-5)
LOSS_KEYS = {
    "ablation_direct_no_centerness": {"loss/cls", "loss/corners"},
    "angle": {"loss/cls", "loss/corners", "loss/ctr"},
    "bn": {"loss/cls", "loss/corners", "loss/ctr", "loss/center"},
}


def mapped_batch(cfg, seed=0):
    mapper = DatasetMapper(cfg, HW)
    recs = load_synthetic_gen("train", 2, hw=HW[0], max_boxes=12)
    ex = [mapper(r, np.random.RandomState(seed + i)) for i, r in enumerate(recs)]
    batch = {k: np.stack([e[k] for e in ex]) for k in ("image",) + GT_KEYS}
    batch["image"] = batch["image"].astype(np.float32)
    return batch


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_train_steps_match_jax(case):
    jcfg, tcfg = narrow_cfgs(TRAIN + CASES[case])
    jmodel = jax_build_model(jcfg)
    params, stats = random_variables(jmodel, seed=12)
    batch = mapped_batch(tcfg)

    tx, sched = jax_build_optimizer(jcfg, params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       opt_state=tx.init(jparams), tx=tx,
                       batch_stats=None if stats is None else
                       jax.tree_util.tree_map(jnp.asarray, stats))
    jstep = jax.jit(jax_make_train_step(jmodel, jcfg, HW, tx, sched))

    model = port_model(params, stats, tcfg)
    optimizer, scheduler = build_optimizer(tcfg, model)
    step = make_train_step(model, tcfg, HW, optimizer, scheduler)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    spec = AssignmentSpec.from_config(tcfg)
    targets = batch_targets(tbatch, spec, make_location_tables(HW, spec))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch.update({f"tgt_{k}": jnp.asarray(targets[k].numpy())
                   for k in ("labels", "reg_corners", "reg_abcd")})

    start = model.state_dict()
    start = {k: v.clone() for k, v in start.items()}
    for it in range(3):
        state, want = jstep(state, jbatch)
        got = step(tbatch)
        assert set(want) == set(got), (set(want), set(got))
        assert {k for k in got if k.startswith("loss/")} == LOSS_KEYS[case] | {"loss/total"}
        assert float(want["num_pos"]) > 10
        for key in want:
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4,
                                       err_msg=f"step {it} {key}")
        stats_now = (None if state.batch_stats is None
                     else jax.tree_util.tree_map(np.asarray, state.batch_stats))
        ref = params_from_flax(jax.tree_util.tree_map(np.asarray, state.params), stats_now)
        sd = model.state_dict()
        assert set(sd) == set(ref)
        for name, p in sd.items():
            if ".running_" in name and name.startswith("head."):
                _assert_close([p], [ref[name].numpy()], f"step {it} {name}")
            else:
                np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=0,
                                           atol=PARAM_ATOL[it], err_msg=f"step {it} {name}")
    sd = model.state_dict()
    assert not torch.equal(sd["head.cls_logits.bias"], start["head.cls_logits.bias"])
    assert torch.equal(sd["backbone.stem_conv1.weight"], start["backbone.stem_conv1.weight"])
    running = [k for k in sd if k.startswith("head.") and ".running_" in k]
    assert len(running) == (120 if case == "bn" else 0)
    assert all(not torch.equal(sd[k], start[k]) for k in running)
