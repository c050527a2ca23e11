"""Port's train step vs the JAX package's ``make_train_step``, in float32.

The narrow R-50 detector (``tests/test_torch_model.py``), batch 2 at 128^2,
the same weights (flax tree drawn with numpy, converted with
``params_from_flax``), gts mapped from synthetic records by the port's
mapper and handed to both.  The JAX step takes the port's targets through
its host-assignment branch (``tgt_*`` batch keys), so both steps see the
same targets: on the CPU, XLA may contract the in-quad test's products
into FMAs and flip a location on the quad's boundary, which the port's
plain arithmetic does not (``tests/test_torch_targets.py`` holds the
assignment itself to JAX).  Loss terms and num_pos at rtol 1e-4 (two
frameworks' convolutions and reductions round differently); parameters
after one and two SGD steps within atol 1e-5.
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

from tests.test_torch_model import narrow_cfgs, port_model_from, random_flax_params

torch.set_num_threads(2)

HW = (128, 128)
TRAIN = ["SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_ITERS", "0", "TPU.MAX_INSTANCES", "16",
         "INPUT.MIN_SIZE_TRAIN", "(128,)", "INPUT.MAX_SIZE_TRAIN", "128",
         "MODEL.DAFNE.LOSS_LAMBDA.CLS", "10.0"]


def mapped_batch(cfg, seed=0):
    mapper = DatasetMapper(cfg, HW)
    recs = load_synthetic_gen("train", 2, hw=128, max_boxes=12)
    ex = [mapper(r, np.random.RandomState(seed + i)) for i, r in enumerate(recs)]
    batch = {k: np.stack([e[k] for e in ex]) for k in ("image",) + GT_KEYS}
    batch["image"] = batch["image"].astype(np.float32)
    return batch


def test_train_steps_match_jax():
    jcfg, tcfg = narrow_cfgs(TRAIN)
    jmodel = jax_build_model(jcfg)
    params = random_flax_params(jmodel, seed=11)
    batch = mapped_batch(tcfg)

    tx, sched = jax_build_optimizer(jcfg, params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       opt_state=tx.init(jparams), tx=tx)
    jstep = jax.jit(jax_make_train_step(jmodel, jcfg, HW, tx, sched))

    model = port_model_from(params, tcfg)
    optimizer, scheduler = build_optimizer(tcfg, model)
    step = make_train_step(model, tcfg, HW, optimizer, scheduler)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    spec = AssignmentSpec.from_config(tcfg)
    targets = batch_targets(tbatch, spec, make_location_tables(HW, spec))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch.update({f"tgt_{k}": jnp.asarray(targets[k].numpy())
                   for k in ("labels", "reg_corners", "reg_abcd")})

    for it in range(2):
        state, want = jstep(state, jbatch)
        got = step(tbatch)
        assert set(want) == set(got), (set(want), set(got))
        assert float(want["num_pos"]) > 10
        for key in want:
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4,
                                       err_msg=f"step {it} {key}")
        ref = params_from_flax(jax.tree_util.tree_map(np.asarray, state.params))
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"step {it} {name}")
    # the step moved the trainable parameters and left the frozen ones
    start = params_from_flax(params)
    sd = model.state_dict()
    assert not torch.equal(sd["head.cls_logits.bias"], start["head.cls_logits.bias"])
    assert torch.equal(sd["backbone.stem_conv1.weight"], start["backbone.stem_conv1.weight"])


def test_unported_train_options_raise():
    _, tcfg = narrow_cfgs(TRAIN)
    model = port_model_from(random_flax_params(jax_build_model(narrow_cfgs()[0]), 0), tcfg)
    optimizer, scheduler = build_optimizer(tcfg, model)
    _, bad = narrow_cfgs(TRAIN + ["TPU.HOST_ASSIGN", "True"])
    with pytest.raises(NotImplementedError):
        make_train_step(model, bad, HW, optimizer, scheduler)
