"""Several processes in the port (``dafne_torch/parallel/``), on the CPU.

The environment contract, the batch slice and the mesh checks; the
loader's process slices (the mirror of ``tests/test_multiprocess.py:21-79``:
host path, device aug and buckets; global eval metadata); and the train
step of a 2-process gloo group at global batch 4, each process on its 2
rows (``tests/torch_parallel_worker.py``), against the port's one-process
step and JAX's single-device train step on the same batch and weights
(``utils/weights.py::params_from_flax``), for a GN and a BN head: 3 steps,
the losses and num_pos at rtol 1e-4, the parameters within
``tests/test_torch_train_options.py``'s ``PARAM_ATOL`` of the one
process's (the two processes' gradients are float32 sums in another order,
their BN statistics sums over the global count where one process takes
means) and of JAX's plus the one process's own distance from JAX (the BN
head here: 1.2e-5 after the first step, as the CPU convolutions of the two
frameworks round; the GN head's is below 1e-6), BN running statistics
likewise at ``test_torch_model.py``'s tolerance; both
processes hold the same parameters bit for bit.  The narrow R-50 of
``tests/test_torch_model.py`` at 192^2 (P7 2 x 2: a BN level's statistics
come from 16 values of the global batch, 8 of each process's).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dafne_tpu.engine.optimizer import build_optimizer as jax_build_optimizer
from dafne_tpu.engine.trainer import TrainState
from dafne_tpu.engine.trainer import make_train_step as jax_make_train_step
from dafne_tpu.models import build_model as jax_build_model

from dafne_torch.config import get_cfg
from dafne_torch.data.loader import GT_KEYS, DataLoader
from dafne_torch.data.mapper import DatasetMapper, train_canvas_buckets
from dafne_torch.data.synthetic import load_synthetic_gen
from dafne_torch.engine.optimizer import build_optimizer
from dafne_torch.engine.trainer import batch_targets, make_location_tables, make_train_step
from dafne_torch.ops.targets import AssignmentSpec
from dafne_torch.parallel import distributed as dist
from dafne_torch.parallel.mesh import create_mesh, mesh_from_config
from dafne_torch.utils.weights import params_from_flax

from tests.test_torch_head_options import port_model, random_variables
from tests.test_torch_model import NARROW, _assert_close, narrow_cfgs
from tests.test_torch_train_options import PARAM_ATOL

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
HW = (192, 192)
TRAIN = ["SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_ITERS", "0", "TPU.MAX_INSTANCES", "16",
         "INPUT.MIN_SIZE_TRAIN", "(192,)", "INPUT.MAX_SIZE_TRAIN", "192",
         "MODEL.DAFNE.LOSS_LAMBDA.CLS", "10.0"]
HEADS = {"gn": [], "bn": ["MODEL.DAFNE.NORM", "BN"]}
GROUP_TIMEOUT_S = 180  # a process that waits on a missing peer fails the test


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def cluster_env(coordinator, world, rank, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DAFNE_") and k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(DAFNE_COORDINATOR=coordinator, DAFNE_NUM_PROCESSES=str(world),
               DAFNE_PROCESS_ID=str(rank), PYTHONPATH=ROOT, **extra)
    return env


def run_group(cmds_env, timeout=GROUP_TIMEOUT_S):
    """Start every (command, env) at once and wait for all, each within
    `timeout`; kills the rest when one times out.  Returns [(rc, output)]."""
    procs = [subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for cmd, env in cmds_env]
    out = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=timeout)
            out.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


# ---- contract, slice and mesh ------------------------------------------------

def test_no_cluster_asked_returns_false():
    assert dist.maybe_initialize_distributed(env={}) is False
    assert dist.maybe_initialize_distributed(env={"DAFNE_CPU_COLLECTIVES": "gloo"}) is False
    assert (dist.process_index(), dist.process_count(), dist.is_main_process()) == (0, 1, True)


def test_local_batch_slice_and_device():
    assert dist.local_batch_slice(8) == (0, 8)
    assert dist.local_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            dist.local_device("cuda")
    t = torch.arange(3.0)
    assert dist.all_reduce_sum(t) is t  # one process: no collective, the same tensor
    assert dist.gather_to_main({"a": np.ones(2)})["a"].shape == (2,)


def test_mesh_checks():
    assert create_mesh([-1], ["data"], world_size=4) == {"data": 4}
    assert create_mesh([2], ["data"], world_size=2) == {"data": 2}
    assert mesh_from_config(get_cfg(), world_size=3) == {"data": 3}
    assert mesh_from_config(get_cfg()) == {"data": 1}
    with pytest.raises(ValueError, match="world size"):
        create_mesh([2], ["data"], world_size=4)
    with pytest.raises(NotImplementedError, match="image_sharding"):
        create_mesh([-1, 2], ["data", "spatial"], world_size=4)
    with pytest.raises(ValueError, match="only the 'data'"):
        create_mesh([-1], ["model"], world_size=2)


def test_card_asked_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    env = {"DAFNE_COORDINATOR": f"localhost:{free_port()}", "DAFNE_NUM_PROCESSES": "1",
           "DAFNE_PROCESS_ID": "0"}
    with pytest.raises(RuntimeError, match="no GPU"):
        dist.maybe_initialize_distributed(env=env, device="cuda")
    with pytest.raises(ValueError, match="NCCL"):
        dist.maybe_initialize_distributed(env={**env, "DAFNE_CPU_COLLECTIVES": "nccl"},
                                          device="cpu")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        dist.maybe_initialize_distributed(env={"DAFNE_DISTRIBUTED": "auto"}, device="cpu")


def test_unreachable_coordinator_raises():
    """Process 1 of 2 with nobody at the coordinator's port raises within
    its timeout, in a process of its own."""
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from dafne_torch.parallel import distributed as dist\n"
            "try:\n"
            "    dist.maybe_initialize_distributed(device='cpu')\n"
            "except Exception as e:\n"
            "    print('raised', type(e).__name__); sys.exit(3)\n"
            "print('formed'); sys.exit(0)\n")
    env = cluster_env(f"localhost:{free_port()}", 2, 1, DAFNE_DIST_TIMEOUT_S="3")
    (rc, out), = run_group([([sys.executable, "-c", code], env)], timeout=90)
    assert rc == 3 and "raised" in out, out


# ---- the loader's process slices ---------------------------------------------

def loader_cfg(extra=()):
    cfg = get_cfg()
    cfg.merge_from_list(["DATALOADER.NUM_WORKERS", "0", "INPUT.MIN_SIZE_TRAIN", "(128,)",
                         "INPUT.MAX_SIZE_TRAIN", "128", "TPU.MAX_INSTANCES", "16",
                         "TPU.TRAIN_DEVICE_AUG", "False"] + list(extra))
    return cfg


LOADER_CASES = {
    "host": [],
    "device_aug": ["TPU.TRAIN_DEVICE_AUG", "True", "INPUT.USE_COLOR_AUGMENTATIONS", "True"],
    "buckets": ["INPUT.MIN_SIZE_TRAIN", "(96, 128, 160)", "INPUT.MAX_SIZE_TRAIN", "160"],
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_process_slices_partition_global_batch(case):
    cfg = loader_cfg(LOADER_CASES[case])
    records = load_synthetic_gen("train", 6, hw=128, max_boxes=8)
    buckets = train_canvas_buckets(cfg, records)
    assert (buckets is not None) == (case == "buckets")

    def batches(pi, pc, n=3):
        dl = DataLoader(cfg, records, 4, seed=3, pad_hw=(128, 128), device_aug=case == "device_aug",
                        buckets=buckets, process_index=pi, process_count=pc)
        it = iter(dl)
        out = [next(it) for _ in range(n)]
        it.close()
        return out

    whole, left, right = batches(0, 1), batches(0, 2), batches(1, 2)
    for w, a, b in zip(whole, left, right):
        img = "image_base" if case == "device_aug" else "image"
        assert img in w and a[img].shape[0] == b[img].shape[0] == 2
        assert a["image_id"] + b["image_id"] == w["image_id"]
        tensors = [k for k, v in w.items() if isinstance(v, torch.Tensor)]
        assert set(GT_KEYS) <= set(tensors)
        if case == "device_aug":
            assert {"aug_idx0_h", "color_w"} <= set(tensors)
        for k in tensors:
            assert torch.equal(torch.cat([a[k], b[k]]), w[k]), k
    if case == "buckets":
        hws = {tuple(w["image"].shape[1:3]) for w in whole}
        assert len(hws) > 1  # the draw moved the canvas, the same on every process


def test_eval_loader_keeps_global_metadata():
    cfg = loader_cfg()
    records = load_synthetic_gen("val", 5, hw=128, max_boxes=8)
    full = list(DataLoader(cfg, records, 4, pad_hw=(128, 128), train=False))
    batches = list(DataLoader(cfg, records, 4, pad_hw=(128, 128), train=False,
                              process_index=1, process_count=2))
    assert len(batches) == 2
    assert batches[0]["image"].shape[0] == 2  # local rows
    assert batches[0]["image_id"] == full[0]["image_id"] and len(batches[0]["image_id"]) == 4
    assert batches[0]["batch_valid"].shape == (4,)
    assert batches[1]["batch_valid"].sum() == 1  # the 5th image only
    assert torch.equal(batches[0]["image"], full[0]["image"][2:])


# ---- the train step of two processes -----------------------------------------

def global_batch(cfg, n=4):
    mapper = DatasetMapper(cfg, HW)
    recs = load_synthetic_gen("train", n, hw=HW[0], max_boxes=12)
    ex = [mapper(r, np.random.RandomState(i)) for i, r in enumerate(recs)]
    batch = {k: np.stack([e[k] for e in ex]) for k in ("image",) + GT_KEYS}
    batch["image"] = batch["image"].astype(np.float32)
    return batch


@pytest.mark.parametrize("head", sorted(HEADS))
def test_two_process_train_step_matches_one_process_and_jax(head, tmp_path):
    opts = [str(v) for v in NARROW] + TRAIN + HEADS[head]
    jcfg, tcfg = narrow_cfgs(TRAIN + HEADS[head])
    jmodel = jax_build_model(jcfg)
    params, stats = random_variables(jmodel, seed=21)
    batch = global_batch(tcfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    # the two processes, started first: they run while JAX compiles
    model = port_model(params, stats, tcfg)
    job = tmp_path / "job.pt"
    torch.save({"opts": opts, "state": model.state_dict(), "batch": tbatch, "hw": HW,
                "steps": 3}, job)
    coord = f"file://{tmp_path / 'store'}"
    outs = [tmp_path / f"out{r}.pt" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(job), str(outs[r])],
                              env=cluster_env(coord, 2, r), cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]

    # JAX's single-device step at the global batch, on the port's targets
    tx, sched = jax_build_optimizer(jcfg, params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       opt_state=tx.init(jparams), tx=tx,
                       batch_stats=None if stats is None else
                       jax.tree_util.tree_map(jnp.asarray, stats))
    jstep = jax.jit(jax_make_train_step(jmodel, jcfg, HW, tx, sched))
    spec = AssignmentSpec.from_config(tcfg)
    targets = batch_targets(tbatch, spec, make_location_tables(HW, spec))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch.update({f"tgt_{k}": jnp.asarray(targets[k].numpy())
                   for k in ("labels", "reg_corners", "reg_abcd")})
    jax_metrics, jax_states = [], []
    for _ in range(3):
        state, m = jstep(state, jbatch)
        jax_metrics.append({k: float(v) for k, v in m.items()})
        bs = (None if state.batch_stats is None
              else jax.tree_util.tree_map(np.asarray, state.batch_stats))
        jax_states.append(params_from_flax(jax.tree_util.tree_map(np.asarray, state.params), bs))

    # the port's one process at the global batch
    optimizer, scheduler = build_optimizer(tcfg, model)
    step = make_train_step(model, tcfg, HW, optimizer, scheduler)
    one_metrics, one_states = [], []
    for _ in range(3):
        one_metrics.append({k: float(v) for k, v in step(tbatch).items()})
        one_states.append({k: v.clone() for k, v in model.state_dict().items()})

    try:
        texts = [p.communicate(timeout=GROUP_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], texts
    ranks = [torch.load(o, weights_only=False) for o in outs]
    for it in range(3):
        for r in (0, 1):  # every process holds the same state, and the global metrics
            assert ranks[r]["metrics"][it] == ranks[0]["metrics"][it]
            for k, v in ranks[r]["states"][it].items():
                assert torch.equal(v, ranks[0]["states"][it][k]), (it, r, k)
        got, got_state = ranks[0]["metrics"][it], ranks[0]["states"][it]
        assert set(got) == set(one_metrics[it]) == set(jax_metrics[it])
        assert got["num_pos"] > 10
        for k, want in jax_metrics[it].items():
            np.testing.assert_allclose(got[k], want, rtol=1e-4, err_msg=f"step {it} {k} vs JAX")
            np.testing.assert_allclose(got[k], one_metrics[it][k], rtol=1e-4,
                                       err_msg=f"step {it} {k} vs one process")
        assert got["num_pos"] == one_metrics[it]["num_pos"]
        for name, p in got_state.items():
            want, one = jax_states[it][name].numpy(), one_states[it][name].numpy()
            if ".running_" in name and name.startswith("head."):
                _assert_close([p], [one], f"step {it} {name} vs one process")
                atol, rtol = max(1e-4, 5e-5 * float(np.abs(want).max())), 1e-4
            else:
                np.testing.assert_allclose(p.numpy(), one, rtol=0, atol=PARAM_ATOL[it],
                                           err_msg=f"step {it} {name} vs one process")
                atol, rtol = PARAM_ATOL[it], 0
            # no farther from JAX than the one process is, give or take the tolerance
            np.testing.assert_allclose(p.numpy(), want, rtol=rtol,
                                       atol=atol + float(np.abs(one - want).max()),
                                       err_msg=f"step {it} {name} vs JAX")
    running = [k for k in ranks[0]["states"][-1] if k.startswith("head.") and ".running_" in k]
    assert len(running) == (120 if head == "bn" else 0)
