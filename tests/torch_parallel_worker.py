"""One process of a CPU process group running the port's train step.

    python tests/torch_parallel_worker.py JOB OUT

Reads the environment contract of ``dafne_torch/parallel/distributed.py``
(DAFNE_COORDINATOR, DAFNE_NUM_PROCESSES, DAFNE_PROCESS_ID), forms the gloo
group, and from JOB (a ``torch.save`` dict: "opts" config overrides,
"state" the model's state dict, "batch" the global batch as tensors, "hw"
the canvas, "steps") runs "steps" train steps on this process's rows of the
batch.  Writes to OUT {"metrics": [per step {key: float}], "states": [per
step state dict]}.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

torch.set_num_threads(2)  # as the test files: the conv algorithms, and so the rounding, follow it


def main(job_path, out_path):
    from dafne_torch.config import get_cfg
    from dafne_torch.engine.optimizer import build_optimizer
    from dafne_torch.engine.trainer import make_train_step
    from dafne_torch.models import build_model
    from dafne_torch.parallel import distributed as dist

    assert dist.maybe_initialize_distributed(device="cpu")
    try:
        job = torch.load(job_path, weights_only=False)
        cfg = get_cfg()
        cfg.merge_from_list(job["opts"])
        model = build_model(cfg, device="cpu")
        model.load_state_dict(job["state"])
        dist.broadcast_state_(model)
        lo, hi = dist.local_batch_slice(job["batch"]["image"].shape[0])
        batch = {k: v[lo:hi] for k, v in job["batch"].items()}
        optimizer, scheduler = build_optimizer(cfg, model)
        step = make_train_step(model, cfg, tuple(job["hw"]), optimizer, scheduler)
        metrics, states = [], []
        for _ in range(job["steps"]):
            metrics.append({k: float(v) for k, v in step(batch).items()})
            states.append({k: v.clone() for k, v in model.state_dict().items()})
        torch.save({"metrics": metrics, "states": states}, out_path)
    finally:
        dist.destroy()


if __name__ == "__main__":
    main(*sys.argv[1:3])
