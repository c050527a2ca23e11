"""BN towers' running statistics through the engine, on the CPU.

The narrow float32 R-50 with ``MODEL.DAFNE.NORM BN``: the CLI's train steps
move the running statistics once per step (JAX's ``mutable=
["batch_stats"]`` apply: the NaN check and the metric writes run no second
forward); the checkpoint carries them and ``resume_or_load`` (what
``--eval-only`` calls) restores them;
evaluation (``do_test``), TTA (``do_test_with_tta``) and ``Predictor``
normalize with them (the eval step's detections equal the decode of an
eval-mode forward, and differ once the statistics change) and leave them
as they were.
"""

import numpy as np
import torch

from dafne_torch.config import get_cfg
from dafne_torch.data.registry import DatasetCatalog, MetadataCatalog
from dafne_torch.data.synthetic import GEN_CLASSES, load_synthetic_gen
from dafne_torch.engine.checkpoint import Checkpointer
from dafne_torch.engine.inference import make_eval_step
from dafne_torch.engine.predictor import Predictor
from dafne_torch.engine.train_loop import do_test
from dafne_torch.engine.tta import do_test_with_tta
from dafne_torch.models import build_model
from dafne_torch.models import one_stage_detector as OSD
from dafne_torch.ops.postprocess import DecodeSpec, decode_detections
from dafne_torch.tools.train import main as cli_main

from test_torch_model import NARROW

torch.set_num_threads(2)


def _running(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.startswith("head.") and ".running_" in k}


def _equal(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_bn_running_stats_train_checkpoint_and_eval(tmp_path, monkeypatch):
    name = "torch_bn_gen128"
    recs = load_synthetic_gen("val", 4, hw=128, max_boxes=8)
    DatasetCatalog.register(name, lambda: recs)
    MetadataCatalog[name] = {"evaluator_type": "synthetic", "thing_classes": GEN_CLASSES,
                             "is_test": False}
    args = [str(v) for v in NARROW] + [
        "MODEL.DAFNE.NORM", "BN", "MODEL.DAFNE.NUM_CLASSES", "6", "OUTPUT_DIR", str(tmp_path),
        "DATASETS.TRAIN", f"('{name}',)", "DATASETS.TEST", f"('{name}',)",
        "INPUT.MIN_SIZE_TRAIN", "(128,)", "INPUT.MAX_SIZE_TRAIN", "128",
        "INPUT.MIN_SIZE_TEST", "128", "INPUT.MAX_SIZE_TEST", "128", "SOLVER.IMS_PER_BATCH", "2",
        "SOLVER.MAX_ITER", "3", "TPU.EVAL_BATCH", "2", "TPU.NMS_GROUP_CANDIDATES", "32",
        "TPU.NMS_MAX_CANDIDATES", "128", "MODEL.DAFNE.PRE_NMS_TOPK_TEST", "200",
        "MODEL.DAFNE.POST_NMS_TOPK_TEST", "100", "DATALOADER.NUM_WORKERS", "0",
        "DEBUG.NAN_CHECK", "True", "TEST.AUG.MIN_SIZES", "(128, 256)", "TEST.AUG.MAX_SIZE",
        "256"]
    cfg = get_cfg()
    cfg.merge_from_list(args)

    # one forward per train step, in train mode; none in eval mode meanwhile
    calls = []
    forward = OSD.OneStageDetector.forward

    def counting(self, images, train=False):
        calls.append(train)
        return forward(self, images, train)

    monkeypatch.setattr(OSD.OneStageDetector, "forward", counting)
    cli_main(args + ["DATASETS.TEST", "()"], device="cpu")
    assert calls == [True, True, True]

    trained = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    init = _running(trained)
    assert all(float(v.abs().sum()) == 0 or float((v - 1).abs().sum()) == 0 for v in init.values())
    assert Checkpointer(str(tmp_path)).resume_or_load(trained, cfg, resume=True) == 3
    stats = _running(trained)
    assert len(stats) == 3 * 4 * 5 * 2
    assert all(not torch.equal(stats[k], init[k]) for k in stats)

    # evaluation, TTA and serving normalize with the running statistics
    calls.clear()
    cfg.TEST.AUG.ENABLED = True
    res = do_test(cfg, trained)
    assert "mAP" in res[name]
    do_test_with_tta(cfg, trained)
    images = [r["image"] for r in recs[:2]]
    dets = Predictor(trained, cfg, batch=2).detect(images)
    assert len(dets) == 2
    assert calls and not any(calls)
    assert _equal(_running(trained), stats)

    # class bias -1: scores above the threshold, so detections to compare
    with torch.no_grad():
        trained.head.cls_logits.bias.fill_(-1.0)
    step = make_eval_step(trained, cfg, (128, 128))
    x = torch.from_numpy(np.stack(images).astype(np.float32))
    spec = DecodeSpec.from_config(cfg)
    with torch.no_grad():
        got = step(x)
        want = decode_detections(trained(x, train=False), spec)
        batch_mode = decode_detections(trained(x, train=True), spec)
    assert int(got["valid"].sum()) > 10
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(got["scores"], batch_mode["scores"])
    with torch.no_grad():
        trained.load_state_dict(stats | {k: v + 0.5 for k, v in stats.items()
                                         if k.endswith("running_mean")}, strict=False)
        moved = step(x)
    assert not torch.equal(moved["scores"], got["scores"])
