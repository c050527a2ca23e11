"""Default keys the port reads, with the JAX package's names and values.

Only the inference slice's keys live here (model, head, test-time input,
decode budgets); ``tests/test_torch_config.py`` holds every value equal to
the JAX package's default of the same name.
"""

from __future__ import annotations

from dafne_torch.config.config import CfgNode


def build_defaults() -> CfgNode:
    _C = CfgNode()

    _C.MODEL = CfgNode()
    _C.MODEL.META_ARCHITECTURE = "OneStageDetector"
    _C.MODEL.PIXEL_MEAN = [123.675, 116.28, 103.53]
    _C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]

    _C.MODEL.BACKBONE = CfgNode()
    _C.MODEL.BACKBONE.NAME = "build_dafne_resnet_fpn_backbone"
    _C.MODEL.BACKBONE.ANTI_ALIAS = False

    _C.MODEL.RESNETS = CfgNode()
    _C.MODEL.RESNETS.DEPTH = 50
    _C.MODEL.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]
    _C.MODEL.RESNETS.NUM_GROUPS = 1
    _C.MODEL.RESNETS.NORM = "FrozenBN"
    _C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
    _C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
    _C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
    _C.MODEL.RESNETS.STRIDE_IN_1X1 = True
    _C.MODEL.RESNETS.RES5_DILATION = 1

    _C.MODEL.FPN = CfgNode()
    _C.MODEL.FPN.IN_FEATURES = ["res3", "res4", "res5"]
    _C.MODEL.FPN.OUT_CHANNELS = 256
    _C.MODEL.FPN.FUSE_TYPE = "sum"

    _C.MODEL.TOP_MODULE = CfgNode()
    _C.MODEL.TOP_MODULE.NAME = ""
    _C.MODEL.TOP_MODULE.DIM = 16

    d = _C.MODEL.DAFNE = CfgNode()
    d.NUM_CLASSES = 15
    d.IN_FEATURES = ["p3", "p4", "p5", "p6", "p7"]
    d.FPN_STRIDES = [8, 16, 32, 64, 128]
    d.PRIOR_PROB = 0.01
    d.INFERENCE_TH_TEST = 0.05
    d.NMS_TH = 0.1
    d.PRE_NMS_TOPK_TEST = 2000
    d.POST_NMS_TOPK_TEST = 1000
    d.TOP_LEVELS = 2
    d.NORM = "GN"
    d.USE_SCALE = True
    d.SORT_CORNERS = True
    d.CENTERNESS = "oriented"  # "none" | "plain" | "oriented"
    d.CENTERNESS_USE_IN_SCORE = True
    d.CORNER_PREDICTION = "center-to-corner"
    d.CORNER_TOWER_ON_CENTER_TOWER = True
    d.MERGE_CORNER_CENTER_PRED = False
    d.ENABLE_FPN_STRIDE_NORM = True
    d.THRESH_WITH_CTR = False
    d.CTR_ON_REG = True
    d.USE_RELU = True
    d.USE_DEFORMABLE = False
    d.NUM_CLS_CONVS = 4
    d.NUM_BOX_CONVS = 4
    d.NUM_SHARE_CONVS = 0

    _C.INPUT = CfgNode()
    _C.INPUT.MAX_SIZE_TEST = 1333
    _C.INPUT.RESIZE_TYPE = "shortest-edge"
    _C.INPUT.RESIZE_HEIGHT_TEST = 0
    _C.INPUT.RESIZE_WIDTH_TEST = 0

    # key names kept from the JAX package's TPU namespace so recipes merge
    t = _C.TPU = CfgNode()
    t.COMPUTE_DTYPE = "bfloat16"  # model compute dtype; params stay float32
    t.NMS_GROUP_CANDIDATES = 0  # >0 (per-class-group NMS) is not ported yet
    t.NMS_MAX_CANDIDATES = 4096  # static NMS input size (global score cap)
    t.IMAGE_SIZE_DIVISIBILITY = 128

    return _C
