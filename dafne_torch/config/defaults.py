"""Default keys the port reads, with the JAX package's names and values.

The keys of inference (model, head, test-time input, decode budgets), of
training (solver, assignment and losses, train-time input and sampler, the
device-side augmentation), of evaluation (datasets, checkpoint weights,
test settings, eval batch), of test-time augmentation and of the datasets
read from disk (input format, the DOTA annotation skips); counterpart of
``dafne_tpu/config/defaults.py``.  ``tests/test_torch_config.py`` holds
every value equal to the JAX package's default of the same name.
"""

from __future__ import annotations

from dafne_torch.config.config import CfgNode


def build_defaults() -> CfgNode:
    _C = CfgNode()
    _C.OUTPUT_DIR = "./output"
    _C.SEED = -1
    _C.EXPERIMENT_NAME = "dafne"  # the run report's "experiment" (utils/notify.py)

    _C.DEBUG = CfgNode()
    _C.DEBUG.OVERFIT_NUM_IMAGES = -1  # truncate datasets to N images (<0: off)
    _C.DEBUG.NAN_CHECK = True  # raise when a written loss is not finite
    _C.DEBUG.PROFILE_ITERS = []  # [start, stop]: a torch.profiler trace of those train steps

    _C.MODEL = CfgNode()
    _C.MODEL.META_ARCHITECTURE = "OneStageDetector"
    _C.MODEL.WEIGHTS = ""  # a port .pth, or a Detectron2 .pth / .pkl, unless a checkpoint resumes
    _C.MODEL.PIXEL_MEAN = [123.675, 116.28, 103.53]
    _C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]

    _C.MODEL.BACKBONE = CfgNode()
    _C.MODEL.BACKBONE.NAME = "build_dafne_resnet_fpn_backbone"
    _C.MODEL.BACKBONE.FREEZE_AT = 2
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
    _C.MODEL.RESNETS.DEFORM_INTERVAL = 1  # build_resnet_interval_backbone

    # the other backbone families' variants
    _C.MODEL.DLA = CfgNode()
    _C.MODEL.DLA.CONV_BODY = "DLA34"
    _C.MODEL.VOVNET = CfgNode()
    _C.MODEL.VOVNET.CONV_BODY = "V-39-eSE"

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
    d.INFERENCE_TH_TRAIN = 0.05
    d.INFERENCE_TH_TEST = 0.05
    d.NMS_TH = 0.1
    d.PRE_NMS_TOPK_TRAIN = 2000
    d.PRE_NMS_TOPK_TEST = 2000
    d.POST_NMS_TOPK_TRAIN = 1000
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
    # target assignment
    d.SIZES_OF_INTEREST = [64, 128, 256, 512]
    d.POS_RADIUS = 2.0
    d.CENTER_SAMPLE = True
    d.CENTER_SAMPLE_ONLY = False
    d.COMBINE_CENTER_SAMPLE = True
    d.ENABLE_IN_BOX_CHECK = True
    d.ENABLE_LEVEL_SIZE_FILTERING = True
    d.SORT_CORNERS_DATALOADER = True
    # losses
    d.LOSS_ALPHA = 0.25
    d.LOSS_GAMMA = 2.0
    d.LOSS_SMOOTH_L1_BETA = 1.0 / 9.0
    d.ENABLE_LOSS_MODULATION = True
    d.ENABLE_LOSS_LOG = True
    d.LOC_LOSS_TYPE = "smoothl1"  # smoothl1 | iou | giou
    d.CENTERNESS_ALPHA = 5
    d.LOSS_LAMBDA_NORM = True
    d.LOSS_LAMBDA = CfgNode()
    d.LOSS_LAMBDA.CORNERS = 1.0
    d.LOSS_LAMBDA.CTR = 1.0
    d.LOSS_LAMBDA.CLS = 1.0
    d.LOSS_LAMBDA.CENTER = 1.0

    _C.INPUT = CfgNode()
    _C.INPUT.FORMAT = "BGR"  # channel order of the decoded image fed to the model
    _C.INPUT.MIN_SIZE_TRAIN = (800,)
    _C.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
    _C.INPUT.MAX_SIZE_TRAIN = 1333
    _C.INPUT.MIN_SIZE_TEST = 800
    _C.INPUT.MAX_SIZE_TEST = 1333
    _C.INPUT.HFLIP_TRAIN = True
    _C.INPUT.MIN_AREA = 10  # DOTA annotations of this area or less are skipped
    _C.INPUT.MIN_SIDE = 2  # and those whose longer hbox side is below this
    _C.INPUT.ROTATION_AUG_ANGLES = [0.0, 90.0, 180.0, 270.0]
    _C.INPUT.ROTATION_AUG_SAMPLE_STYLE = "choice"
    _C.INPUT.RESIZE_TYPE = "shortest-edge"
    _C.INPUT.RESIZE_HEIGHT_TRAIN = 0
    _C.INPUT.RESIZE_WIDTH_TRAIN = 0
    _C.INPUT.RESIZE_HEIGHT_TEST = 0
    _C.INPUT.RESIZE_WIDTH_TEST = 0
    _C.INPUT.USE_COLOR_AUGMENTATIONS = False

    _C.DATASETS = CfgNode()
    _C.DATASETS.TRAIN = ["dota_1_train_1024"]
    _C.DATASETS.TEST = ["dota_1_val_1024"]
    _C.DATASETS.DOTA_REMOVE_CONTAINER_CRANE = False

    _C.DATALOADER = CfgNode()
    _C.DATALOADER.NUM_WORKERS = 4
    _C.DATALOADER.CACHE_IMAGES = False  # cache decoded uint8 on the records
    _C.DATALOADER.SAMPLER_TRAIN = "TrainingSampler"
    _C.DATALOADER.REPEAT_THRESHOLD = 0.0
    _C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True

    _C.SOLVER = CfgNode()
    _C.SOLVER.OPTIMIZER = "sgd"  # "sgd" | "adam"
    _C.SOLVER.IMS_PER_BATCH = 16
    _C.SOLVER.BASE_LR = 0.001
    _C.SOLVER.MOMENTUM = 0.9
    _C.SOLVER.NESTEROV = False
    _C.SOLVER.WEIGHT_DECAY = 0.0001
    _C.SOLVER.WEIGHT_DECAY_NORM = 0.0
    _C.SOLVER.WEIGHT_DECAY_BIAS = 0.0001
    _C.SOLVER.BIAS_LR_FACTOR = 1.0
    _C.SOLVER.GAMMA = 0.1
    _C.SOLVER.STEPS = (30000,)
    _C.SOLVER.MAX_ITER = 40000
    _C.SOLVER.WARMUP_FACTOR = 1.0 / 1000
    _C.SOLVER.WARMUP_ITERS = 1000
    _C.SOLVER.WARMUP_METHOD = "linear"
    _C.SOLVER.CHECKPOINT_PERIOD = 5000
    _C.SOLVER.REFERENCE_WORLD_SIZE = 0
    _C.SOLVER.AMP = CfgNode()
    _C.SOLVER.AMP.ENABLED = False  # the compute dtype is TPU.COMPUTE_DTYPE
    _C.SOLVER.CLIP_GRADIENTS = CfgNode()
    _C.SOLVER.CLIP_GRADIENTS.ENABLED = False
    _C.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "value"
    _C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    _C.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0

    _C.TEST = CfgNode()
    _C.TEST.EVAL_PERIOD = 0  # do_test every N train iterations (0: off)
    _C.TEST.IOU_TH = 0.5  # VOC-07 AP overlap threshold
    _C.TEST.NUM_PRED_VIS = 20  # sample renderings (not ported: needs cv2)
    _C.TEST.AUG = CfgNode()
    _C.TEST.AUG.ENABLED = False  # TTA (engine/tta.py) after do_test in the CLI
    _C.TEST.AUG.MIN_SIZES = (400, 500, 600, 700, 800, 900, 1000, 1100, 1200)
    _C.TEST.AUG.MAX_SIZE = 4000
    _C.TEST.AUG.FLIP = True
    _C.TEST.AUG.HFLIP = True
    _C.TEST.AUG.VFLIP = True
    _C.TEST.AUG.ROTATION_ANGLES = ()

    # key names kept from the JAX package's TPU namespace so recipes merge
    t = _C.TPU = CfgNode()
    t.MESH_SHAPE = [-1]  # data-parallel processes; -1 = the world size
    t.MESH_AXIS_NAMES = ["data"]  # only "data" is ported (parallel/mesh.py)
    t.COMPUTE_DTYPE = "bfloat16"  # model compute dtype; params stay float32
    t.MAX_INSTANCES = 256  # static per-image gt padding
    t.NMS_GROUP_CANDIDATES = 0  # >0: per-class-group NMS budget; 0: global cap
    t.NMS_MAX_CANDIDATES = 4096  # static NMS input size (global score cap)
    t.DECODE_APPROX_TOPK = False  # True (approximate top-k) is not ported and raises
    t.EVAL_BATCH = 16  # eval images per step
    t.ASSIGN_IMPL = "auto"  # "pallas" (the CUDA kernel) | "xla" (plain) | "auto"
    t.IMAGE_SIZE_DIVISIBILITY = 128
    t.BUCKETED_TRAIN = True  # multi-scale train on a small static-canvas
    # ladder: the shortest-edge scale is drawn once per BATCH (vs the
    # reference's per-image draw) and one train step is built per distinct
    # canvas (data/mapper.py::TrainScaleBuckets).  Only active for
    # shortest-edge resize with >1 train scale.
    t.TRAIN_MAX_BUCKETS = 4  # max distinct train canvases (train steps built)
    t.PREFETCH_DEPTH = 2  # batches the train loader keeps ready
    t.HOST_ASSIGN = False  # True is not ported and raises
    t.TRAIN_DEVICE_AUG = "auto"  # train augmentation rendered on the device
    # (ops/device_warp.py): True | False | "auto" (on with <= 2 host cores)
    t.TTA_DEVICE_AUG = True  # separable TTA copies rendered on the device;
    # the others (arbitrary angles), and every copy with False, render on
    # the host (data/image_warp.py)
    t.EVAL_INT8 = False  # w8a8 eval convs (layers/quant.py): the int8 kernels
    # of csrc/int8_conv.cu on the card
    t.EVAL_INT8_SCALES = ""  # calibrated activation scales (with EVAL_INT8):
    # a JSON of tools/calibrate_int8.py, read when the eval step is built;
    # "" = dynamic per-image scales
    t.EVAL_INT8_MIN_CHANNELS = 0  # smallest quantized conv width (with
    # EVAL_INT8); 0 = 256 with dynamic scales, 64 with a scales JSON

    return _C
