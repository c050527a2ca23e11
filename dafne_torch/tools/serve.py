"""HTTP serving front end of the port.

    python -m dafne_torch.tools.serve --config-file configs/dota-1.0/1024.yaml \
        OUTPUT_DIR runs/exp1 [--port 8321] [--cpu] [KEY VALUE ...]
    python -m dafne_torch.tools.serve --artifact runs/exp1/export/model.pt2 [--cpu]

Counterpart of ``tools/serve.py``.  Live mode: the model built from the
config, the newest checkpoint under OUTPUT_DIR restored through
``engine/checkpoint.py`` (else MODEL.WEIGHTS), one image per request at
batch 1 on the card (the CPU with ``--cpu``).  Artifact mode: the program
``tools/export_model.py`` wrote (``model.pt2`` and ``export_meta.json``),
loaded with ``torch.export.load`` after the op library alone, with no
model code and no config (KEY VALUE overrides are refused), on the device
it was exported for (``--cpu`` for a CPU export).  Both serve behind the
standard library's threading HTTP server, through the same front end
(``engine/predictor.py``).  The model, its decode and the rotated NMS run
on one long-lived thread: one request on the card at a time.  The server
warms up once before it listens, so that cuDNN's search for the canvas's
shapes is not billed to the first request.

API, as ``tools/serve.py``:
  GET  /healthz -> 200 {"ok": true, "canvas": [H, W], "batch": 1, ...,
                   "requests": detect calls answered (the warm-up's too),
                   "launches": the NMS kernels' launches in this process,
                   "int8": {"mode": "off", "dynamic" or "static" (TPU.EVAL_INT8
                   in live mode, the export's in artifact mode), "min_channels",
                   "sites", "launches": the int8 kernels' launches}}
                   (503 with "ok": false and "untrained_weights": true when
                   no checkpoint and no MODEL.WEIGHTS were loaded)
  POST /detect  body: the .npy bytes of an H x W x 3 image in the recipe's
                INPUT.FORMAT (BGR in every shipped config), or an encoded
                JPEG, PNG or BMP file (decoded by ``data/image_io.py``, as
                ``cv2.imdecode`` decodes it, and turned to the recipe's
                channel order)
                -> {"detections": [{"corners": [8 floats], "hbox": [4],
                    "score": s, "class": c}, ...]} in the image's own
                coordinates, highest score first.
                A body that does not decode, or an image over the pixel cap
                (OPENCV_IO_MAX_IMAGE_PIXELS, default 64 000 000), is 400; a
                body over 256 MiB is 413; a fault of the model is 500.

For example, on the CPU:
    curl -X POST --data-binary @img.jpg http://127.0.0.1:8321/detect
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Tuple

import numpy as np
import torch

from dafne_torch.data.image_io import decode_image_bytes, max_image_pixels

logger = logging.getLogger("dafne_torch")
MAX_BODY = 256 << 20


def decode_image_body(data: bytes, input_format: str = "BGR") -> np.ndarray:
    """A request body as an H x W x 3 array: a .npy body verbatim (already
    in the recipe's channel order), anything else decoded as an image file
    into BGR and turned to `input_format`.  Any failure to decode, and an
    image over the pixel cap, is a ValueError: the client's fault (400)."""
    if data[:6] == b"\x93NUMPY":
        try:
            img = np.load(io.BytesIO(data), allow_pickle=False)
        except Exception as e:
            raise ValueError(f"undecodable .npy body: {e}") from None
    else:
        try:
            img = decode_image_bytes(data, "RGB" if input_format.upper() == "RGB" else "BGR",
                                     "request body")
        except Exception as e:  # corrupt, truncated, over the cap, or not an image at all
            raise ValueError(f"undecodable image body: {e}") from None
    cap = max_image_pixels()
    if img.ndim >= 2 and img.shape[0] * img.shape[1] > cap:
        raise ValueError(f"image {img.shape[0]}x{img.shape[1]} exceeds the {cap}-pixel serving cap")
    return img


class DetectorService:
    """One model on one thread: ``detect(img)`` runs one request through
    ``engine/predictor.py``'s front end (a ``Predictor`` in live mode, a
    ``FrontEnd`` over the loaded program in artifact mode) on the
    service's model thread, whichever thread asks."""

    def __init__(self, predictor, meta: Dict):
        self.predictor = predictor
        self.batch = predictor.batch
        self.pad_hw = tuple(predictor.canvas_hw)
        self.meta = meta
        # a checkpoint step of 0 and no MODEL.WEIGHTS: nothing trained was
        # loaded, and /healthz says so (a typo'd OUTPUT_DIR serves random
        # weights otherwise)
        self.untrained = meta.get("checkpoint_step") == 0 and not meta.get("weights")
        self.requests = 0  # detect calls answered, the warm-up's included
        # one long-lived thread runs the model, one request at a time: a
        # handler thread lives for one request, and each new thread would
        # set up its own CUDA library handles on its first call
        self._worker = ThreadPoolExecutor(1, thread_name_prefix="detector",
                                          initializer=self._bind_device)

    @classmethod
    def from_config(cls, cfg, device: str = "cuda") -> "DetectorService":
        """Live mode: the model of `cfg` on `device` (the card unless the
        caller asks for the CPU), the newest checkpoint under OUTPUT_DIR
        restored (else MODEL.WEIGHTS), served at batch 1."""
        from dafne_torch.data.mapper import eval_preprocess_meta
        from dafne_torch.engine.checkpoint import restore_for_inference
        from dafne_torch.engine.predictor import Predictor

        model, step = restore_for_inference(cfg, device)
        predictor = Predictor(model, cfg, batch=1)
        meta = dict(eval_preprocess_meta(cfg), checkpoint_step=step, weights=cfg.MODEL.WEIGHTS,
                    int8=predictor.step.program.int8)
        return cls(predictor, meta).warm_up()

    @classmethod
    def from_artifact(cls, path: str, device: str = "cuda") -> "DetectorService":
        """Artifact mode: the program ``tools/export_model.py`` wrote to
        `path` (``model.pt2``, with ``export_meta.json`` beside it), served
        through the same front end, with no model code: only the op library
        is imported, to register the ``dafne::`` kernels before the load.
        The program runs on the device it was exported for; `device` must
        be that one.  A weights-as-args artifact is refused (SystemExit);
        a batch over 1 is served with a warning."""
        from dafne_torch.engine.predictor import FrontEnd
        from dafne_torch.ops.kernels import library  # noqa: F401  (the dafne:: ops)

        meta_path = os.path.join(os.path.dirname(os.path.abspath(path)), "export_meta.json")
        if not (os.path.isfile(path) and os.path.isfile(meta_path)):
            raise SystemExit(f"no artifact at {path} (model.pt2 with export_meta.json beside it)")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("weights_as_args"):
            raise SystemExit("a weights-as-args artifact needs its weights as inputs; export "
                             "without --weights-as-args for serving")
        if torch.device(device).type != meta["device"]:
            raise SystemExit(f"the artifact was exported for {meta['device']}, not {device}")
        if int(meta["batch"]) > 1:
            logger.warning(f"artifact batch is {meta['batch']}: every one-image request pays for "
                           "the whole batch; export with --batch 1 for serving")
        program = torch.export.load(path).module()

        @torch.no_grad()
        def step(images, scale_xy):
            return program(images, scale_xy)

        # the device the program's weights were loaded onto (cuda:0 for "cuda")
        front = FrontEnd(step, meta, meta["pad_hw"], meta["batch"],
                         next(program.parameters()).device)
        return cls(front, meta).warm_up()

    def warm_up(self) -> "DetectorService":
        """One request on a black canvas before the server listens."""
        self.detect(np.zeros((*self.pad_hw, 3), np.uint8))
        return self

    def preprocess(self, img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """([1, H, W, 3] uint8 canvas, [1, 2] float32 scale_xy) of one image:
        the eval mapper's resize (uint8 first), placed top-left on the
        static canvas, and scale_xy = (w / rw, h / rh)."""
        self.predictor.check([img])
        canvas, scale_xy = self.predictor.canvas([img])
        return canvas.cpu().numpy(), scale_xy.cpu().numpy()

    def _bind_device(self) -> None:
        if self.predictor.device.type == "cuda":  # not the thread that built the model
            torch.cuda.set_device(self.predictor.device)

    def _run(self, img: np.ndarray) -> List[Dict]:
        dets = self.predictor.detect([img])[0]
        self.requests += 1
        return dets

    def detect(self, img: np.ndarray) -> List[Dict]:
        """Detections of one H x W x 3 image in the recipe's channel order,
        pixels 0-255 (uint8 or float): corners and hbox in the image's own
        coordinates, highest score first.  A malformed image is a
        ValueError.  Runs on the service's model thread."""
        self.predictor.check([img])
        return self._worker.submit(self._run, img).result()


def make_server(service: DetectorService, host: str = "127.0.0.1", port: int = 8321):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._json(404, {"error": "unknown path"})
            from dafne_torch.ops.kernels import quad_nms, quant

            int8 = service.meta.get("int8") or {"mode": "off"}
            self._json(503 if service.untrained else 200, {
                "ok": not service.untrained,
                "untrained_weights": service.untrained,
                "canvas": list(service.pad_hw),
                "batch": service.batch,
                "input_format": service.meta.get("input_format", "BGR"),
                "checkpoint_step": service.meta.get("checkpoint_step"),
                "requests": service.requests,
                "launches": {"suppression_matrix": quad_nms.suppression_bits_cuda.launches,
                             "greedy_keep": quad_nms.greedy_keep_bits_cuda.launches},
                "int8": {"mode": int8["mode"], "min_channels": int8.get("min_channels"),
                         "sites": int8.get("sites", 0),
                         "launches": {"quantize_act": quant.quantize_act_cuda.launches,
                                      "int8_conv": quant.int8_conv_cuda.launches},
                         "int8_conv_by_kernel": dict(quant.int8_conv_cuda.launches_by_path)},
            })

        def do_POST(self):
            if self.path != "/detect":
                return self._json(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > MAX_BODY:
                    return self._json(413, {"error": f"body {n} bytes > {MAX_BODY}"})
                img = decode_image_body(self.rfile.read(n), service.meta.get("input_format", "BGR"))
                self._json(200, {"detections": service.detect(np.asarray(img))})
            except ValueError as e:  # a malformed body or image
                self._json(400, {"error": str(e)})
            except Exception as e:  # a fault of the model or the card
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):  # no access log
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None, device: str = "cuda") -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--artifact", default="", help="a model.pt2 of tools/export_model.py")
    p.add_argument("--config-file", default="", help="the recipe of live mode")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--cpu", action="store_true", help="serve on the CPU instead of the card")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="dotted-key config overrides")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else device
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    if args.artifact:
        if args.opts:
            raise SystemExit(f"KEY VALUE overrides do not apply to an exported artifact (got "
                             f"{args.opts}); export again with the config wanted")
        service = DetectorService.from_artifact(args.artifact, device)
    elif args.config_file:
        from dafne_torch.config import get_cfg

        cfg = get_cfg()
        cfg.merge_from_file(args.config_file)
        if args.opts:
            cfg.merge_from_list(args.opts)
        service = DetectorService.from_config(cfg, device)
    else:
        raise SystemExit("need --artifact or --config-file")
    srv = make_server(service, args.host, args.port)
    print(json.dumps({"serving": f"http://{args.host}:{srv.server_address[1]}",
                      "canvas": list(service.pad_hw), "batch": service.batch}), flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main(sys.argv[1:])
