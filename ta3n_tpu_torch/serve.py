"""Inference and serving: a batch predictor and a local HTTP endpoint.

Port of `ta3n_tpu/serve.py` (Predictor: 49-108 and 259-308; HTTP:
311-365) for the flagship model:

    predictor = Predictor.from_checkpoint("model.pth.tar", model_cfg,
                                          device="cuda")
    probs, top_p, top_i = predictor(features)     # [N, S, D] -> numpy

    python -m ta3n_tpu_torch.cli.serve CLASS_FILE model.pth.tar --port 8500

On CUDA the model's multi-scale TRN runs as the hand-written kernel
(`ops/trn_fused.py`).  Requests are cut into chunks of ``batch_size``
videos and the last chunk is zero-padded to it, as in the JAX package, so
the device sees one shape.

The JAX predictor feeds every chunk as both streams and keeps the target
half; every row of the flagship is independent in eval (no BN, dropout
off), so the port feeds it once, as the target stream with an empty
source stream.

AOT export, sweep ensembles, ``mesh=`` data parallelism and int8 are not
ported yet (ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Sequence, Tuple

import numpy as np
import torch

from ta3n_tpu_torch.config import ModelConfig
from ta3n_tpu_torch.io_utils.convert import load_reference_checkpoint
from ta3n_tpu_torch.models.video_model import VideoModel

__all__ = ["Predictor", "make_http_server", "run_http_server"]


_LATER = "is not ported yet (ROADMAP.md queue 1, item 10: serving extras)"


class Predictor:
    """Fixed-batch inference with padding, on ``device``."""

    def __init__(self, model_cfg: ModelConfig, model: VideoModel,
                 batch_size: int = 64, top_k: int = 5, device="cuda",
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(f"data-parallel serving {_LATER}")
        self.cfg = model_cfg
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.top_k = min(top_k, model_cfg.num_class)
        s = model_cfg.val_segments
        self._empty = torch.zeros((0, s, model_cfg.input_feature_dim),
                                  device=self.device)
        self._beta = torch.zeros(3, device=self.device)

    @classmethod
    def from_checkpoint(cls, weights: str, model_cfg: ModelConfig,
                        device="cuda", **kw) -> "Predictor":
        """Serve a reference-format ``.pth.tar``.  A JAX checkpoint
        directory raises with the command that exports it."""
        model = load_reference_checkpoint(weights, model_cfg, device)
        return cls(model_cfg, model, device=device, **kw)

    def export(self, path: str, platforms=None) -> str:
        raise NotImplementedError(f"Predictor.export {_LATER}")

    @classmethod
    def from_exported(cls, path: str, mesh=None) -> "Predictor":
        raise NotImplementedError(f"Predictor.from_exported {_LATER}")

    @classmethod
    def from_sweep(cls, sweep_dir: str, model_cfg: ModelConfig,
                   **kw) -> "Predictor":
        raise NotImplementedError(f"ensemble serving {_LATER}")

    @torch.inference_mode()
    def _predict(self, chunk: np.ndarray):
        x = torch.from_numpy(chunk).to(self.device)
        _, out = self.model(self._empty, x, self._beta, 0.0, False, False)
        probs = torch.softmax(out.out, dim=-1)
        top_p, top_i = torch.topk(probs, self.top_k, dim=-1)
        return probs.cpu().numpy(), top_p.cpu().numpy(), top_i.cpu().numpy()

    def __call__(self, features: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """features: [N, S, D] -> (probs [N,C], top_p [N,K], top_i [N,K])."""
        n = features.shape[0]
        b = self.batch_size
        probs, tps, tis = [], [], []
        for lo in range(0, n, b):
            chunk = np.asarray(features[lo:lo + b], np.float32)
            real = chunk.shape[0]
            if real < b:
                chunk = np.concatenate(
                    [chunk, np.zeros((b - real,) + chunk.shape[1:],
                                     np.float32)])
            p, tp, ti = self._predict(chunk)
            probs.append(p[:real])
            tps.append(tp[:real])
            tis.append(ti[:real])
        return (np.concatenate(probs), np.concatenate(tps),
                np.concatenate(tis))


def make_http_server(predictor: Predictor, class_names: Sequence[str],
                     host: str, port: int) -> HTTPServer:
    """A JSON-over-HTTP endpoint, bound but not yet serving (port 0 picks
    a free port: read ``server.server_address``).

    POST /predict {"features": [[...S x D...], ...]} ->
      {"top_classes": [...], "top_probs": [...], "names": [...]}
    GET /healthz -> {"status": "ok", "num_class": C, "segments": S}
    """

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok",
                                 "num_class": predictor.cfg.num_class,
                                 "segments": predictor.cfg.val_segments})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                feats = np.asarray(req["features"], np.float32)
                if feats.ndim != 3:
                    raise ValueError(
                        f"features must be [N, S, D]; got {feats.shape}")
                _, tp, ti = predictor(feats)
                self._send(200, {
                    "top_classes": ti.tolist(),
                    "top_probs": tp.tolist(),
                    "names": [[class_names[j] for j in row]
                              for row in ti.tolist()],
                })
            except Exception as e:  # noqa: BLE001 — report to client
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):  # quiet
            pass

    return HTTPServer((host, port), Handler)


def run_http_server(predictor: Predictor, class_names: Sequence[str],
                    host: str, port: int) -> None:
    """Serve ``predictor`` on http://host:port until interrupted."""
    server = make_http_server(predictor, class_names, host, port)
    print(f"serving on http://{host}:{server.server_address[1]} "
          f"(POST /predict, GET /healthz)")
    try:
        server.serve_forever()
    finally:
        server.server_close()
