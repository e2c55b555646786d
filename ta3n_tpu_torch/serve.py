"""Inference and serving: a batch predictor and a local HTTP endpoint.

Port of `ta3n_tpu/serve.py` (Predictor: 49-108 and 259-308; HTTP:
311-365) for the models the port runs (`models/video_model.py`):

    predictor = Predictor.from_checkpoint("model.pth.tar", model_cfg,
                                          device="cuda")
    probs, top_p, top_i = predictor(features)     # [N, S, D] -> numpy

    python -m ta3n_tpu_torch.cli.serve CLASS_FILE model.pth.tar --port 8500

On CUDA a multi-scale TRN runs as the hand-written kernel
(`ops/trn_fused.py`).  Requests are cut into chunks of ``batch_size``
videos and the last chunk is zero-padded to it, as in the JAX package, so
the device sees one shape.

The JAX predictor feeds every chunk as both streams and keeps the target
half; every row is independent in eval (dropout off, BN on its running
statistics), so the port feeds it once, as the target stream with an
empty source stream (under share_params N the target layers, as the JAX
target half).  The frame baseline's frame logits are averaged over the
segments, as in the JAX predictor.

Deep-ensemble serving (``Predictor(n_members=N)``, ``from_sweep``): the
members' parameters are stacked and one ``torch.func.vmap`` pass under
``torch.no_grad`` scores every member, K1 (infer) launched once for all of
them (its vmap rule, `ops/trn_fused.py`); the softmax is averaged over the
members, as the JAX ensemble Predictor averages it.

AOT export, ``mesh=`` data parallelism and int8 are not ported yet
(ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import copy
import glob
import json
import os
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Sequence, Tuple

import numpy as np
import torch

from ta3n_tpu_torch.config import ModelConfig
from ta3n_tpu_torch.io_utils.checkpoint import BEST_NAME, CKPT_NAME
from ta3n_tpu_torch.io_utils.convert import (load_reference_checkpoint,
                                             reference_state_dict)
from ta3n_tpu_torch.models.layers import bf16_f32_reduction
from ta3n_tpu_torch.models.video_model import VideoModel
from ta3n_tpu_torch.train.step import video_logits

__all__ = ["Predictor", "make_http_server", "run_http_server"]


_LATER = "is not ported yet (ROADMAP.md queue 1, item 10: serving extras)"


class _MemberProbs(torch.nn.Module):
    """One member's float32 softmax of its video-level logits, as
    ``forward`` of a module holding the template model (what
    ``functional_call`` calls under the members' vmap)."""

    def __init__(self, net: VideoModel, empty, beta):
        super().__init__()
        self.net = net
        self.empty, self.beta = empty, beta

    def forward(self, x):
        _, out = self.net(self.empty, x, self.beta, 0.0, False, False)
        return torch.softmax(video_logits(out.out).float(), dim=-1)


class Predictor:
    """Fixed-batch inference with padding, on ``device``.  With
    ``n_members`` N > 0, ``model`` is a sequence of N members (solo
    `VideoModel`s of one configuration) served as a deep ensemble: the
    member-averaged softmax of one vmapped pass."""

    def __init__(self, model_cfg: ModelConfig, model, batch_size: int = 64,
                 top_k: int = 5, device="cuda", mesh=None,
                 n_members: int = 0):
        if mesh is not None:
            raise NotImplementedError(f"data-parallel serving {_LATER}")
        self.cfg = model_cfg
        self.device = torch.device(device)
        self.n_members = n_members
        if n_members:
            models = list(model)
            if len(models) != n_members:
                raise ValueError(f"n_members={n_members}, got "
                                 f"{len(models)} models")
            params, buffers = torch.func.stack_module_state(
                [m.to(self.device).eval() for m in models])
            self._stacked = (
                {f"net.{k}": v.detach() for k, v in params.items()},
                {f"net.{k}": v for k, v in buffers.items()})
            model = copy.deepcopy(models[0])
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.top_k = min(top_k, model_cfg.num_class)
        s = model_cfg.val_segments
        self._empty = torch.zeros((0, s, model_cfg.input_feature_dim),
                                  device=self.device)
        self._beta = torch.zeros(3, device=self.device)
        if n_members:
            self._probs = _MemberProbs(self.model, self._empty, self._beta)

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

    @staticmethod
    def is_sweep(path: str) -> bool:
        """Whether ``path`` is a sweep's output directory (``cli.sweep
        --sweep_dir``): a sweep.json or member_XX checkpoints."""
        return os.path.isdir(path) and (
            os.path.isfile(os.path.join(path, "sweep.json"))
            or bool(glob.glob(os.path.join(path, "member_*", CKPT_NAME))))

    @classmethod
    def from_sweep(cls, sweep_dir: str, model_cfg: ModelConfig,
                   members=None, which: str = "checkpoint", device="cuda",
                   **kw) -> "Predictor":
        """A deep-ensemble Predictor over a sweep's output directory
        (`train/sweep.py`): every member_XX/checkpoint.pth.tar (or only
        ``members``, a sequence of member indices), served as one vmapped
        pass with the member-averaged softmax.  ``which="model_best"``
        serves each member's best-validation state (model_best.pth.tar,
        written by ``eval_freq`` sweeps).  The refusals are the JAX
        Predictor's: another ``which``; members without a model_best when
        none are named; no member at all; members that disagree on BN
        statistics."""
        if which not in ("checkpoint", "model_best"):
            raise ValueError(f"which={which!r}: expected 'checkpoint' "
                             "or 'model_best'")
        name = CKPT_NAME if which == "checkpoint" else BEST_NAME
        if members is not None:
            paths = [os.path.join(sweep_dir, f"member_{int(k):02d}", name)
                     for k in members]
        else:
            paths = sorted(glob.glob(os.path.join(sweep_dir, "member_*",
                                                  name)))
            if which == "model_best":
                # a smaller ensemble is never served silently: members
                # without a model_best must be left out by name
                have = {os.path.basename(os.path.dirname(p)) for p in paths}
                every = {os.path.basename(os.path.dirname(p))
                         for p in glob.glob(os.path.join(
                             sweep_dir, "member_*", CKPT_NAME))}
                missing = sorted(every - have)
                if missing:
                    raise FileNotFoundError(
                        f"{missing} have no model_best under {sweep_dir} "
                        "(model_best is written by eval_freq>0 sweeps) — "
                        "serve the final states instead, or pass members= "
                        "to select the members that have one")
        if not paths:
            raise FileNotFoundError(
                f"no member_*/{name} under {sweep_dir}"
                + (" (model_best is written by eval_freq>0 sweeps)"
                   if which == "model_best" else ""))
        with_bn = ["bn_shared_S.weight" in reference_state_dict(p)
                   for p in paths]
        if any(with_bn) and not all(with_bn):
            raise ValueError(
                "member checkpoints disagree on batch_stats presence "
                f"(members with stats: "
                f"{[i for i, b in enumerate(with_bn) if b]}) — the sweep "
                "dir mixes incompatible models")
        models = [load_reference_checkpoint(p, model_cfg, device)
                  for p in paths]
        return cls(model_cfg, models, device=device, n_members=len(models),
                   **kw)

    @torch.inference_mode()
    @bf16_f32_reduction()
    def _predict(self, chunk: np.ndarray):
        """Probabilities and top-k of one batch: a float32 softmax of the
        video-level logits, whatever dtype the model computes in (a
        ``compute_dtype="bfloat16"`` model runs its bfloat16 kernels and
        answers in float32); of an ensemble, the members' mean."""
        x = torch.from_numpy(chunk).to(self.device)
        if self.n_members:
            probs = self._ensemble_probs(x)
        else:
            _, out = self.model(self._empty, x, self._beta, 0.0, False,
                                False)
            probs = torch.softmax(video_logits(out.out).float(), dim=-1)
        top_p, top_i = torch.topk(probs, self.top_k, dim=-1)
        return probs.cpu().numpy(), top_p.cpu().numpy(), top_i.cpu().numpy()

    def _ensemble_probs(self, x: torch.Tensor) -> torch.Tensor:
        """Every member's softmax in one vmapped pass (the transforms need
        a tensor that is not an inference tensor: x is cloned out of
        inference mode), averaged over the members."""
        params, buffers = self._stacked
        with torch.inference_mode(False), torch.no_grad():
            probs = torch.func.vmap(
                lambda p, b, t: torch.func.functional_call(
                    self._probs, {**p, **b}, (t,)),
                in_dims=(0, 0, None))(params, buffers, x.clone())
            return probs.mean(dim=0)

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
