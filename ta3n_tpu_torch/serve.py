"""Inference and serving: a batch predictor and a local HTTP endpoint.

Port of `ta3n_tpu/serve.py` (Predictor: 49-308; HTTP: 311-365) for the
models the port runs (`models/video_model.py`):

    predictor = Predictor.from_checkpoint("model.pth.tar", model_cfg,
                                          device="cuda")
    probs, top_p, top_i = predictor(features)     # [N, S, D] -> numpy

    python -m ta3n_tpu_torch.cli.serve CLASS_FILE model.pth.tar --port 8500

On CUDA a multi-scale TRN runs as the hand-written kernel
(`ops/trn_fused.py`).  Requests are cut into chunks of ``batch_size``
videos and the last chunk is zero-padded to it, as in the JAX package, so
the device sees one shape.  The chunks are pipelined as in the JAX
Predictor (`ta3n_tpu/serve.py:286-306`): chunk i+1 is uploaded through
pinned memory and dispatched, and its outputs' copies to pinned host
buffers started, before the host waits for chunk i's; two pairs of host
buffers alternate by chunk, each written again only after its chunk's
event was waited on and its rows copied out.  On the CPU the same code
runs synchronously and gives the same answers.

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

int8 inference: a ``ModelConfig`` with ``quantize="int8"`` (CLI
``--quantize int8``) runs every Linear whose dims reach 128 as a W8A8
int8 x int8 -> int32 product (`models/layers.py`); it rides the model
config into exported artifacts' meta.json.

AOT artifacts (`ta3n_tpu/serve.py:110-189`): ``Predictor.export(dir)``
writes the whole predict function, weights included, at the fixed batch
``batch_size``, as a ``torch.export`` program (``predict.pt2``) beside a
``meta.json`` with the JAX artifact's keys; ``Predictor.from_exported``
serves it with ``torch.export.load``, no model code and no checkpoint.
The program is traced from a CPU copy of the model, whose ops are the
plain versions (the hand-written kernels are bound through ctypes and
read data pointers, which a trace cannot follow), then moved to the
serving device when loaded: an artifact runs no hand-written kernel, as
the JAX artifact, traced under ``force_xla_trn``, runs no Pallas.  An
ensemble's artifact scores its members one after the other (a trace
cannot follow the live pass's vmap rules); the mean of the members'
softmaxes is the same function.

An artifact's batch axis is exported dynamic (any number of rows up to
the traced one runs), except an int8 model's, whose trace fixes it.

Data-parallel serving (``mesh=``, a single process's grid from
``parallel.make_mesh()``, as the JAX Predictor's single-controller mesh):
one replica a device, ``batch_size`` rounded up to a device multiple, and
every chunk split into one row block a device; each block is uploaded and
launched on its device's current stream, its outputs' copies started,
with no wait between devices, and the blocks are put back in order when
the chunk is read.  An ensemble is replicated whole.  An artifact served
over a grid needs a batch size that divides by the devices (as the JAX
Predictor's ``from_exported``) and a dynamic batch axis.
"""

from __future__ import annotations

import copy
import dataclasses
import glob
import json
import os
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ta3n_tpu_torch.config import ModelConfig
from ta3n_tpu_torch.io_utils.checkpoint import BEST_NAME, CKPT_NAME
from ta3n_tpu_torch.io_utils.convert import (load_reference_checkpoint,
                                             reference_state_dict)
from ta3n_tpu_torch.models.layers import bf16_f32_reduction
from ta3n_tpu_torch.models.video_model import VideoModel
from ta3n_tpu_torch.ops.gather_gemm import upload
from ta3n_tpu_torch.parallel.mesh import (device_scope, pad_to_multiple,
                                          split_rows)
from ta3n_tpu_torch.train.step import video_logits

__all__ = ["Predictor", "make_http_server", "run_http_server"]


_EXPORT_BIN = "predict.pt2"
_EXPORT_META = "meta.json"
_PLATFORMS = ("cpu", "cuda")
_NO_GRL = (0.0, 0.0, 0.0)


def _video_probs(net: VideoModel, x: torch.Tensor) -> torch.Tensor:
    """The float32 softmax of a model's video-level logits for x, fed as
    the target stream."""
    _, out = net(x[:0], x, _NO_GRL, 0.0, False, False)
    return torch.softmax(video_logits(out.out).float(), dim=-1)


class _MemberProbs(nn.Module):
    """One member's `_video_probs` as ``forward`` of a module holding the
    template model (what ``functional_call`` calls under the members'
    vmap)."""

    def __init__(self, net: VideoModel):
        super().__init__()
        self.net = net

    def forward(self, x):
        return _video_probs(self.net, x)


class _Program(nn.Module):
    """What an artifact computes: (probs, top_p, top_i) of one batch, the
    probabilities the mean of the members' softmaxes (one member: its
    own), the members scored one after the other."""

    def __init__(self, members: Sequence[VideoModel], top_k: int):
        super().__init__()
        self.members = nn.ModuleList(members)
        self.top_k = top_k

    def forward(self, x):
        probs = [_video_probs(m, x) for m in self.members]
        probs = probs[0] if len(probs) == 1 else torch.stack(probs).mean(0)
        top_p, top_i = torch.topk(probs, self.top_k, dim=-1)
        return probs, top_p, top_i


def _grid(mesh):
    """The devices of a single process's grid (None: no mesh)."""
    if mesh is None:
        return None
    if mesh.group is not None and mesh.size > 1:
        raise ValueError("a Predictor serves over a single process's grid "
                         "(parallel.make_mesh() without a process group)")
    return mesh.devices


class Predictor:
    """Fixed-batch inference with padding, on ``device``.  With
    ``n_members`` N > 0, ``model`` is a sequence of N members (solo
    `VideoModel`s of one configuration) served as a deep ensemble: the
    member-averaged softmax of one vmapped pass.  With ``mesh`` (a single
    process's grid) one replica a device of it (``device`` is then the
    grid's first), as the module docstring says."""

    def __init__(self, model_cfg: ModelConfig, model, batch_size: int = 64,
                 top_k: int = 5, device="cuda", mesh=None,
                 n_members: int = 0):
        devices = _grid(mesh)
        if devices is not None:
            # one replica a device, the first the caller's model(s): the
            # grid serves through them and exports replica 0's
            batch_size = pad_to_multiple(batch_size, len(devices))
            model = list(model) if n_members else model
            shards = [
                (Predictor(model_cfg,
                           model if i == 0 else copy.deepcopy(model),
                           batch_size // len(devices), top_k, dev,
                           n_members=n_members), rows)
                for i, (dev, rows) in enumerate(zip(
                    devices, split_rows(batch_size, mesh)))]
            vars(self).update(vars(shards[0][0]), batch_size=batch_size,
                              _shards=shards)
            return
        self._shards = None
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
        if n_members:
            self._probs = _MemberProbs(self.model)
        self._exported = None
        self._pinned = [None, None]

    @classmethod
    def from_checkpoint(cls, weights: str, model_cfg: ModelConfig,
                        device="cuda", **kw) -> "Predictor":
        """Serve a reference-format ``.pth.tar``.  A JAX checkpoint
        directory raises with the command that exports it."""
        model = load_reference_checkpoint(weights, model_cfg, device)
        return cls(model_cfg, model, device=device, **kw)

    def _members_on_cpu(self) -> list:
        """CPU copies of the served model, or of each ensemble member."""
        if not self.n_members:
            return [copy.deepcopy(self.model).cpu()]
        state = {**self._stacked[0], **self._stacked[1]}
        members = []
        for k in range(self.n_members):
            member = copy.deepcopy(self.model).cpu()
            member.load_state_dict({name[len("net."):]: v[k].cpu()
                                    for name, v in state.items()})
            members.append(member)
        return members

    def export(self, path: str, platforms=_PLATFORMS) -> str:
        """Write the predict function, weights included, at the fixed
        batch ``batch_size`` to ``path/predict.pt2`` (``torch.export``)
        and ``path/meta.json`` (model_cfg, batch_size, top_k, platforms,
        input_shape, n_members), for `from_exported`.  Traced from a CPU
        copy of the model, so the program holds no hand-written kernel;
        ``platforms`` lists the devices (``cpu``, ``cuda``) it may be
        served on.  A Predictor loaded from an artifact refuses."""
        if self.model is None:
            raise ValueError("this Predictor was loaded from an exported "
                             "artifact; re-export from the checkpoint")
        platforms = list(platforms)
        unknown = sorted(set(platforms) - set(_PLATFORMS))
        if unknown:
            raise ValueError(f"platforms {unknown}: an artifact runs on "
                             f"{' or '.join(_PLATFORMS)}")
        program = _Program(self._members_on_cpu(), self.top_k).eval()
        shape = (self.batch_size,
                 self.cfg.val_segments * self.cfg.sample_new_length,
                 self.cfg.input_feature_dim)
        x = torch.zeros(shape)
        # the batch axis dynamic up to batch_size (a grid serves row
        # blocks of a batch), but for an int8 model, whose quantized
        # products' trace fixes it, and at a batch of 1, which a trace
        # specialises
        dynamic = None
        if self.cfg.quantize != "int8" and self.batch_size > 1:
            dynamic = ({0: torch.export.Dim("batch", min=1,
                                            max=self.batch_size)},)
        with torch.no_grad():
            # one call before the trace: the host-side caches it fills (the
            # TRN's subset indices) then hold real tensors, which the trace
            # records as constants
            program(x)
            exported = torch.export.export(program, (x,),
                                           dynamic_shapes=dynamic)
        os.makedirs(path, exist_ok=True)
        torch.export.save(exported, os.path.join(path, _EXPORT_BIN))
        meta = {"model_cfg": dataclasses.asdict(self.cfg),
                "batch_size": self.batch_size, "top_k": self.top_k,
                "platforms": platforms, "input_shape": list(shape),
                "n_members": self.n_members}
        with open(os.path.join(path, _EXPORT_META), "w") as f:
            json.dump(meta, f, indent=1)
        return path

    @staticmethod
    def is_exported(path: str) -> bool:
        """Whether ``path`` is an artifact that `export` wrote."""
        return os.path.isfile(os.path.join(path, _EXPORT_BIN))

    @classmethod
    def from_exported(cls, path: str, mesh=None,
                      device="cuda") -> "Predictor":
        """Serve an `export` artifact on ``device`` (one of its
        platforms): ``torch.export.load``, the program moved to the
        device (``move_to_device_pass``), and the configuration, batch
        size and top-k from its meta.json; no model code, no
        checkpoint.  With ``mesh`` (a single process's grid) the program
        on each device of it, each serving its row block of a batch: the
        artifact's batch size must divide by the devices and its batch
        axis be dynamic."""
        from torch.export.passes import move_to_device_pass

        with open(os.path.join(path, _EXPORT_META)) as f:
            meta = json.load(f)
        devices = _grid(mesh)
        batch_size = int(meta["batch_size"])
        if devices is not None:
            if batch_size % len(devices):
                raise ValueError(
                    f"exported batch size {batch_size} is not divisible "
                    f"by the {len(devices)}-device mesh; re-export with "
                    f"a device-multiple batch size")
            device = devices[0]
        device = torch.device(device)
        if device.type not in meta["platforms"]:
            raise ValueError(f"the artifact at {path} was exported for "
                             f"{meta['platforms']}, not {device.type}")

        def load(dev):
            self = cls.__new__(cls)
            program = torch.export.load(os.path.join(path, _EXPORT_BIN))
            if devices is not None and len(devices) > 1 \
                    and not _dynamic_batch(program):
                raise ValueError(
                    f"the artifact at {path} was traced at a fixed batch "
                    f"of {batch_size} (an int8 model's or a batch of 1): "
                    "serve it on one device")
            if dev.type != "cpu":
                program = move_to_device_pass(program, dev)
            self.cfg = ModelConfig(**meta["model_cfg"])
            self.device = dev
            self.model = None
            self.n_members = int(meta["n_members"])
            self.batch_size = batch_size
            self.top_k = int(meta["top_k"])
            self._exported = program.module()
            self._pinned = [None, None]
            self._shards = None
            return self

        self = load(device)
        if devices is not None:
            self._shards = [(self if i == 0 else load(dev), rows)
                            for i, (dev, rows) in enumerate(zip(
                                devices, split_rows(batch_size, mesh)))]
        return self

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
    def _forward(self, x: torch.Tensor):
        """(probs, top_p, top_i) of one batch on the device: a float32
        softmax of the video-level logits, whatever dtype the model
        computes in (a ``compute_dtype="bfloat16"`` model runs its
        bfloat16 kernels and answers in float32); of an ensemble, the
        members' mean; of an artifact, its program's."""
        if self._exported is not None:
            return self._exported(x)
        probs = (self._ensemble_probs(x) if self.n_members
                 else _video_probs(self.model, x))
        top_p, top_i = torch.topk(probs, self.top_k, dim=-1)
        return probs, top_p, top_i

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

    def _fetch(self, outs, slot: int):
        """Start the copies of one chunk's outputs to the host: on CUDA
        into pinned buffer pair ``slot`` without waiting, an event
        recorded after them; elsewhere the outputs are on the host
        already.  Returns (host tensors, event or None)."""
        if self.device.type != "cuda":
            return outs, None
        bufs = self._pinned[slot]
        if bufs is None or [b.shape for b in bufs] != [o.shape
                                                      for o in outs]:
            bufs = self._pinned[slot] = tuple(
                torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                for o in outs)
        for dst, src in zip(bufs, outs):
            dst.copy_(src, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return bufs, event

    def __call__(self, features: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """features: [N, S, D] -> (probs [N,C], top_p [N,K], top_i [N,K]).
        Chunk i+1 is dispatched and its copies started before chunk i is
        read (see the module docstring); over a grid each chunk's row
        blocks are dispatched on their devices in turn, with no wait."""
        n = features.shape[0]
        b = self.batch_size
        got = ([], [], [])
        shards = self._shards or [(self, slice(0, b))]

        def take(fetched, real):
            for bufs, event in fetched:
                if event is not None:
                    event.synchronize()
            for j, out in enumerate(got):  # bufs are reused: copied out
                out.append(np.concatenate(
                    [bufs[j].numpy() for bufs, _ in fetched])[:real])

        in_flight = None
        for i, lo in enumerate(range(0, n, b)):
            chunk = np.asarray(features[lo:lo + b], np.float32)
            real = chunk.shape[0]
            if real < b:
                chunk = np.concatenate(
                    [chunk, np.zeros((b - real,) + chunk.shape[1:],
                                     np.float32)])
            fetched = []
            for shard, rows in shards:
                with device_scope(shard.device):
                    x = upload(chunk[rows], torch.float32, shard.device)
                    fetched.append(shard._fetch(shard._forward(x), i % 2))
            if in_flight is not None:
                take(*in_flight)
            in_flight = (fetched, real)
        if in_flight is not None:
            take(*in_flight)
        return tuple(np.concatenate(out) for out in got)


def _dynamic_batch(exported) -> bool:
    """Whether an exported program's input takes any batch (a symbolic
    leading dimension)."""
    for node in exported.graph.nodes:
        if node.op == "placeholder" and node.name in (
                exported.graph_signature.user_inputs):
            return not isinstance(node.meta["val"].shape[0], int)
    return False


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
