"""One rank of the port's data-parallel CPU tests
(tests/test_torch_port_parallel.py), or the one-rank run they are held to.

    python tests/test_torch_port_parallel_worker.py SPEC OUT RANK WORLD \
        INIT_FILE

loads the cases that the test wrote to SPEC (``torch.save``: weights,
batches and configurations as tensors, numpy arrays and dicts), joins a
gloo process group of WORLD ranks through INIT_FILE, runs every case over
``make_mesh()`` and writes each case's parameters, BN statistics and
metrics to OUT.  ``run_cases(spec)`` runs them in the calling process
without a mesh.  Imports neither jax nor the tests' conftest, so that it
runs in a fresh process.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.data import FeatureStore, TSNLoader
from ta3n_tpu_torch.data.device_sampler import DeviceSampler
from ta3n_tpu_torch.ops import gather_gemm, trn_fused
from ta3n_tpu_torch.train.step import (StepScalars, create_train_state,
                                       make_eval_step, make_grad_accum_step,
                                       make_multi_eval_step,
                                       make_multi_train_step,
                                       make_sampled_multi_step,
                                       make_train_step)


def _device(case):
    return torch.device(case.get("device", "cpu"))


def _state(case):
    cfg = ModelConfig(**case["model"])
    tc = TrainConfig(**case.get("train", {}))
    state = create_train_state(cfg, tc, torch.Generator().manual_seed(0),
                               device=_device(case))
    state.model.load_state_dict(case["weights"])
    return state, tc


def _scalars(case, i):
    beta, mu, alpha, gamma, lr = case["scalars"][i]
    return StepScalars(tuple(beta), mu, alpha, gamma, lr)


def _generator(case):
    seed = case.get("dropout_seed")
    return (None if seed is None else
            torch.Generator(_device(case)).manual_seed(seed))


def _launches() -> dict:
    return {"k1_train": trn_fused.train_launches,
            "k2": trn_fused.bwd_launches, "k3": gather_gemm.launches}


def run_case(case, mesh=None) -> dict:
    """One case's steps: the parameters (and BN buffers) after them, every
    step's metrics, as numpy arrays, and the kernel launches (none on the
    CPU)."""
    trn_fused.train_launches = trn_fused.bwd_launches = 0
    gather_gemm.launches = 0
    state, tc = _state(case)
    dev = _device(case)
    da = DAConfig(**case["da"])
    kind = case["kind"]
    gen = _generator(case)
    metrics = []
    extra = {}
    if kind in ("host", "store"):
        step = make_train_step(state.model, da, tc,
                               gather_on_device=kind == "store", mesh=mesh)
        for i, batch in enumerate(case["batches"]):
            if kind == "store":
                xs, ys, ms, xt, yt, mt = batch
                store = torch.from_numpy(case["store"]).to(dev)
                args = (store, xs, ys, ms, store, xt, yt, mt)
            else:
                args = batch
            state, m = step(state, *args, _scalars(case, i), gen)
            metrics.append(m)
        if "val" in case:
            store = torch.from_numpy(case["store"]).to(dev)
            idx, y, mask = case["val"]
            ev = make_eval_step(state.model, gather_on_device=True,
                                mesh=mesh)
            multi = make_multi_eval_step(state.model, mesh=mesh)
            one = ev(store, idx[0], y[0], mask[0])
            extra = {f"eval_{k}": one[k] for k in ("loss", "top1", "n",
                                                   "logits")}
            extra.update({f"multi_{k}": v for k, v in
                          multi(store, idx, y, mask).items()})
    elif kind == "accum":
        step = make_grad_accum_step(state.model, da, tc, accum_steps=2,
                                    mesh=mesh)
        for i, batch in enumerate(case["batches"]):
            state, m = step(state, *batch, _scalars(case, i), gen)
            metrics.append(m)
    elif kind in ("multi", "sampled"):
        store = FeatureStore.load(case["store_dir"])
        bs, bt = case["batch"]
        loaders = [TSNLoader(store, batch_size=b, num_segments=5, seed=s,
                             pad_to=case.get("pad_to"))
                   for b, s in ((bs, 1), (bt, 2))]
        on_dev = store.to_device(dev)
        k = len(case["scalars"])
        sc = [_scalars(case, i) for i in range(k)]
        stacked = StepScalars(*(list(f) for f in zip(*sc)))
        if kind == "sampled":
            samplers = [DeviceSampler(ld, seed=s).to(dev) for ld, s in
                        zip(loaders, (101, 202))]
            spe = min(len(ld) for ld in loaders)
            for s in samplers:
                s.steps_per_epoch = spe
            step = make_sampled_multi_step(state.model, da, tc, *samplers,
                                           mesh=mesh)
            state, m = step(state, on_dev, on_dev, stacked, gen)
        else:
            pairs = list(zip(loaders[0].index_epoch(),
                             loaders[1].index_epoch()))[:k]
            step = make_multi_train_step(state.model, da, tc, mesh=mesh)
            stack = [np.stack([getattr(p[j], f) for p in pairs])
                     for j in (0, 1)
                     for f in ("abs_indices", "labels", "mask")]
            state, m = step(state, on_dev, *stack[:3], on_dev, *stack[3:],
                            stacked, gen)
        metrics.append(m)
    else:
        raise ValueError(kind)
    out = {"params": {k: v.detach().cpu().numpy().copy()
                      for k, v in state.model.state_dict().items()},
           "metrics": [{k: v.detach().cpu().numpy() for k, v in m.items()}
                       for m in metrics], "steps": state.step,
           "launches": _launches()}
    out.update({k: v.detach().cpu().numpy() for k, v in extra.items()})
    return out


def run_cases(spec, mesh=None) -> dict:
    return {name: run_case(case, mesh) for name, case in spec.items()}


def main(argv) -> int:
    spec_path, out_path, rank, world, init_file = argv
    torch.set_num_threads(1)
    from ta3n_tpu_torch.parallel import make_mesh
    from ta3n_tpu_torch.parallel.distributed import initialize_multihost
    initialize_multihost(f"file://{init_file}", int(world), int(rank),
                         backend="gloo")
    spec = torch.load(spec_path, weights_only=False)
    results = run_cases(spec, make_mesh())
    torch.save(results, out_path)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
