"""One rank of the port's 2-D grid CPU tests (tests/test_torch_port_grid.py
and tests/test_torch_port_grid_members.py), or the one-process run they
are held to.

    python tests/test_torch_port_grid_worker.py SPEC OUT RANK WORLD \
        INIT_FILE

loads the spec that the test wrote to SPEC (``torch.save``): the grid
(``("model", M)`` for a (data x model) grid, ``("member", S)`` for a
(member x data) grid, ``("member_1d",)`` for the members over every rank
of a 1-D mesh), the tensor-parallel threshold and the cases.  It joins a
gloo group of WORLD ranks through INIT_FILE, runs every case over the
grid and writes each case's results to OUT: a tensor-parallel case's
parameters as this rank holds them (its weight slices) with its metrics,
an ensemble case's stacked parameters and metrics of this rank's
members.  ``run_cases(spec)`` runs them in the calling process without a
mesh.  Imports neither jax nor the tests' conftest.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from test_torch_port_parallel_worker import (_generator, _launches,
                                             _scalars, _state, run_case)
from ta3n_tpu_torch.config import DAConfig, ModelConfig, TrainConfig
from ta3n_tpu_torch.ops import gather_gemm, trn_fused
from ta3n_tpu_torch.train import step as step_mod
from ta3n_tpu_torch.train.ensemble import (create_ensemble_state,
                                           ensemble_generators,
                                           make_ensemble_eval_step,
                                           make_ensemble_multi_step,
                                           make_ensemble_step, member_rows,
                                           stack_scalars)
from ta3n_tpu_torch.train.step import StepScalars, make_multi_train_step


def _numpy(d) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in d.items()}


def run_stacked(case, mesh=None) -> dict:
    """K device-store steps in one call from stacked index batches into a
    store array, then the device-store eval steps."""
    trn_fused.train_launches = trn_fused.bwd_launches = 0
    gather_gemm.launches = 0
    state, tc = _state(case)
    step = make_multi_train_step(state.model, DAConfig(**case["da"]), tc,
                                 mesh=mesh)
    store = torch.from_numpy(case["store"])
    k = len(case["scalars"])
    sc = [_scalars(case, i) for i in range(k)]
    state, m = step(state, store, *case["stacked"][:3], store,
                    *case["stacked"][3:], StepScalars(*(list(f) for f in
                                                        zip(*sc))),
                    _generator(case))
    return {"params": _numpy(state.model.state_dict()),
            "metrics": [_numpy(m)], "steps": state.step,
            "launches": _launches()}


def run_member_case(case, mesh=None) -> dict:
    """An ensemble case: this rank's members of ``case["seeds"]`` (all of
    them without a mesh), ``steps`` single steps (host features or device
    store, shared or per-member batches) or one K-step call, then the
    eval step on the case's val batch."""
    seeds = case["seeds"]
    rows = member_rows(mesh, len(seeds))
    cfg = ModelConfig(**case["model"])
    tc = TrainConfig(**case.get("train", {}))
    da = DAConfig(**case["da"])
    state = create_ensemble_state(cfg, tc, seeds[rows], "cpu")
    for name, t in state.params.items():
        t.copy_(torch.from_numpy(case["params"][name][rows]))
    gens = ensemble_generators(seeds[rows], "cpu")
    per_member = case.get("per_member_data", False)
    store = torch.from_numpy(case["store"]) if "store" in case else None
    lrs = case["lrs"][rows]

    def scalars(i):
        beta, mu, alpha, gamma = case["scalars"][i]
        return stack_scalars([StepScalars(beta, mu, alpha, gamma, lr)
                              for lr in lrs])

    def mine(batch):
        """This rank's members of per-member batches."""
        return tuple(b[rows] for b in batch) if per_member else batch

    metrics = []
    if case["kind"] == "multi":
        multi = make_ensemble_multi_step(state.model, da, tc,
                                         per_member_data=per_member,
                                         mesh=mesh)
        k = len(case["scalars"])
        sc = StepScalars(*(np.stack(f) for f in zip(
            *(scalars(i) for i in range(k)))))
        batch = case["stacked"]
        if per_member:
            batch = tuple(b[:, rows] for b in batch)
        state, m = multi(state, store, *batch[:3], store, *batch[3:], sc,
                         gens)
        metrics.append(m)
    else:
        gather = case["kind"] == "store"
        step = make_ensemble_step(state.model, da, tc,
                                  gather_on_device=gather,
                                  per_member_data=per_member, mesh=mesh)
        for i, batch in enumerate(case["batches"]):
            xs, ys, ms, xt, yt, mt = mine(batch)
            args = ((store, xs, ys, ms, store, xt, yt, mt) if gather
                    else (xs, ys, ms, xt, yt, mt))
            state, m = step(state, *args, scalars(i), gens)
            metrics.append(m)
    out = {"params": _numpy(state.params), "buffers": _numpy(state.buffers),
           "metrics": [_numpy(m) for m in metrics], "steps": state.step}
    if "val" in case:
        ev = make_ensemble_eval_step(state.model, gather_on_device=True,
                                     mesh=mesh)
        idx, y, mask = case["val"]
        got = ev(state, store, idx, y, mask)
        out.update({f"eval_{k}": got[k].cpu().numpy()
                    for k in ("loss", "top1", "n", "logits")})
    return out


def run_sweep_case(case, mesh=None) -> dict:
    """``run_sweep`` of ``case["members"]`` on the stores under
    ``case["root"]`` into ``case["out"]`` (rank 0 writes it)."""
    from ta3n_tpu_torch.data import FeatureStore, TSNLoader
    from ta3n_tpu_torch.train.sweep import run_sweep
    cfg = ModelConfig(**case["model"])
    tc = TrainConfig(**case["train"])
    bs, bt, bv = tc.batch_size
    stores = [FeatureStore.load(f"{case['root']}/{n}")
              for n in ("src", "tgt", "val")]
    loaders = [TSNLoader(st, batch_size=b, num_segments=cfg.train_segments,
                         shuffle=shuffle, seed=seed)
               for st, b, shuffle, seed in zip(stores, (bs, bt, bv),
                                               (True, True, False),
                                               (1, 2, 3))]
    out = run_sweep(cfg, DAConfig(**case["da"]), tc, *loaders,
                    case["members"], mesh=mesh, save_dir=case["out"],
                    eval_freq=1, log=lambda *a: None, device="cpu")
    return {"results": out["results"],
            "ensemble_top1": out["ensemble_top1"]}


def run_errors(case, mesh=None) -> dict:
    """The grids' refusals in a group of WORLD ranks: each message."""
    from ta3n_tpu_torch.parallel import make_mesh_2d
    from ta3n_tpu_torch.train.ensemble import make_ensemble_mesh
    out = {}
    for name, call in (("model_parallel", lambda: make_mesh_2d(
            model_parallel=case["bad"])),
                       ("member_shards", lambda: make_ensemble_mesh(
                           case["bad"])),
                       ("sweep_batch", lambda: run_sweep_case(
                           case["sweep"], make_ensemble_mesh(2)))):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def run_cases(spec, mesh=None) -> dict:
    step_mod._TP_MIN_SIZE = spec.get("tp_min_size", step_mod._TP_MIN_SIZE)
    run = {"ensemble": run_member_case, "stacked": run_stacked,
           "sweep": run_sweep_case, "errors": run_errors}
    return {name: run.get(case.get("runner"), run_case)(case, mesh)
            for name, case in spec["cases"].items()}


def _mesh(grid):
    from ta3n_tpu_torch.parallel import make_mesh, make_mesh_2d
    from ta3n_tpu_torch.train.ensemble import make_ensemble_mesh
    if grid[0] == "model":
        return make_mesh_2d(model_parallel=grid[1])
    if grid[0] == "member":
        return make_ensemble_mesh(grid[1])
    if grid[0] == "member_1d":
        return make_mesh()
    return None


def main(argv) -> int:
    spec_path, out_path, rank, world, init_file = argv
    torch.set_num_threads(1)
    from ta3n_tpu_torch.parallel.distributed import initialize_multihost
    initialize_multihost(f"file://{init_file}", int(world), int(rank),
                         backend="gloo")
    spec = torch.load(spec_path, weights_only=False)
    results = {}
    for grid, cases in spec["grids"].items():
        results[grid] = run_cases({**spec, "cases": cases}, _mesh(grid))
    torch.save(results, out_path)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
