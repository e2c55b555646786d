"""A cell at a size the CPU holds: the flagship's and the comparison
row's structure (trn-m with TransAttn, avgpool without) at narrow widths,
a few dozen videos and eight members."""

import copy

from bench_port import manifest


def small_cell(config: str = "ucf_hmdb_full", members: int = 8) -> dict:
    cell = manifest.resolve(f"{config}.sweep")
    cell = copy.deepcopy(cell)
    cfg = cell["model"]
    cfg["model"].update(feature_dim=64, fc_dim=32)
    cfg["data"].update(num_source=40, num_target=30, num_val=20,
                       min_frames=3, max_frames=12)
    cfg["train"].update(batch_size=[8, 6, 8], epochs=3)
    cell["traffic"].update(members=members, lr_exponents=[-1, 0, 1, 2],
                           trace_epochs=1, device_epochs=1)
    return cell
