"""The port's kernel build on the CPU: what names the built library, the C
entry points against their ctypes bindings, and K3's choice of K slices
and, at bfloat16 compute, of its grid.  Nothing here compiles: nvcc runs
only where there is a card."""

import re

import pytest
import torch

from ta3n_tpu_torch.ops import _build, gather_gemm, trn_fused


def _csrc(tmp_path, files):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name, text in files.items():
        (csrc / name).write_text(text)
    return csrc


@pytest.mark.parametrize("edited", ["kernel.cu", "shared.cuh"])
def test_library_name_follows_every_source_and_header(tmp_path, monkeypatch,
                                                      edited):
    """An edit to a .cu or to a header it includes names another library,
    so a stale build is never loaded; undoing the edit names the first."""
    csrc = _csrc(tmp_path, {"kernel.cu": '#include "shared.cuh"\n',
                            "shared.cuh": "// helpers\n"})
    monkeypatch.setattr(_build, "_CSRC", csrc)
    first = _build.library_path()
    original = (csrc / edited).read_text()
    (csrc / edited).write_text(original + "// edited\n")
    assert _build.library_path() != first
    (csrc / edited).write_text(original)
    assert _build.library_path() == first


def test_library_name_counts_a_new_header(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, {"kernel.cu": "\n"})
    monkeypatch.setattr(_build, "_CSRC", csrc)
    first = _build.library_path()
    (csrc / "extra.cuh").write_text("\n")
    assert _build.library_path() != first


def test_every_kernel_source_is_compiled():
    """SOURCES lists every .cu under csrc/ (headers are included, not
    compiled), so a new kernel file cannot be left out of the build."""
    on_disk = sorted(p.name for p in _build._CSRC.glob("*.cu"))
    assert sorted(p.name for p in _build.SOURCES) == on_disk
    assert list(_build._CSRC.glob("*.cuh"))


def _c_entries():
    """name -> number of parameters of every extern "C" function."""
    found = {}
    for src in _build.SOURCES:
        for name, params in re.findall(
                r'extern "C" int (\w+)\((.*?)\)\s*\{', src.read_text(),
                re.S):
            found[name] = params.count(",") + 1
    return found


def test_c_entries_match_their_bindings():
    """Every C entry the wrappers call is defined, with as many parameters
    as its ctypes argtypes: a mismatch would pass garbage, not raise."""
    entries = _c_entries()
    assert set(entries) == set(_build._ENTRIES)
    for name, argtypes in _build._ENTRIES.items():
        assert entries[name] == len(argtypes), name


def test_bf16_scale_limit_is_the_kernels():
    """The wrapper's limit on the bfloat16 TRN kernels' scales is the
    capacity of the weight maps they take as a kernel parameter."""
    text = (_build._CSRC / "wgmma_bf16.cuh").read_text()
    limit, = re.findall(r"constexpr int kMaxWeightMaps = (\d+);", text)
    assert trn_fused.BF16_MAX_SCALES == int(limit)


@pytest.mark.parametrize("m,h,chunks", [
    (640, 512, 64), (370, 512, 64), (320, 512, 64), (37, 512, 64),
    (1, 512, 64), (45, 96, 2), (20000, 512, 64)])
def test_gather_splits_fill_at_most_the_target(m, h, chunks):
    """K3's K slices: 1..8, at most one per chunk, and the grid within
    _TARGET_BLOCKS unless one slice per tile already exceeds it."""
    splits = gather_gemm._splits(m, h, chunks)
    tiles = -(-m // gather_gemm._TILE_M) * -(-h // gather_gemm._TILE_H)
    assert 1 <= splits <= min(gather_gemm._MAX_SPLITS, chunks)
    assert splits == 1 or tiles * splits <= gather_gemm._TARGET_BLOCKS
    if (m, h) == (640, 512):
        assert (splits, tiles * splits) == (3, 240)


@pytest.mark.parametrize("n,streams,k,d,h,store", [
    (640, 1, 1, 2048, 512, "bf16"), (370, 1, 1, 2048, 512, "int8"),
    (320, 1, 1, 2048, 512, "f32"), (1, 1, 1, 2048, 512, "int8"),
    (63, 1, 1, 512, 128, "bf16"), (65, 1, 1, 512, 500, "f32"),
    (1010, 1, 1, 512, 500, "int8"), (30, 2, 2, 256, 96, "bf16"),
    (21, 2, 1, 256, 96, "int8"), (45, 1, 1, 37, 19, "f32"),
    (20, 2, 2, 22, 33, "bf16"), (70, 1, 3, 100, 1024, "int8"),
    (20000, 1, 1, 2048, 512, "bf16"), (640, 5, 5, 2048, 64, "f32")])
def test_bf16_grid_covers_every_tile_and_chunk_once(n, streams, k, d, h,
                                                    store):
    """K3 at bfloat16 compute: the grid's row and column tiles cover M and
    H exactly (64 x 128 tiles), within CUDA's grid limits; the K slices
    number 1 to min(8, chunks), each non-empty, and the kernel's slice
    bounds (chunks * z / splits) give every 64-deep chunk to one slice;
    K is split only while the grid stays within the blocks the card
    holds."""
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}[store]
    m = n * streams // k
    tiles_m, tiles_h, splits = gather_gemm.bf16_grid(m, h, d, k, dtype)
    tm, tn = gather_gemm._BF16_TILE_M, gather_gemm._BF16_TILE_N
    assert (tiles_m - 1) * tm < m <= tiles_m * tm
    assert (tiles_h - 1) * tn < h <= tiles_h * tn
    assert tiles_m <= 2 ** 31 - 1 and tiles_h <= 65535
    chunks = k * -(-d // gather_gemm._BF16_TILE_K)
    assert 1 <= splits <= min(gather_gemm._MAX_SPLITS, chunks)
    owner = []
    for z in range(splits):
        begin, end = chunks * z // splits, chunks * (z + 1) // splits
        assert end > begin
        owner.extend([z] * (end - begin))
    assert owner == sorted(owner) and len(owner) == chunks
    held = gather_gemm._SMS * gather_gemm._BF16_BLOCKS_PER_SM[dtype]
    assert splits == 1 or tiles_m * tiles_h * splits <= held
    if (m, h, store) == (640, 512, "bf16"):
        assert (tiles_m, tiles_h, splits) == (10, 4, 6)


@pytest.mark.parametrize("s,b,d,h", [
    (5, 202, 512, 256), (5, 64, 512, 256), (5, 1, 512, 256),
    (5, 0, 512, 256), (17, 202, 512, 256), (25, 13, 37, 19),
    (4, 65, 100, 129), (33, 3, 16, 8)])
def test_bf16_bwd_grid_covers_every_tile_once(s, b, d, h):
    """K2 in bfloat16: the grid that bf16_bwd_grid chooses, decoded as
    trn_fused_bwd_bf16.cu's kernel decodes blockIdx.x (dx blocks first:
    frame, then 64-video row tile, then 128-column D tile; then the dW/db
    blocks: unit, then 64-row H tile, then D tile), covers every dx tile
    of every frame and every (unit, dW tile) exactly once, with db summed
    by one block per (scale, H tile); the blocks within CUDA's limit on
    gridDim.x (the members, blockIdx.y, are at most 65535, which the C
    entry checks)."""
    dx_blocks, dw_blocks = trn_fused.bf16_bwd_grid(s, 3, b, d, h)
    tm, tn = trn_fused._BF16_BWD_TILE_M, trn_fused._BF16_BWD_TILE_N
    tiles_b, tiles_d, tiles_h = -(-b // tm), -(-d // tn), -(-h // tm)
    units = trn_fused._fwd_units(s, 3)
    assert dx_blocks + dw_blocks <= 2 ** 31 - 1
    dx_seen, dw_seen, db_seen = [], [], []
    for blk in range(dx_blocks + dw_blocks):
        if blk < dx_blocks:
            f, rem = divmod(blk, tiles_b * tiles_d)
            dx_seen.append((f, rem // tiles_d * tm, rem % tiles_d * tn))
        else:
            z, rem = divmod(blk - dx_blocks, tiles_h * tiles_d)
            h0, d0 = rem // tiles_d * tm, rem % tiles_d * tn
            dw_seen.append((z, h0, d0))
            scale, p, _ = units[z]
            if p == 0 and d0 == 0:
                db_seen.append((scale, h0))
    assert sorted(dx_seen) == [(f, b0, d0) for f in range(s)
                               for b0 in range(0, b, tm)
                               for d0 in range(0, d, tn)]
    assert sorted(dw_seen) == [(z, h0, d0) for z in range(len(units))
                               for h0 in range(0, h, tm)
                               for d0 in range(0, d, tn)]
    assert sorted(db_seen) == [(i, h0) for i in range(s - 1)
                               for h0 in range(0, h, tm)]
