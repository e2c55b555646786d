"""The port's kernel build on the CPU: what names the built library, the C
entry points against their ctypes bindings, and K3's plans at float32 and
bfloat16 compute (stage A's threads, stage B's grid and K slices, pitch,
scratch).  Nothing here compiles: nvcc runs only where there is a
card."""

import re

import numpy as np
import pytest

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


@pytest.mark.parametrize("source,stages,stage_boxes", [
    ("trn_fused_fwd.cu", 4, (4, 4, 4)), ("trn_fused_bwd.cu", 4, (4, 4, 4))])
def test_f32_trn_sources_match_their_plans(source, stages, stage_boxes):
    """The float32 TRN kernels as the wrappers plan them: the shared tile,
    chunk, cluster and weight-map limits of tf32_wgmma.cuh and
    wgmma_bf16.cuh are ops/trn_fused.py's; K1's video tiles by batch are
    _f32_fwd_width's; each kernel's ring (K1: W's box and relu(x)'s hi and
    lo boxes of 128 rows; K2: A's 16 KB, W's four boxes of 32 rows or
    m^T's one of 128, and B's hi and lo of 128) fits the 227 KB opt-in with one block an SM,
    and holds the partial tile (and K2's db rows) it is reused for."""
    shared = (_build._CSRC / "tf32_wgmma.cuh").read_text()
    consts = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                  shared).group(1))
              for name in ("kTile", "kTileK", "kMaxSplits")}
    assert (consts["kTile"], consts["kTileK"]) == (trn_fused._F32_TILE,
                                                   trn_fused._F32_TILE_K)
    assert consts["kMaxSplits"] == len(trn_fused._F32_CLUSTERS)
    maps = re.search(r"constexpr int kMaxWeightMaps = (\d+);",
                     (_build._CSRC / "wgmma_bf16.cuh").read_text())
    assert int(maps.group(1)) == trn_fused._F32_MAP_SCALES
    text = (_build._CSRC / source).read_text()
    assert int(re.search(r"constexpr int kStages = (\d+);",
                         text).group(1)) == stages
    if source == "trn_fused_fwd.cu":
        assert "for (int n = 8; n <= 64; n *= 2)" in text
        for b in range(1, 300):
            want = next((n for n in (8, 16, 32, 64) if b <= n), 128)
            assert trn_fused._f32_fwd_width(b) == want
    quarter = 32 * 128  # a box of 32 rows of 128 bytes
    stage = sum(stage_boxes) * quarter
    smem = stages * stage + 2 * stages * 8 + 1024
    assert smem <= 232448 and 2 * smem > 228 * 1024
    assert 128 * (128 + 4) * 4 + 128 * 4 <= stages * stage


@pytest.mark.parametrize("m,h,chunks", [
    (640, 512, 64), (370, 512, 64), (320, 512, 64), (37, 512, 64),
    (1, 512, 64), (45, 96, 2), (20000, 512, 64)])
def test_gather_splits_fill_at_most_the_target(m, h, chunks):
    """K3's K slices at float32 compute (f32_plan, over 32-deep chunks of
    k*D = 32 * chunks): 1..16, at most one per chunk, one member's tiles
    in clusters of that many blocks all resident at once on the H100
    (_F32_CLUSTERS, which holds as many single blocks as SMs) unless even
    one slice a tile takes more than one wave; no larger count within
    the limits keeps them so.  At the flagship train shape 5 slices over
    20 tiles, 100 blocks; at the eval shape 8 over 12."""
    plan = gather_gemm.f32_plan(m, h, 32 * chunks, 1)
    splits, tiles = plan.splits, plan.row_tiles * plan.col_tiles
    held = gather_gemm._F32_CLUSTERS
    assert held[0] == gather_gemm._SMS and len(held) == 16
    assert 1 <= splits <= min(len(held), chunks)
    assert splits == 1 or tiles <= held[splits - 1]
    for more in range(splits + 1, min(len(held), chunks) + 1):
        assert tiles > held[more - 1]
    if (m, h) == (640, 512):
        assert (splits, tiles * splits) == (5, 100)
    if (m, h) == (320, 512):
        assert (splits, tiles * splits) == (8, 96)


def _f32_source_constants():
    """Stage A's threads a block and stage B's tiles, chunk, ring, slices
    and registers as csrc/gather_gemm.cu declares them."""
    text = (_build._CSRC / "gather_gemm.cu").read_text()
    consts = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                  text).group(1))
              for name in ("kRowsThreads", "kTileH", "kTileM", "kTileK",
                           "kMaxSplits", "kStages")}
    regs = re.search(r"constexpr int kProducerRegs = (\d+), "
                     r"kConsumerRegs = (\d+);", text).groups()
    return consts | {"kProducerRegs": int(regs[0]),
                     "kConsumerRegs": int(regs[1])}


def _check_f32_plan(n, streams, k, d, h, members=1, per_member=False):
    """K3 at float32 compute: the plan's stage A gives every (gathered row,
    16-byte piece of 4 values) of each index set to one thread, and the
    pieces' places in x_res and in each plane's rows of ``pitch`` values
    are each written once; stage B's grid (row tile x column tile,
    member, K slice), decoded as the kernel decodes it, covers every
    (member, row tile, column tile) of one member's M x H once, its
    column tiles within the member, within CUDA's grid limits and a
    cluster of at most 8; the K slices (a power of two) give every
    32-deep chunk of k*D to one slice, one cluster a tile (of at most
    the kernel's 16 blocks, resident at once by _F32_CLUSTERS), and do
    not depend on N; stage B's shared memory within the opt-in, one
    block an SM, and its registers (two consumer warpgroups raised by
    setmaxnreg, a producer warpgroup lowered) within the SM's 65,536;
    scratch is the two planes, then W's rows only where TMA cannot take
    the weight's.  Returns the plan."""
    m = n * streams // k
    plan = gather_gemm.f32_plan(m, h, d, k, members, per_member)
    src = _f32_source_constants()
    tm, tn, tk = src["kTileM"], src["kTileH"], src["kTileK"]
    assert (tm, tn, tk) == (gather_gemm._F32_TILE_M,
                            gather_gemm._F32_TILE_N,
                            gather_gemm._F32_TILE_K)
    assert src["kMaxSplits"] == len(gather_gemm._F32_CLUSTERS)
    # stage A
    pieces, q_rows = -(-d // 4), m * k
    threads = src["kRowsThreads"]
    assert threads == gather_gemm._F32_ROWS_THREADS
    assert (plan.rows_blocks - 1) * threads < q_rows * pieces \
        <= plan.rows_blocks * threads
    assert plan.rows_blocks <= 2 ** 31 - 1
    assert plan.index_sets == (members if per_member else 1) <= 65535
    kd = k * d
    assert plan.pitch % 4 == 0 and kd <= plan.pitch < kd + 4
    if q_rows * pieces <= 1 << 20:
        p = np.arange(q_rows * pieces)
        q, col = p // pieces, p % pieces * 4
        assert q.max() == q_rows - 1 and np.all(np.bincount(
            q, minlength=q_rows) == pieces)
        width = np.minimum(4, d - col)
        for start in (q * d + col,
                      q // k * plan.pitch + q % k * d + col):
            order = np.argsort(start)
            s, w = start[order], width[order]
            assert np.all(s[:-1] + w[:-1] <= s[1:])  # each value once
        assert width.sum() == q_rows * d
    # stage B
    assert (plan.row_tiles - 1) * tm < m <= plan.row_tiles * tm
    assert (plan.col_tiles - 1) * tn < h <= plan.col_tiles * tn
    assert plan.row_tiles * plan.col_tiles <= 2 ** 31 - 1
    assert m <= 2 ** 31 - 1  # TMA's row coordinate
    assert plan.members == members <= 65535
    seen = set()
    for x in range(plan.row_tiles * plan.col_tiles):
        row_tile, col_tile = divmod(x, plan.col_tiles)
        for member in range(members):
            assert col_tile * tn < h
            seen.add((member, row_tile, col_tile))
    assert len(seen) == members * plan.row_tiles * plan.col_tiles
    chunks = -(-kd // tk)
    splits = plan.splits
    assert 1 <= splits <= min(src["kMaxSplits"], chunks)
    assert splits == 1 or plan.row_tiles * plan.col_tiles \
        <= gather_gemm._F32_CLUSTERS[splits - 1]
    owner = []
    for z in range(splits):
        begin, end = chunks * z // splits, chunks * (z + 1) // splits
        assert end > begin
        owner.extend([z] * (end - begin))
    assert owner == sorted(owner) and len(owner) == chunks
    for other in (1, 4, 8):
        assert gather_gemm.f32_plan(m, h, d, k, other,
                                    per_member).splits == splits
    # stage B's shared memory: the ring (W, hi and lo boxes of 128 rows of
    # 128 bytes) and its mbarriers, one block an SM; the partial tile
    # [128 rows, 128 + 4] over the ring
    box, stages = 128 * 128, src["kStages"]
    smem = stages * 3 * box + 2 * stages * 8 + 1024
    assert smem <= 232448 and 2 * smem > 228 * 1024
    assert tm * (tn + 4) * 4 <= stages * 3 * box
    assert 2 * 128 * src["kConsumerRegs"] + 128 * src["kProducerRegs"] \
        <= 65536
    # scratch: the hi and lo planes, then W's rows where they are not
    # 16-byte aligned
    planes = 2 * plan.index_sets * m * plan.pitch
    for weight_ok in (True, False):
        got = gather_gemm.f32_plan(m, h, d, k, members, per_member,
                                   weight_ok).scratch
        assert got == planes + (0 if kd % 4 == 0 and weight_ok
                                else members * h * plan.pitch)
    return plan


@pytest.mark.parametrize("n,streams,k,d,h", [
    (640, 1, 1, 2048, 512), (370, 1, 1, 2048, 512), (320, 1, 1, 2048, 512),
    (1, 1, 1, 2048, 512), (63, 1, 1, 512, 128), (65, 1, 1, 512, 500),
    (1010, 1, 1, 512, 500), (30, 2, 2, 256, 96), (21, 2, 1, 256, 96),
    (45, 1, 1, 37, 19), (20, 2, 2, 22, 33), (70, 1, 3, 100, 1024),
    (70, 1, 1, 50, 96), (20000, 1, 1, 2048, 512), (640, 5, 5, 2048, 64)])
def test_f32_grid_covers_every_tile_and_chunk_once(n, streams, k, d, h):
    """K3 at float32 compute, one member, at the shapes of its paths and of
    its card tests (the plan does not depend on the store): _check_f32_plan.
    At the flagship train shape (640 x 512, D = 2048) stage A runs 1280
    blocks and stage B 5 x 4 tiles of 128 x 128 in 5 K slices of 12-13
    chunks: 100 blocks in clusters of 5; at the eval shape (320 rows) 3 x
    4 tiles in 8 slices: 96 blocks."""
    plan = _check_f32_plan(n, streams, k, d, h)
    if (n, d, h) == (640, 2048, 512):
        assert (plan.rows_blocks, plan.row_tiles, plan.col_tiles,
                plan.splits) == (1280, 5, 4, 5)
    if (n, d, h) == (320, 2048, 512):
        assert (plan.row_tiles, plan.col_tiles, plan.splits) == (3, 4, 8)
    if k * d % 4:  # rows TMA cannot take as they are: padded
        assert plan.pitch > k * d


@pytest.mark.parametrize("per_member", [False, True],
                         ids=["shared", "per_member"])
@pytest.mark.parametrize("members", [1, 4, 8])
@pytest.mark.parametrize("n,streams,k,d,h", [
    (640, 1, 1, 2048, 512), (370, 1, 1, 2048, 256), (320, 1, 1, 2048, 128),
    (37, 1, 1, 37, 19)])
def test_f32_plan_members_cover_every_tile_once(n, streams, k, d, h,
                                                members, per_member):
    """The member axis of K3 at float32 compute: N = 1, 4, 8 members with
    one index set for all or one each, at the train shape, the column
    slices of tensor parallelism (H = 256, 128) and ragged widths:
    _check_f32_plan, with stage A over one index set when the members
    share it, so the planes' scratch does not grow with N."""
    plan = _check_f32_plan(n, streams, k, d, h, members, per_member)
    assert plan.index_sets == (members if per_member else 1)
    if not per_member:
        assert plan.scratch == gather_gemm.f32_plan(
            n * streams // k, h, d, k).scratch + (
                0 if k * d % 4 == 0 else (members - 1) * h * plan.pitch)


def _bf16_source_constants():
    """Stage A's threads a block and stage B's tile, chunk and ring as
    csrc/gather_gemm_bf16.cu declares them."""
    text = (_build._CSRC / "gather_gemm_bf16.cu").read_text()
    fold, ring = re.search(
        r"kStages = kFold \? (\d+) : (\d+);", text).groups()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                text).group(1))
            for name in ("kRowsThreads", "kTileM", "kTileN", "kTileK",
                         "kMaxSplits")} | {
        "kStages": int(ring), "kFoldStages": int(fold),
        "kSmemSpread": int(re.search(
            r"constexpr int kSmemSpread = (\d+) \* 1024;", text).group(1))
        * 1024}


def _check_bf16_plan(n, streams, k, d, h, members=1, per_member=False):
    """K3 at bfloat16 compute: the plan's stage A gives every (gathered
    row, 16-byte piece) of each index set to one thread, and the pieces'
    places in x_res and in A's rows of ``pitch`` values are each written
    once; stage B's grid (row tile x column tile, member, K slice),
    decoded as the kernel decodes it, covers every (member, row tile,
    column tile) of one member's M x H once, its column tiles within
    the member (no tile runs into the next member's columns), within
    CUDA's grid limits and a cluster of at most 8; the K slices (a power
    of two) give every 64-deep chunk of k*D to one slice and do not
    depend on N (whether a cluster or one block runs a tile's slices,
    and how many blocks an SM holds, may); stage B's shared memory
    within the opt-in; scratch is A's rows then W's, each only where TMA
    cannot take the caller's rows.  Returns the plan."""
    m = n * streams // k
    plan = gather_gemm.bf16_plan(m, h, d, k, members, per_member)
    src = _bf16_source_constants()
    tm, tn, tk = src["kTileM"], src["kTileN"], src["kTileK"]
    assert (tm, tn, tk) == (gather_gemm._BF16_TILE_M,
                            gather_gemm._BF16_TILE_N,
                            gather_gemm._BF16_TILE_K)
    # stage A
    pieces, q_rows = -(-d // 8), m * k
    threads = src["kRowsThreads"]
    assert threads == gather_gemm._BF16_ROWS_THREADS
    assert (plan.rows_blocks - 1) * threads < q_rows * pieces \
        <= plan.rows_blocks * threads
    assert plan.rows_blocks <= 2 ** 31 - 1
    assert plan.index_sets == (members if per_member else 1) <= 65535
    kd = k * d
    assert plan.pitch % 8 == 0 and kd <= plan.pitch < kd + 8
    if q_rows * pieces <= 1 << 20:
        p = np.arange(q_rows * pieces)
        q, col = p // pieces, p % pieces * 8
        assert q.max() == q_rows - 1 and np.all(np.bincount(
            q, minlength=q_rows) == pieces)
        width = np.minimum(8, d - col)
        for start in (q * d + col,
                      q // k * plan.pitch + q % k * d + col):
            order = np.argsort(start)
            s, w = start[order], width[order]
            assert np.all(s[:-1] + w[:-1] <= s[1:])  # each value once
        assert width.sum() == q_rows * d
    # stage B
    assert (plan.row_tiles - 1) * tm < m <= plan.row_tiles * tm
    assert (plan.col_tiles - 1) * tn < h <= plan.col_tiles * tn
    assert plan.row_tiles * plan.col_tiles <= 2 ** 31 - 1
    assert plan.members == members <= 65535
    seen = set()
    for x in range(plan.row_tiles * plan.col_tiles):
        row_tile, col_tile = divmod(x, plan.col_tiles)
        for member in range(members):
            assert col_tile * tn < h  # the tile's first column is its own
            seen.add((member, row_tile, col_tile))
    assert len(seen) == members * plan.row_tiles * plan.col_tiles
    chunks = -(-kd // tk)
    splits = plan.splits
    assert splits & (splits - 1) == 0
    assert 1 <= splits <= min(src["kMaxSplits"], chunks)
    owner = []
    for z in range(splits):
        begin, end = chunks * z // splits, chunks * (z + 1) // splits
        assert end > begin
        owner.extend([z] * (end - begin))
    assert owner == sorted(owner) and len(owner) == chunks
    assert splits == 1 or plan.row_tiles * plan.col_tiles * splits \
        <= gather_gemm._SMS
    for other in (1, 4, 8):
        assert gather_gemm.bf16_plan(m, h, d, k, other,
                                     per_member).splits == splits
    # stage B's shared memory within the 227 KB opt-in: its ring (A and W
    # boxes of 128 rows of 128 bytes), two blocks an SM; more than half an
    # SM where it spreads its blocks one an SM; and the folded blocks' ring
    # and their running sum, one an SM
    ring, fold = src["kStages"], src["kFoldStages"]
    smem = ring * 2 * tm * 128 + 2 * ring * 8 + 1024
    assert 2 * (smem + 1024) <= 228 * 1024
    assert smem <= src["kSmemSpread"] <= 232448
    assert 2 * (src["kSmemSpread"] + 1024) > 228 * 1024
    assert fold * 2 * tm * 128 + 2 * fold * 8 + 256 * 64 * 4 + 1024 \
        <= 232448
    # scratch: none where x_res and W are 16-byte aligned rows
    sets = plan.index_sets
    a_rows, w_rows = sets * m * plan.pitch, members * h * plan.pitch
    for rows_ok in (True, False):
        for weight_ok in (True, False):
            got = gather_gemm.bf16_plan(m, h, d, k, members, per_member,
                                        rows_ok, weight_ok).scratch
            direct = kd % 8 == 0
            assert got == (0 if direct and rows_ok else a_rows) + (
                0 if direct and weight_ok else w_rows)
    return plan


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
    """K3 at bfloat16 compute, one member, at the shapes of every store
    dtype's paths (the plan does not depend on the store: stage A reads
    each in its own type): _check_bf16_plan.  At the flagship train shape
    (640 x 512, D = 2048) stage A runs 640 blocks and stage B 5 x 4 tiles
    of 128 x 128 in 4 K slices of 8 chunks: 80 blocks."""
    plan = _check_bf16_plan(n, streams, k, d, h)
    if (n, d, h, store) == (640, 2048, 512, "bf16"):
        assert (plan.rows_blocks, plan.row_tiles, plan.col_tiles,
                plan.splits) == (640, 5, 4, 4)


@pytest.mark.parametrize("per_member", [False, True],
                         ids=["shared", "per_member"])
@pytest.mark.parametrize("members", [1, 4, 8])
@pytest.mark.parametrize("n,streams,k,d,h", [
    (640, 1, 1, 2048, 512), (370, 1, 1, 2048, 256), (37, 1, 1, 37, 19)])
def test_bf16_plan_members_cover_every_tile_once(n, streams, k, d, h,
                                                 members, per_member):
    """The member axis of K3 at bfloat16 compute: N = 1, 4, 8 members with
    one index set for all or one each, at the train shape, a column slice
    of tensor parallelism and ragged widths: _check_bf16_plan, with stage
    A over one index set when the members share it."""
    plan = _check_bf16_plan(n, streams, k, d, h, members, per_member)
    assert plan.index_sets == (members if per_member else 1)


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
