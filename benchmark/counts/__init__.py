"""Operation and byte counts of one training step, from the configuration's
widths and the scene's sizes, one module per model family.

Each module gives ``model_flops(model_conf, shape)``, the multiply-adds of
the model's linears (two operations each) in the forward and backward pass,
nothing recomputed, and ``kernel_launches(model_conf, shape)``, the port's
kernel launches of one step as (kernel name, bytes, operations), one entry
per launch, named as the profiler names the kernel (the name after
``gasfm::``, without template arguments). A launch's bytes are the least it
can move: each input it reads once and each output it writes once, the
scratch rows that the port's kernels hand one another included; so the
roofline's bound is a lower bound of the true one.

``shape`` holds ``E`` (observations), ``n`` (points), ``m`` (cameras),
``pt_deg`` and ``cam_deg`` (observations per point and per camera, which
decide where a long segment is cut into parts and merged by a second
launch) and ``sms`` (the card's multiprocessors, which size the grids whose
blocks each write one partial row).
"""

from __future__ import annotations

import numpy as np

F32 = 4
IDX = 4
SMS = 132  # an H100 SXM's multiprocessors, where ``shape`` gives none

# the port's launch layouts (csrc/): rows a segment's part or chunk holds,
# blocks per multiprocessor of the grids that write partial rows
ATTEND_CHUNK = 32  # kAttendChunk: the attention's split
TRIPLE = 96  # kTriple: floats of a chunk's online-softmax triple
SUM_ROWS = 64  # kSumRows: the longest segment one lane group sums alone
SUM_PART_ROWS = 2048  # kSumPartRows: the rows of a long segment one block sums
TILE_ROWS = 32  # kTileRows: edges per tile
TILE_BLOCKS_PER_SM = 3  # kTileBlocksPerSm
DUAL_BWD_WARPS, DUAL_BWD_BLOCKS_PER_SM = 8, 3
POINT_WARPS, POINT_BWD_BLOCKS_PER_SM = 8, 4
FRONT_NARROW_DE, FRONT_NARROW_DQ = 2, 4
FRONT_SPAN_ROWS = 8 * TILE_ROWS
QUAD = 4  # points per warp of the attention's point side


def lin(rows: int, d_in: int, d_out: int) -> float:
    """Operations of a dense linear over ``rows`` rows."""
    return 2.0 * rows * d_in * d_out


def agg_width(d: int, heads: int) -> int:
    return d + (-d) % heads


def split(deg, rows: int, long_above: int = None) -> tuple:
    """(long segments, their parts): segments of more than ``long_above``
    (default ``rows``) observations are cut into parts of ``rows``."""
    long_above = rows if long_above is None else long_above
    d = np.asarray(deg)
    d = d[d > long_above]
    return int(d.size), int((-(-d // rows)).sum())


def grid(items: int, per_sm: int, shape: dict) -> int:
    return max(1, min(items, per_sm * shape.get("sms", SMS)))


def column_sum(rows: int, cols: int) -> tuple:
    """Partial rows summed by column."""
    return ("column_sum_kernel", F32 * (rows * cols + cols), float(rows * cols))


def gather_rows(S: int, D: int, E: int) -> tuple:
    """A table's rows gathered to the edges."""
    return ("gather_rows_kernel", F32 * (S * D + E * D) + IDX * E, 0.0)


def segment_sum(E: int, D: int, S: int, deg, camera: bool, combine_rows: int = 0) -> list:
    """Edge rows summed per segment (the camera side through its
    permutation), a hub's parts merged by a second launch; the segment max
    is the same walk and kernel, and moves the same bytes. ``combine_rows``:
    the edge combine's backward, which also writes the rows scaled and one
    partial row per block."""
    n_long, n_parts = split(deg, SUM_PART_ROWS, SUM_ROWS)
    hub = n_parts > n_long
    nbytes = F32 * (E * D + S * D) + IDX * (S + 1 + (E if camera else 0))
    nbytes += F32 * (E * D + combine_rows * D) if combine_rows else 0
    nbytes += F32 * n_parts * D if hub else 0
    out = [("segment_sum_kernel", nbytes, float(E * D))]
    if hub:
        out.append(("segment_sum_merge_kernel", F32 * (n_parts * D + n_long * D),
                    float(n_parts * D)))
    return out


def esfm_terms(shape: dict) -> list:
    """The ESFM loss's terms (#7) and their backward (#8), whose point and
    camera sums merge a hub's parts by further launches."""
    E, n, m = shape["E"], shape["n"], shape["m"]
    tables = F32 * (12 * m + 4 * n) + F32 * 2 * E + IDX * 2 * E
    out = [("esfm_terms_kernel", tables + F32 * 3 * -(-E // 1024) + F32 * 3, 40.0 * E)]
    nbytes = tables + IDX * (n + 1 + m + 1 + E) + F32 * (12 * m + 4 * n)
    merges = []
    for D, deg, S in ((12, shape["cam_deg"], m), (4, shape["pt_deg"], n)):
        n_long, n_parts = split(deg, SUM_PART_ROWS, SUM_ROWS)
        if n_parts > n_long:
            nbytes += F32 * n_parts * D
            merges.append(("segment_sum_merge_kernel", F32 * (n_parts + n_long) * D,
                           float(n_parts * D)))
    return out + [("esfm_terms_bwd_kernel", nbytes, 60.0 * E)] + merges


def repro_gathers(shape: dict) -> list:
    """our_repro's gathers of the cameras, points and normalizations."""
    E, n, m = shape["E"], shape["n"], shape["m"]
    return [gather_rows(m, 12, E), gather_rows(n, 4, E), gather_rows(m, 9, E)]


def dual_attend(shape: dict, Dp: int, Dc: int, heads: int) -> list:
    """Both GATv2 aggregations of a layer (#1): the core, with its softmax
    residuals, and the merge of the long segments' chunks."""
    E, n, m = shape["E"], shape["n"], shape["m"]
    lp, cp = split(shape["pt_deg"], ATTEND_CHUNK)
    lc, cc = split(shape["cam_deg"], ATTEND_CHUNK)
    reads = F32 * (E * (Dp + Dc) + n * Dp + m * Dc) + IDX * (n + m + 2 + E)
    writes = F32 * (n * Dp + m * Dc + 2 * heads * (n + m)) + F32 * TRIPLE * (cp + cc)
    out = [("dual_attend_kernel", reads + writes, 8.0 * E * (Dp + Dc))]
    if lp + lc:
        merged_rows = lp * (Dp + 2 * heads) + lc * (Dc + 2 * heads)
        out.append(("dual_attend_merge_kernel", F32 * (TRIPLE * (cp + cc) + merged_rows),
                    float(TRIPLE * (cp + cc))))
    return out


def dual_attend_bwd(shape: dict, Dp: int, Dc: int, heads: int) -> list:
    """The backward of both aggregations (#2): the core, the merge of the
    long points' and cameras' query gradients, the sum of the attention
    vectors' partial gradients."""
    E, n, m = shape["E"], shape["n"], shape["m"]
    lp, cp = split(shape["pt_deg"], ATTEND_CHUNK)
    lc, cc = split(shape["cam_deg"], ATTEND_CHUNK)
    blocks = grid(-(-(cc + cp + m + -(-n // QUAD)) // DUAL_BWD_WARPS), DUAL_BWD_BLOCKS_PER_SM,
                  shape)
    reads = F32 * (E * (Dp + Dc) + 3 * (n * Dp + m * Dc) + 2 * heads * (n + m))
    reads += IDX * (n + m + 2 + E)
    writes = F32 * (E * (Dp + Dc) + n * Dp + m * Dc + 64 * blocks + 32 * (cp + cc))
    out = [("dual_attend_bwd_kernel", reads + writes, 16.0 * E * (Dp + Dc))]
    if lp + lc:
        out.append(("dual_bwd_merge_kernel", F32 * 32 * (cp + cc + lp + lc), float(32 * (cp + cc))))
    return out + [column_sum(blocks, 64)]


def frontend(shape: dict, De: int, Dp: int, Dc: int) -> list:
    """The first layer's prologue (#3): the LayerNorm and the two source
    linears per edge."""
    E = shape["E"]
    narrow = De <= FRONT_NARROW_DE and max(Dp, Dc) <= FRONT_NARROW_DQ
    name = "frontend_fwd_narrow_kernel" if narrow else "frontend_fwd_tile_kernel"
    return [(name, F32 * E * (2 * De + Dp + Dc), E * (10.0 * De + 2.0 * De * (Dp + Dc)))]


def frontend_bwd(shape: dict, De: int, Dp: int, Dc: int) -> list:
    """Its backward (#4): the tile kernel, whose blocks each write a
    partial row of weight gradients, and their column sum."""
    E = shape["E"]
    narrow = De <= FRONT_NARROW_DE and max(Dp, Dc) <= FRONT_NARROW_DQ
    name = "frontend_bwd_narrow_kernel" if narrow else "frontend_bwd_tile_kernel"
    rows = FRONT_SPAN_ROWS if narrow else TILE_ROWS
    blocks = grid(-(-E // rows), TILE_BLOCKS_PER_SM, shape)
    row = (Dp + Dc) * (De + 1) + 2 * De
    nbytes = F32 * E * (De + Dp + Dc + De + De) + F32 * blocks * row
    return [(name, nbytes, E * (20.0 * De + 4.0 * De * (Dp + Dc))), column_sum(blocks, row)]


def layer_step(shape: dict, d_in: int, d2: int, De: int, Dp: int, Dc: int, raw: bool) -> list:
    """A layer's edge update fused with the next layer's prologue (#5):
    reads the stream, the skip, the residual and the point and camera rows,
    writes the update, its LayerNorm (not under ``raw``) and both source
    rows."""
    E, n, m = shape["E"], shape["n"], shape["m"]
    streams = E * (d_in + d2 + De + De + (0 if raw else De) + Dp + Dc)
    nbytes = F32 * (streams + (n + m) * De) + IDX * 2 * E
    flops = E * (2.0 * De * (d_in + d2) + 4.0 * De + 10.0 * De + 2.0 * De * (Dp + Dc))
    return [("layer_step_fwd_tile_kernel", nbytes, flops)]


def layer_step_bwd(shape: dict, d_in: int, d2: int, De: int, Dp: int, Dc: int, raw: bool,
                   de_l: bool) -> list:
    """Its backward (#6): the tile kernel (partial rows of the weight
    gradients), their column sum, and the point and camera sums of the
    update's cotangent."""
    E, n, m = shape["E"], shape["n"], shape["m"]
    blocks = grid(-(-E // TILE_ROWS), TILE_BLOCKS_PER_SM, shape)
    row = (Dp + Dc) * (De + 1) + De * (d_in + d2 + 1) + 2 * De
    reads = E * (d_in + d2 + De + Dp + Dc + (0 if raw else De) + (De if de_l else 0))
    writes = E * (De + d_in + d2) + blocks * row
    flops = E * (4.0 * De * (Dp + Dc) + 4.0 * De * (d_in + d2) + 30.0 * De)
    return ([("layer_step_bwd_tile_kernel", F32 * (reads + writes), flops), column_sum(blocks, row)]
            + segment_sum(E, De, n, shape["pt_deg"], False)
            + segment_sum(E, De, m, shape["cam_deg"], True))


def attend(shape: dict, D: int, heads: int, side: str) -> list:
    """One GATv2 aggregation: the point side's kernel and merge of its long
    points' chunks, or the camera side's kernel, a block per camera."""
    E = shape["E"]
    S = shape["n"] if side == "point" else shape["m"]
    nbytes = F32 * (E * D + 2 * S * D + 2 * heads * S) + IDX * (S + 1)
    if side == "camera":
        return [("attend_camera_kernel", nbytes + IDX * E, 8.0 * E * D)]
    n_long, n_chunks = split(shape["pt_deg"], ATTEND_CHUNK)
    out = [("attend_point_kernel", nbytes + F32 * TRIPLE * n_chunks, 8.0 * E * D)]
    if n_long:
        out.append(("attend_merge_kernel", F32 * (TRIPLE * n_chunks + n_long * (D + 2 * heads)),
                    float(TRIPLE * n_chunks)))
    return out


def attend_bwd(shape: dict, D: int, heads: int, side: str) -> list:
    """Its backward: the kernel, the merge of the long points' query
    gradients, the column sum of the attention vector's partial rows."""
    E = shape["E"]
    S = shape["n"] if side == "point" else shape["m"]
    nbytes = F32 * (2 * E * D + 4 * S * D + 2 * heads * S) + IDX * (S + 1)
    if side == "camera":
        return [("attend_camera_bwd_kernel", nbytes + IDX * E + F32 * 32 * S, 16.0 * E * D),
                column_sum(S, 32)]
    n_long, n_chunks = split(shape["pt_deg"], ATTEND_CHUNK)
    blocks = grid(-(-(-(-S // QUAD) + n_chunks) // POINT_WARPS), POINT_BWD_BLOCKS_PER_SM, shape)
    out = [("attend_point_bwd_kernel", nbytes + F32 * (32 * blocks + 32 * n_chunks),
            16.0 * E * D)]
    if n_long:
        out.append(("attend_bwd_merge_kernel", F32 * 32 * (n_chunks + n_long),
                    float(32 * n_chunks)))
    return out + [column_sum(blocks, 32)]


def edge_combine(shape: dict, D: int) -> list:
    """(pe + ps[pt] + pv[cam] + pg) / 4 per edge (#11)."""
    E, n, m = shape["E"], shape["n"], shape["m"]
    return [("edge_combine_kernel", F32 * (2 * E * D + (n + m + 1) * D) + IDX * 2 * E,
             3.0 * E * D)]


def edge_combine_bwd(shape: dict, D: int) -> list:
    """Its backward (#12): the point sums with the scaled rows and one
    partial row per block, the camera sums, the partial rows' column sum."""
    E, n, m = shape["E"], shape["n"], shape["m"]
    rows = split(shape["pt_deg"], SUM_PART_ROWS, SUM_ROWS)[1] + -(-n // 32)
    return (segment_sum(E, D, n, shape["pt_deg"], False, combine_rows=rows)
            + segment_sum(E, D, m, shape["cam_deg"], True) + [column_sum(rows, D)])


def base_name(kernel: str) -> str:
    """The profiler's kernel name as the counts name it: after ``gasfm::``,
    without its template arguments and signature."""
    name = kernel.split("gasfm::", 1)[1]
    return name.split("<", 1)[0].split("(", 1)[0]
