"""The schedules of the dual core's forward (#1) and of the CSR segment sum
(#15/#18) on split segments, as plain PyTorch models, against the JAX
package's Pallas kernels in interpret mode; and the host-side split they
read.

The card's kernels walk both CSRs split by length (``ViewGraph.pt_chunks``
/ ``cam_chunks``): a segment longer than the split length is cut into
chunks, each chunk is reduced on its own, and a second launch merges a long
segment's chunks in order. The models here do the same in float32 on the
CPU, so the two-level order the kernels sum in is held against the
reference at a small size:

- the dual forward: each chunk's online triple (m, den, num) per head,
  merged in chunk order as ``Online::merge`` does (csrc/common.cuh); its
  outputs against the JAX ``gatv2_attend_dual`` (``fused_dual_attend``,
  ``_dual_fwd_raw``), and its m bitwise the plain path's segment max of the
  same logits;
- the segment sum: a short segment (at most 64 rows) summed alone, a long
  one's parts each
  summed on its own, then a hub's parts in the merge launch's order
  (kSumMergeWarps contiguous runs, each in part order, then the runs in
  order), against the JAX segment-sum kernels (``windowed_segment_sum``
  for the points, ``segment_sum_kernel`` for the cameras) at D = 2, 4, 32
  and 256;
- the split at the sum's and the dual core's length covers every edge of
  every segment exactly once, on both CSRs;
- on ``check_graphs.hub_parts_graph`` the sum's split cuts the hub point
  into three parts, and the model's sum agrees with the plain version;
- the segment max (#17/#19), the same walk with fmaxf from -inf in place of
  the add (csrc/segment.cuh ``MaxRed``): the model on the sum's split,
  bitwise against the JAX max kernels (``segment_max_kernel`` /
  ``_segment_max_raw`` for the cameras, ``windowed_segment_max`` /
  ``_wseg_max_raw`` for the points) at D = 1, 4 and 8, neutral -inf and
  -7.5 (the empty segments', real and padded), also on a split into parts
  of 16 rows, and bitwise against the plain version on ``hub_parts_graph``
  (a point of three parts, merged by max);
- the edge combine's backward (#12), whose point pass is the segment sum's
  walk with its COMBINE flag (csrc/segment.cuh): d pe = g / 4 from the same
  read, d ps the sum's model at scale 1/4, and d pg the column sum
  (``column_sum_model``: csrc/common.cuh's ``column_sum_kernel`` order) of
  one partial row per block of the walk, each the sum of the rows its
  short points or its part hold. Against the JAX kernel's VJP
  (``gasfm_tpu/ops/pallas/fused_update.py`` ``fused_edge_combine``,
  ``_bwd_raw``) at D = 2, 4, 32 and 256 on this scene and on
  ``hub_parts_graph`` (in the JAX kernels' blocked edge layout, built here);
  and the walk's blocks (parts, then runs of short points) cover every edge
  exactly once on a graph of 19,001 edges (a prime) with points of 0-65,
  100 and 2,047-4,500 edges.

The scene: 45 views and 300 points (visibility 0.4: most cameras have more
than 32 edges, a few fewer), point HUB seen by 40 views, point EMPTY_POINT
and camera EMPTY_CAMERA without edges. Inputs are drawn per real edge with
numpy and scattered into both layouts. Tolerances as in
tests/test_torch_port_kernels.py: |err| <= 1e-5 x the reference's scale +
1e-4 x |ref| (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.graph.view_graph import build_scene_graph as jax_build_scene_graph
from gasfm_tpu.ops import segment as jseg
from gasfm_tpu.ops.gatv2 import gatv2_attend_dual as jax_attend_dual
from gasfm_tpu.graph.view_graph import WINDOW
from gasfm_tpu.ops.pallas import fused_dual_attn as jax_fda
from gasfm_tpu.ops.pallas import fused_update as jax_fused_update
from gasfm_tpu.ops.pallas import segment_kernels as jax_segment_kernels

from gasfm_tpu_torch.graph.check_graphs import graph_of_edges, hub_parts_graph
from gasfm_tpu_torch.graph.view_graph import build_scene_graph
from gasfm_tpu_torch.ops.gatv2 import NEGATIVE_SLOPE, leaky_relu
from gasfm_tpu_torch.ops.kernels.fused_dual_attn import SPLIT_ROWS, fused_dual_attend_plain
from gasfm_tpu_torch.ops.kernels.fused_update import fused_edge_combine_plain
from gasfm_tpu_torch.ops.kernels.segment_kernels import (SUM_PART_ROWS, SUM_ROWS,
                                                         segment_max_plain, segment_sum_plain,
                                                         side_ids)
from gasfm_tpu_torch.ops.segment import segment_max

HEADS = 4
HUB, EMPTY_POINT, EMPTY_CAMERA = 11, 20, 7
SUM_MERGE_WARPS = 8  # kSumMergeWarps of csrc/segment.cuh: the runs of the hubs' merge
SUM_BLOCK_WARPS = 32  # kSumBlockWarps: warps per block of the sum's main launch
SUM_RUN = 4  # kSumRun: short points per warp (W = 32) or lane group (COMBINE, W < 32) in turn
COLUMN_SUM_GROUPS = 8  # kSumGroups of csrc/common.cuh: the column sum's interleaved row groups
JAX_SUM = {"point": "windowed_segment_sum", "camera": "segment_sum_kernel"}
JAX_MAX_RAW = {"point": "_wseg_max_raw", "camera": "_segment_max_raw"}
F32 = torch.float32  # explicit: another test module may change the default dtype


@pytest.fixture(autouse=True)
def _interpret_mode():
    jseg.set_kernel_mode("interpret")
    yield
    jseg.set_kernel_mode("auto")


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, port scene, the JAX real-edge mask)."""
    data = jax_synthetic_scene(n_views=45, n_points=300, visibility=0.4, seed=21)
    M = data.M.copy()
    rng = np.random.default_rng(22)
    views = rng.choice([v for v in range(45) if v != EMPTY_CAMERA], size=40, replace=False)
    M[:, HUB] = 0.0
    for v in views:
        M[2 * v:2 * v + 2, HUB] = rng.uniform(400.0, 600.0, 2)
    M[:, EMPTY_POINT] = 0.0
    M[2 * EMPTY_CAMERA:2 * EMPTY_CAMERA + 2] = 0.0
    jscene = jax_build_scene_graph(M, data.Ns, data.y)
    pscene = build_scene_graph(M, data.Ns, data.y, device="cpu")
    jg, pg = jscene.graph, pscene.graph
    mask = np.asarray(jg.edge_mask)
    assert mask.sum() == pg.num_edges
    assert np.array_equal(np.asarray(jg.pt_idx)[mask], pg.pt_idx.numpy())
    assert np.array_equal(np.asarray(jg.cam_idx)[mask], pg.cam_idx.numpy())
    pdeg = (pg.pt_ptr[1:] - pg.pt_ptr[:-1]).numpy()
    cdeg = (pg.cam_ptr[1:] - pg.cam_ptr[:-1]).numpy()
    assert pdeg[HUB] == 40 and pdeg[EMPTY_POINT] == 0 and cdeg[EMPTY_CAMERA] == 0
    assert (cdeg > 32).sum() >= 35 and ((cdeg > 0) & (cdeg <= 32)).any()
    return jscene, pscene, mask


def draw_edges(rng, mask, E, d):
    real = rng.standard_normal((E, d)).astype(np.float32)
    padded = np.zeros((mask.shape[0], d), np.float32)
    padded[mask] = real
    return padded, torch.from_numpy(real)


def draw_table(rng, rows, rows_cap, d):
    real = rng.standard_normal((rows, d)).astype(np.float32)
    return np.pad(real, ((0, rows_cap - rows), (0, 0))), torch.from_numpy(real)


def assert_close(got, want, name):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5 * scale, err_msg=name)


def side_split(graph, side, rows, long_above=None):
    chunks = graph.pt_chunks if side == "point" else graph.cam_chunks
    return chunks(rows, long_above)


def side_rows(graph, side):
    """(CSR offsets, the edge of each CSR row) of ``side``."""
    if side == "point":
        return graph.pt_ptr.long(), torch.arange(graph.num_edges)
    return graph.cam_ptr.long(), graph.cam_perm.long()


def row_chunks(graph, side, rows, long_above=None):
    """For each CSR row of ``side``: (its segment, its chunk's index within
    the segment) under the split at ``rows`` (a short segment is one chunk),
    and the most chunks of any segment."""
    ptr, _ = side_rows(graph, side)
    S = ptr.shape[0] - 1
    seg = torch.repeat_interleave(torch.arange(S), ptr[1:] - ptr[:-1])
    within = torch.arange(seg.shape[0]) - ptr[seg]
    long_ = torch.zeros(S, dtype=torch.bool)
    long_[torch.from_numpy(side_split(graph, side, rows, long_above).long_seg).long()] = True
    k = torch.where(long_[seg], within // rows, torch.zeros_like(within))
    return seg, k, int(k.max()) + 1 if k.numel() else 1


# ---- the dual forward's schedule --------------------------------------------------


def online_merge(m, den, num, om, oden, onum):
    """csrc/common.cuh ``Online::merge`` on tensors: (m, den) per head, num
    per feature (head-major)."""
    m_new = torch.maximum(m, om)
    live = m_new > float("-inf")
    safe = torch.where(live, m_new, torch.zeros_like(m_new))
    a = torch.where(live, torch.exp(m - safe), torch.zeros_like(m))
    b = torch.where(live, torch.exp(om - safe), torch.zeros_like(om))
    C = num.shape[1] // m.shape[1]
    return (torch.where(live, m_new, m), den * a + oden * b,
            num * a.repeat_interleave(C, 1) + onum * b.repeat_interleave(C, 1))


def split_attend_model(xl, xr, att, graph, side, heads, rows=SPLIT_ROWS,
                       slope=NEGATIVE_SLOPE):
    """One direction of the dual forward as the kernels schedule it: each
    chunk's max, shifted denominator and numerator per head, merged in
    chunk order. Returns (out (S, D), m (S, H), den (S, H)); an empty
    segment gives out 0, m -inf, den 0."""
    ptr, edge = side_rows(graph, side)
    seg, k, K = row_chunks(graph, side, rows)
    S, D = ptr.shape[0] - 1, xl.shape[1]
    C = D // heads
    x = xl[edge]
    logits = (leaky_relu(x + xr[seg], slope) * att).reshape(-1, heads, C).sum(-1)
    unit = seg * K + k  # (segment, chunk) of each row
    cm = segment_max(logits, unit, S * K)
    p = torch.exp(logits - cm[unit])
    cden = torch.zeros(S * K, heads, dtype=F32).index_add_(0, unit, p)
    cnum = torch.zeros(S * K, D, dtype=F32).index_add_(0, unit, p.repeat_interleave(C, 1) * x)
    cm, cden, cnum = cm.view(S, K, heads), cden.view(S, K, heads), cnum.view(S, K, D)
    m = torch.full((S, heads), float("-inf"), dtype=F32)
    den, num = torch.zeros(S, heads, dtype=F32), torch.zeros(S, D, dtype=F32)
    for j in range(K):
        m, den, num = online_merge(m, den, num, cm[:, j], cden[:, j], cnum[:, j])
    out = torch.where(den.repeat_interleave(C, 1) > 0, num / den.repeat_interleave(C, 1),
                      torch.zeros_like(num))
    return out, m, den, logits, seg


def dual_inputs(scenes, D, seed):
    jscene, pscene, mask = scenes
    jg, pg = jscene.graph, pscene.graph
    rng = np.random.default_rng(seed)
    C = D // HEADS
    xl_p, xl_p_t = draw_edges(rng, mask, pg.num_edges, D)
    xl_c, xl_c_t = draw_edges(rng, mask, pg.num_edges, D)
    xr_p, xr_p_t = draw_table(rng, pg.num_pts, jg.num_pts, D)
    xr_c, xr_c_t = draw_table(rng, pg.num_cams, jg.num_cams, D)
    att_p, att_c = (rng.standard_normal((HEADS, C)).astype(np.float32) for _ in range(2))
    jax_in = (xl_p, xl_c, xr_p, xr_c, att_p, att_c)
    port_in = (xl_p_t, xl_c_t, xr_p_t, xr_c_t, torch.from_numpy(att_p).reshape(-1),
               torch.from_numpy(att_c).reshape(-1))
    return jax_in, port_in


@pytest.mark.parametrize("D", [32, 4])
def test_split_dual_forward_model_matches_jax_kernel(scenes, monkeypatch, D):
    calls = []

    def spy(*a, _fn=jax_fda._dual_fwd_raw, **k):
        calls.append(1)
        return _fn(*a, **k)

    monkeypatch.setattr(jax_fda, "_dual_fwd_raw", spy)
    jscene, pscene, _ = scenes
    jg, pg = jscene.graph, pscene.graph
    (xl_p, xl_c, xr_p, xr_c, att_p, att_c), port = dual_inputs(scenes, D, seed=D)
    C = D // HEADS
    want_p, want_c = jax_attend_dual(
        jnp.asarray(xl_p).reshape(-1, HEADS, C), jnp.asarray(xr_p).reshape(-1, HEADS, C),
        jnp.asarray(att_p), jg.pt_idx, jg.num_pts, jg.pt_segment_windows(),
        jnp.asarray(xl_c).reshape(-1, HEADS, C), jnp.asarray(xr_c).reshape(-1, HEADS, C),
        jnp.asarray(att_c), jg.cam_idx, jg.num_cams, edge_mask=jg.edge_mask)
    assert calls  # the JAX dual kernel was reached
    xl_p_t, xl_c_t, xr_p_t, xr_c_t, att_p_t, att_c_t = port
    got_p = split_attend_model(xl_p_t, xr_p_t, att_p_t, pg, "point", HEADS)[0]
    got_c = split_attend_model(xl_c_t, xr_c_t, att_c_t, pg, "camera", HEADS)[0]
    assert_close(got_p.numpy(), np.asarray(want_p).reshape(-1, D)[:pg.num_pts], "out_pt")
    assert_close(got_c.numpy(), np.asarray(want_c).reshape(-1, D)[:pg.num_cams], "out_cam")
    assert (got_p[EMPTY_POINT] == 0).all() and (got_c[EMPTY_CAMERA] == 0).all()
    # the long segments really were cut: the hub point and every camera
    assert HUB in pg.pt_chunks(SPLIT_ROWS).long_seg
    assert pg.cam_chunks(SPLIT_ROWS).n_long >= 35


@pytest.mark.parametrize("side", ["point", "camera"])
def test_split_dual_forward_max_is_the_plain_segment_max(scenes, side):
    """The residual m the merged chunks give is bitwise the plain path's
    segment max of the same logits (the backward's exp(min(logit - m, 0))
    needs the exact max), its den and output agree with the plain path's."""
    _, pscene, _ = scenes
    pg = pscene.graph
    _, (xl_p, xl_c, xr_p, xr_c, att_p, att_c) = dual_inputs(scenes, 32, seed=5)
    xl, xr, att = (xl_p, xr_p, att_p) if side == "point" else (xl_c, xr_c, att_c)
    out, m, den, logits, seg = split_attend_model(xl, xr, att, pg, side, HEADS)
    S = m.shape[0]
    plain_m = segment_max(logits, seg, S)
    assert torch.equal(m, plain_m)
    assert torch.isinf(m[EMPTY_POINT if side == "point" else EMPTY_CAMERA]).all()
    plain_den = torch.zeros(S, HEADS, dtype=F32).index_add_(0, seg,
                                                            torch.exp(logits - plain_m[seg]))
    assert_close(den.numpy(), plain_den.numpy(), "den")
    want = fused_dual_attend_plain(xl_p, xl_c, xr_p, xr_c, att_p, att_c, pg, HEADS)
    assert_close(out.numpy(), want[0 if side == "point" else 1].numpy(), "out")


# ---- the segment sum's schedule ---------------------------------------------------


def split_sum_model(data, graph, side, rows=SUM_PART_ROWS, long_above=SUM_ROWS,
                    runs=SUM_MERGE_WARPS, reduction="sum", neutral=0.0):
    """The segment sum as the kernels schedule it: a segment of at most
    ``long_above`` rows summed alone; a longer one cut into parts of
    ``rows``, each part's sum a block's; a hub of several parts merged as
    its second launch does: the parts in ``runs`` contiguous runs of
    ceil(n / runs), each summed in part order, then the runs in order.
    With ``reduction="max"`` the same walk takes maxima from -inf (the
    segment max, #17/#19): an empty segment gives ``neutral``."""
    ptr, edge = side_rows(graph, side)
    seg, k, K = row_chunks(graph, side, rows, long_above)
    S, D = ptr.shape[0] - 1, data.shape[1]
    unit = seg * K + k
    if reduction == "sum":
        ident, op = 0.0, torch.add
        part = torch.zeros(S * K, D, dtype=F32).index_add_(0, unit, data[edge])
    else:
        ident, op = float("-inf"), torch.maximum
        part = torch.full((S * K, D), ident, dtype=F32).scatter_reduce_(
            0, unit[:, None].expand(-1, D), data[edge], reduce="amax")
    part = part.view(S, K, D)
    deg = (ptr[1:] - ptr[:-1]).tolist()
    out = torch.full((S, D), ident, dtype=F32)
    for s in range(S):
        n = -(-deg[s] // rows) if deg[s] > long_above else 1
        if n == 1:
            out[s] = part[s, 0] if deg[s] or reduction == "sum" else neutral
            continue
        per = -(-n // runs)
        total = torch.full((D,), ident, dtype=F32)
        for r0 in range(0, n, per):
            run = torch.full((D,), ident, dtype=F32)
            for j in range(r0, min(r0 + per, n)):
                run = op(run, part[s, j])
            total = op(total, run)
        out[s] = total
    return out


@pytest.mark.parametrize("side", ["point", "camera"])
@pytest.mark.parametrize("D", [2, 4, 32, 256])
def test_split_segment_sum_model_matches_jax_kernels(scenes, monkeypatch, side, D):
    """The production split (on this scene every long segment is one part)
    and, at D = 32, one that cuts the long segments into parts of 16 rows,
    several per segment, so the hubs' merge order is held too."""
    calls = {}
    name = JAX_SUM[side]

    def spy(*a, _fn=getattr(jax_segment_kernels, name), **k):
        calls[name] = calls.get(name, 0) + 1
        return _fn(*a, **k)

    monkeypatch.setattr(jax_segment_kernels, name, spy)
    jscene, pscene, mask = scenes
    jg, pg = jscene.graph, pscene.graph
    rng = np.random.default_rng(100 + D)
    jdata, data = draw_edges(rng, mask, pg.num_edges, D)
    ids, S, window = ((jg.pt_idx, jg.num_pts, jg.pt_segment_windows()) if side == "point"
                      else (jg.cam_idx, jg.num_cams, None))
    want = jseg.segment_sum(jnp.asarray(jdata), ids, S, edge_mask=jg.edge_mask,
                            indices_are_sorted=side == "point", window=window)
    assert calls.get(name, 0) >= 1
    got = split_sum_model(data, pg, side)
    S_real = side_ids(pg, side)[1]
    assert_close(got.numpy(), np.asarray(want)[:S_real], "sum")
    if D == 32:
        assert side_split(pg, side, 16, 32).n_chunks > 2 * side_split(pg, side, 16, 32).n_long
        fine = split_sum_model(data, pg, side, rows=16, long_above=32)
        assert_close(fine.numpy(), np.asarray(want)[:S_real], "sum, parts of 16 rows")
    assert_close(got.numpy(), segment_sum_plain(data, pg, side).numpy(), "plain sum")
    assert (got[EMPTY_POINT if side == "point" else EMPTY_CAMERA] == 0).all()


# ---- the split itself ---------------------------------------------------------------


@pytest.mark.parametrize("rows,long_above", [(SUM_PART_ROWS, SUM_ROWS), (SPLIT_ROWS, SPLIT_ROWS),
                                             (7, 7), (16, 32)])
@pytest.mark.parametrize("side", ["point", "camera"])
def test_split_covers_every_edge_of_every_segment_once(scenes, side, rows, long_above):
    """Short segments whole and the long ones' chunks together list every
    CSR row exactly once, each under its own segment: every edge of the
    side is summed, and attended, exactly once (the sum's split: segments
    of more than SUM_ROWS rows cut into parts of SUM_PART_ROWS; the dual
    core's: chunks of SPLIT_ROWS)."""
    _, pscene, _ = scenes
    pg = pscene.graph
    ptr, edge = side_rows(pg, side)
    ptr = ptr.numpy()
    sp = side_split(pg, side, rows, long_above)
    long_ = set(sp.long_seg.tolist())
    covered, owner = [], []
    for s in range(ptr.shape[0] - 1):
        if s not in long_:
            assert ptr[s + 1] - ptr[s] <= long_above
            covered += range(ptr[s], ptr[s + 1])
            owner += [s] * int(ptr[s + 1] - ptr[s])
    for k in range(sp.n_chunks):
        s, b = int(sp.chunk_seg[k]), int(sp.chunk_begin[k])
        e = min(b + rows, int(ptr[s + 1]))
        covered += range(b, e)
        owner += [s] * (e - b)
    order = np.argsort(covered)
    np.testing.assert_array_equal(np.asarray(covered)[order], np.arange(pg.num_edges))
    seg_of_edge = (pg.pt_idx if side == "point" else pg.cam_idx).numpy()
    np.testing.assert_array_equal(seg_of_edge[edge.numpy()[np.asarray(covered)]], owner)
    assert sp.n_long == sum(1 for s in range(ptr.shape[0] - 1) if ptr[s + 1] - ptr[s] > long_above)


@pytest.mark.parametrize("D", [4, 256])
def test_hub_parts_graph_sums_a_point_of_three_parts(D):
    """On ``check_graphs.hub_parts_graph`` (4,500 cameras, point 0 on all of
    them) the sum's point split cuts point 0, and only it, into parts at
    rows 0, 2048 and 4096, and the sum in that schedule (the parts' merge
    included) agrees with the plain version."""
    graph = hub_parts_graph("cpu")
    sp = side_split(graph, "point", SUM_PART_ROWS, SUM_ROWS)
    assert graph.num_cams == 4500 and int(graph.pt_ptr[1]) == 4500
    assert sp.long_seg.tolist() == [0] and sp.chunk_begin.tolist() == [0, 2048, 4096]
    data = torch.from_numpy(
        np.random.default_rng(300 + D).standard_normal((graph.num_edges, D)).astype(np.float32))
    got = split_sum_model(data, graph, "point")
    assert_close(got.numpy(), segment_sum_plain(data, graph, "point").numpy(), "hub-parts sum")


# ---- the segment max (#17/#19): the sum's walk with fmaxf ---------------------------


@pytest.mark.parametrize("neutral", [float("-inf"), -7.5])
@pytest.mark.parametrize("side", ["point", "camera"])
@pytest.mark.parametrize("D", [1, 4, 8])
def test_split_segment_max_model_matches_jax_kernels(scenes, monkeypatch, D, side, neutral):
    """The max on the sum's split (and at D = 4 on a split into parts of 16
    rows, several per long segment, so the hubs' merge by max is held too)
    bitwise against the JAX max kernel of the side (its raw Pallas call
    reached, interpret mode) and the plain version; the empty segments,
    real and padded, give ``neutral``."""
    calls = {}
    name = JAX_MAX_RAW[side]

    def spy(*a, _fn=getattr(jax_segment_kernels, name), **k):
        calls[name] = calls.get(name, 0) + 1
        return _fn(*a, **k)

    monkeypatch.setattr(jax_segment_kernels, name, spy)
    jscene, pscene, mask = scenes
    jg, pg = jscene.graph, pscene.graph
    rng = np.random.default_rng(700 + 10 * D + (side == "camera"))
    jdata, data = draw_edges(rng, mask, pg.num_edges, D)
    ids, S, window = ((jg.pt_idx, jg.num_pts, jg.pt_segment_windows()) if side == "point"
                      else (jg.cam_idx, jg.num_cams, None))
    want = np.asarray(jseg.segment_max(jnp.asarray(jdata), ids, S, edge_mask=jg.edge_mask,
                                       indices_are_sorted=side == "point", neutral=neutral,
                                       window=window))
    assert calls.get(name, 0) >= 1
    S_real = side_ids(pg, side)[1]
    assert (want[S_real:] == neutral).all()  # the padded segments are empty
    got = split_sum_model(data, pg, side, reduction="max", neutral=neutral)
    np.testing.assert_array_equal(got.numpy(), want[:S_real])
    np.testing.assert_array_equal(got.numpy(),
                                  segment_max_plain(data, pg, side, neutral).numpy())
    assert (got[EMPTY_POINT if side == "point" else EMPTY_CAMERA] == neutral).all()
    if D == 4:
        assert side_split(pg, side, 16, 32).n_chunks > 2 * side_split(pg, side, 16, 32).n_long
        fine = split_sum_model(data, pg, side, rows=16, long_above=32, reduction="max",
                               neutral=neutral)
        np.testing.assert_array_equal(fine.numpy(), want[:S_real])


@pytest.mark.parametrize("D", [1, 8])
def test_hub_parts_graph_maxes_a_point_of_three_parts(D):
    """On ``hub_parts_graph`` the max's split is the sum's: point 0 in three
    parts of 2,048 rows, their maxima merged by max; the model agrees with
    the plain version bitwise on both sides."""
    graph = hub_parts_graph("cpu")
    assert side_split(graph, "point", SUM_PART_ROWS, SUM_ROWS).chunk_begin.tolist() == [
        0, 2048, 4096]
    data = torch.from_numpy(
        np.random.default_rng(800 + D).standard_normal((graph.num_edges, D)).astype(np.float32))
    for side in ("point", "camera"):
        got = split_sum_model(data, graph, side, reduction="max", neutral=-7.5)
        np.testing.assert_array_equal(got.numpy(),
                                      segment_max_plain(data, graph, side, -7.5).numpy())


# ---- the edge combine's backward (#12): the point pass on the sum's walk -------------


def sum_layout(D):
    """(W, P) of csrc/segment.cuh's SumLayout for D-wide rows: lanes per
    row, and short segments (lane groups) per warp."""
    vec = 4 if D % 4 == 0 else 2 if D % 2 == 0 else 1
    W = 1
    while W < D // vec and W < 32:
        W *= 2
    G = 32 if W >= 8 else max(4 * W, 8)
    return W, 32 // G


def combine_blocks(graph, D):
    """#12's point pass as the card launches it: its blocks in launch order,
    each a list of (segment, first row, end row) units. First a block per
    part of a long point (more than SUM_ROWS rows; parts of SUM_PART_ROWS),
    then the short points, SUM_BLOCK_WARPS x P x SUM_RUN consecutive ones
    per block (a warp's P lane groups take SUM_RUN each in turn; at W = 32,
    P = 1: a warp streams SUM_RUN points); a long point is no unit there."""
    ptr = graph.pt_ptr.long().tolist()
    n = len(ptr) - 1
    sp = side_split(graph, "point", SUM_PART_ROWS, SUM_ROWS)
    blocks = []
    for k in range(sp.n_chunks):
        s, b = int(sp.chunk_seg[k]), int(sp.chunk_begin[k])
        blocks.append([(s, b, min(b + SUM_PART_ROWS, ptr[s + 1]))])
    per_block = SUM_BLOCK_WARPS * sum_layout(D)[1] * SUM_RUN
    if n > sp.n_long:
        for b0 in range(0, n, per_block):
            blocks.append([(s, ptr[s], ptr[s + 1]) for s in range(b0, min(b0 + per_block, n))
                           if ptr[s + 1] - ptr[s] <= SUM_ROWS])
    return blocks


def column_sum_model(rows):
    """csrc/common.cuh's column_sum_kernel order: the rows r = q mod 8
    summed in order for each group q, then the eight groups in order."""
    total = torch.zeros(rows.shape[1], dtype=F32)
    for q in range(COLUMN_SUM_GROUPS):
        group = torch.zeros(rows.shape[1], dtype=F32)
        for r in range(q, rows.shape[0], COLUMN_SUM_GROUPS):
            group = group + rows[r]
        total = total + group
    return total


def edge_combine_bwd_model(g, graph):
    """(d pe, d ps, d pv, d pg) of the edge combine as the card computes
    them from the cotangent g (E, D)."""
    D = g.shape[1]
    blocks = combine_blocks(graph, D)
    rows = torch.zeros(len(blocks), D, dtype=F32)
    for i, block in enumerate(blocks):
        for _, b, e in block:
            rows[i] += g[b:e].sum(0)
    return (g * 0.25, split_sum_model(g, graph, "point") * 0.25,
            split_sum_model(g, graph, "camera") * 0.25, column_sum_model(rows * 0.25))


def blocked_ids(graph, chunk=512):
    """The JAX kernels' blocked edge layout of a port graph: each window of
    WINDOW points' edges, padded to a multiple of ``chunk`` with the ids n
    and m (zero rows). Returns (point ids (E_pad / chunk, chunk), camera ids
    likewise, each chunk's window, the real edges' rows)."""
    pt, cam = graph.pt_idx.numpy(), graph.cam_idx.numpy()
    n, m = graph.num_pts, graph.num_cams
    win = pt // WINDOW
    pids, cids, wb, rows = [], [], [], []
    at = 0
    for w in np.unique(win):
        idx = np.flatnonzero(win == w)  # contiguous: the edges are by point
        L = -(-idx.shape[0] // chunk) * chunk
        p, c = np.full(L, n, np.int32), np.full(L, m, np.int32)
        p[:idx.shape[0]], c[:idx.shape[0]] = pt[idx], cam[idx]
        pids.append(p)
        cids.append(c)
        wb.append(np.full(L // chunk, w, np.int32))
        rows.append(at + np.arange(idx.shape[0]))
        at += L
    return (np.concatenate(pids).reshape(-1, chunk), np.concatenate(cids).reshape(-1, chunk),
            np.concatenate(wb), np.concatenate(rows))


@pytest.mark.parametrize("graph_name", ["scene", "hub_parts"])
@pytest.mark.parametrize("D", [2, 4, 32, 256])
def test_edge_combine_bwd_model_matches_jax_kernel(scenes, monkeypatch, graph_name, D):
    """d pe bitwise, d ps, d pv and d pg within tolerance, against the VJP of
    the JAX package's fused_edge_combine (its _bwd_raw reached, interpret
    mode), and against autograd of the plain version."""
    calls = []

    def spy(*a, _fn=jax_fused_update._bwd_raw, **k):
        calls.append(1)
        return _fn(*a, **k)

    monkeypatch.setattr(jax_fused_update, "_bwd_raw", spy)
    if graph_name == "scene":
        jscene, pscene, mask = scenes
        jg, graph = jscene.graph, pscene.graph
        chunk = jg.chunk
        pids, cids = jg.pt_idx.astype(jnp.int32), jg.cam_idx.astype(jnp.int32)
        wb, n_pad, m_pad = jg.pt_segment_windows().block, jg.num_pts, jg.num_cams
        rows = np.flatnonzero(mask)
    else:
        graph = hub_parts_graph("cpu")
        assert side_split(graph, "point", SUM_PART_ROWS, SUM_ROWS).n_chunks == 3
        pids, cids, wb, rows = blocked_ids(graph)
        chunk, n_pad, m_pad = pids.shape[1], graph.num_pts, graph.num_cams
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    g = np.random.default_rng(400 + D).standard_normal((E, D)).astype(np.float32)
    g_pad = np.zeros((np.asarray(pids).size, D), np.float32)
    g_pad[rows] = g
    zeros = [jnp.zeros(shape, jnp.float32) for shape in ((g_pad.shape[0], D), (n_pad, D),
                                                         (m_pad, D), (1, D))]
    _, vjp = jax.vjp(
        lambda pe, ps, pv, pg: jax_fused_update.fused_edge_combine(
            pe, ps, pv, pg, jnp.asarray(pids).reshape(-1, chunk),
            jnp.asarray(cids).reshape(-1, chunk), jnp.asarray(wb), n_pad, m_pad, WINDOW, True),
        *zeros)
    want = [np.asarray(x) for x in vjp(jnp.asarray(g_pad))]
    assert calls  # the JAX backward kernel was reached
    got = edge_combine_bwd_model(torch.from_numpy(g), graph)
    np.testing.assert_array_equal(got[0].numpy(), want[0][rows])  # d pe = g / 4
    assert_close(got[1].numpy(), want[1][:n], "d ps")
    assert_close(got[2].numpy(), want[2][:m], "d pv")
    assert_close(got[3].numpy(), want[3].reshape(-1), "d pg")
    leaves = [torch.zeros(shape, dtype=F32, requires_grad=True)
              for shape in ((E, D), (n, D), (m, D), (1, D))]
    plain = torch.autograd.grad(fused_edge_combine_plain(*leaves, graph), leaves,
                                torch.from_numpy(g))
    for name, a, b in zip(("d pe", "d ps", "d pv", "d pg"), got, plain):
        assert_close(a.numpy(), b.reshape(a.shape).numpy(), f"{name} against the plain version")


def uneven_graph(seed=23):
    """4,500 cameras; points of 0, 1, 2, 3, 63, 64, 65, 100, 2,047, 2,048,
    2,049, 4,097 and 4,500 edges, then 997 of 1-7, then one whose degree
    makes the edge count a prime (19,001)."""
    rng = np.random.default_rng(seed)
    m = 4500
    degrees = [0, 1, 2, 3, 63, 64, 65, 100, 2047, 2048, 2049, 4097, 4500]
    degrees += rng.integers(1, 8, 997).tolist()
    total = sum(degrees)
    last = next(d for d in range(1, 64)
                if all((total + d) % q for q in range(2, int((total + d) ** 0.5) + 1)))
    degrees.append(last)
    pts = np.concatenate([np.full(d, p) for p, d in enumerate(degrees)])
    cams = np.concatenate([np.sort(rng.choice(m, d, replace=False)) for d in degrees])
    return graph_of_edges(pts, cams, len(degrees), m, "cpu", rng)


@pytest.mark.parametrize("D", [2, 4, 32, 256])
def test_edge_combine_walk_covers_every_edge_once(D):
    """The point pass's units (the long points' parts, the short points in
    their blocks) cover every edge exactly once, each unit inside its point,
    a short unit of at most SUM_ROWS rows, a part of at most SUM_PART_ROWS;
    the blocks are as many as the card launches and fit the wrapper's
    partial rows; and the model's d ps and d pg agree with the plain
    version."""
    graph = uneven_graph()
    E, n = graph.num_edges, graph.num_pts
    assert E == 19001 and all(E % q for q in range(2, 138))  # a prime
    ptr = graph.pt_ptr.long().tolist()
    sp = side_split(graph, "point", SUM_PART_ROWS, SUM_ROWS)
    blocks = combine_blocks(graph, D)
    covered = np.zeros(E, np.int64)
    for block in blocks:
        for s, b, e in block:
            assert ptr[s] <= b <= e <= ptr[s + 1]
            long_ = ptr[s + 1] - ptr[s] > SUM_ROWS
            assert e - b <= (SUM_PART_ROWS if long_ else SUM_ROWS)
            assert len(block) == 1 or not long_  # a part is its block's only unit
            covered[b:e] += 1
    assert (covered == 1).all()
    W, P = sum_layout(D)
    runs = -(-n // SUM_RUN)  # the host's grid: parts, then ceil(ceil(runs / P) / 32) blocks
    assert len(blocks) == sp.n_chunks + -(-(-(-runs // P)) // SUM_BLOCK_WARPS)
    assert len(blocks) <= sp.n_chunks + -(-n // 32)  # fused_edge_combine_bwd's partial rows
    assert sp.n_long == 7 and sp.n_chunks == 1 + 1 + 1 + 1 + 2 + 3 + 3  # 65 .. 4,500 rows
    g = torch.from_numpy(np.random.default_rng(500 + D).standard_normal((E, D)).astype(
        np.float32))
    got = edge_combine_bwd_model(g, graph)
    leaves = [torch.zeros(shape, dtype=F32, requires_grad=True)
              for shape in ((E, D), (n, D), (graph.num_cams, D), (1, D))]
    plain = torch.autograd.grad(fused_edge_combine_plain(*leaves, graph), leaves, g)
    for name, a, b in zip(("d pe", "d ps", "d pv", "d pg"), got, plain):
        assert_close(a.numpy(), b.reshape(a.shape).numpy(), name)
