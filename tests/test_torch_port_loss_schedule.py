"""The schedules of the ESFM loss terms' kernels (csrc/fused_loss.cu) as
plain PyTorch models, against the JAX package's Pallas kernels in interpret
mode (``gasfm_tpu/ops/pallas/fused_loss.py``: ``_fwd_raw``, ``_bwd_raw``).

- The forward (#7): one launch. Thread t of block b takes the edges b x
  512 + t + 256 j (j = 0, 1), sums its terms in j order; a warp sums by
  ``group_sum`` (csrc/common.cuh: lanes i and i + 16, then i + 8, ...), the
  block's eight warps in warp order, one partial triple per block; the last
  block sums the partials (thread t those of blocks t, t + 256, ... in
  order, then the same block sum). The model's sum of terms against the
  JAX forward within tolerance, its counts exact.
- The backward (#8): both table gradients on the segment sum's walk and
  split (csrc/segment.cuh ``segment_sum_block`` with the loss's row
  sources), each edge's row by ``esfm_edge_grad``'s formula: the point side
  P^T g (4 wide) over the point CSR, the camera side g x X (12 wide) over
  the camera CSR through ``cam_perm``. A short segment (at most LONG_POINT
  rows on the point side, SUM_ROWS on the camera side) takes a lane group
  of 8 lanes: lane i % 8 sums rows i // 8 in
  order, the lanes by a butterfly (1, 2, 4 apart). A long one's part (at
  most SUM_PART_ROWS rows) takes a block of LOSS_BWD_WARPS warps: lane i %
  256 sums rows i // 256 in order, each warp's 32 lanes by a butterfly,
  the warps in warp order. A hub's parts are merged as the merge launch
  does (eight contiguous runs, each in part order, then the runs in order).
  Against the VJP of the JAX ``fused_esfm_terms`` in the three equalization
  modes, hinge on and off, on the scene and on it cut as
  ``graph_with_empty_segments`` cuts a graph, at the production split and
  at parts of 16 rows (segments over 32 long), where the hub point and
  every camera come in several parts (at the production split the hub
  point, 40 edges, is one long part, and 30 cameras are).
- The walk covers every edge exactly once on both sides, each in a unit of
  its own segment, on the scene and on ``check_graphs.hub_parts_graph``.

The scene: 45 views and 300 points (visibility 0.4: 30 cameras of more
than 64 edges, long on the production split, the others short), point HUB
seen by 40 views, point EMPTY_POINT and camera EMPTY_CAMERA without edges.
Inputs are drawn with numpy per real camera and point (padded to the JAX
capacities). Tolerances as in tests/test_torch_port_kernels.py: |err| <=
1e-5 x the reference's scale + 1e-4 x |ref| (float32 sums in another
order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.graph.view_graph import build_view_graph as jax_build_view_graph
from gasfm_tpu.ops import segment as jseg
from gasfm_tpu.ops.pallas import fused_loss as jax_fused_loss

from gasfm_tpu_torch.graph.check_graphs import graph_with_empty_segments, hub_parts_graph
from gasfm_tpu_torch.graph.view_graph import build_view_graph
from gasfm_tpu_torch.ops.kernels.fused_loss import (LONG_POINT, TERMS_EDGES,
                                                     fused_esfm_terms_plain)
from gasfm_tpu_torch.ops.kernels.segment_kernels import SUM_PART_ROWS, SUM_ROWS

HUB, EMPTY_POINT, EMPTY_CAMERA = 11, 20, 7
MARGIN = 1e-4
TERMS_THREADS = 256  # kTermsThreads of csrc/fused_loss.cu
LOSS_BWD_WARPS = 8  # kLossBwdWarps: warps per block of the backward's walk
GROUP_LANES = 8  # lanes of a short segment at one lane per row (segment.cuh SumLayout G)
MERGE_WARPS = 8  # kSumMergeWarps of csrc/segment.cuh: the runs of the hubs' merge
F32 = torch.float32


@pytest.fixture(autouse=True)
def _interpret_mode():
    jseg.set_kernel_mode("interpret")
    yield
    jseg.set_kernel_mode("auto")


def scene_matrix():
    """(M, Ns) of the scene described in the module docstring."""
    data = jax_synthetic_scene(n_views=45, n_points=300, visibility=0.4, seed=21)
    M = data.M.copy()
    rng = np.random.default_rng(22)
    views = rng.choice([v for v in range(45) if v != EMPTY_CAMERA], size=40, replace=False)
    M[:, HUB] = 0.0
    for v in views:
        M[2 * v:2 * v + 2, HUB] = rng.uniform(400.0, 600.0, 2)
    M[:, EMPTY_POINT] = 0.0
    M[2 * EMPTY_CAMERA:2 * EMPTY_CAMERA + 2] = 0.0
    return M, data.Ns


@pytest.fixture(scope="module")
def graphs():
    """{name: (JAX graph, port graph, JAX real-edge mask)}: the scene, and
    the scene without every 50th point's and camera 1's observations (the
    cut of ``graph_with_empty_segments``, made on the measurement matrix so
    that both packages build it: both then also drop the lone observation
    of a point left in one view, as a graph of real data would)."""
    M, Ns = scene_matrix()
    M_empty = M.copy()
    M_empty[:, ::50] = 0.0
    M_empty[2:4] = 0.0
    out = {}
    for name, mat in (("scene", M), ("empty_segments", M_empty)):
        jg = jax_build_view_graph(mat, Ns)
        pg = build_view_graph(mat, Ns, device="cpu")
        mask = np.asarray(jg.edge_mask)
        assert mask.sum() == pg.num_edges
        out[name] = (jg, pg, mask)
    pg, cut = out["scene"][1], graph_with_empty_segments(out["scene"][1])
    pe = out["empty_segments"][1]
    kept = set(zip(pe.pt_idx.tolist(), pe.cam_idx.tolist()))
    lone = np.bincount(cut.pt_idx.numpy(), minlength=cut.num_pts) == 1
    assert kept == {(p, c) for p, c in zip(cut.pt_idx.tolist(), cut.cam_idx.tolist())
                    if not lone[p]}
    pdeg, cdeg = (pg.pt_ptr[1:] - pg.pt_ptr[:-1]), (pg.cam_ptr[1:] - pg.cam_ptr[:-1])
    assert pdeg[HUB] == 40 and pdeg[EMPTY_POINT] == 0 and cdeg[EMPTY_CAMERA] == 0
    assert (cdeg > SUM_ROWS).sum() >= 25 and ((cdeg > 0) & (cdeg <= SUM_ROWS)).any()
    return out


def operands(jg, pg, seed):
    """Cameras near [I | (0, 0, 3)] (a fifth flipped) and points in a unit
    box, drawn per real camera and point and padded to the JAX capacities:
    depths of both signs, so both terms are taken."""
    rng = np.random.default_rng(seed)
    m, n = pg.num_cams, pg.num_pts
    P = np.concatenate([np.eye(3)[None] + 0.1 * rng.standard_normal((m, 3, 3)),
                        np.array([0.0, 0.0, 3.0])[None, :, None]
                        + 0.1 * rng.standard_normal((m, 3, 1))], axis=2)
    P = (P * np.where(np.arange(m) % 5 == 0, -1.0, 1.0)[:, None, None]).reshape(m, 12)
    X = np.concatenate([rng.uniform(-1.0, 1.0, (n, 3)), np.ones((n, 1))], axis=1)
    P, X = P.astype(np.float32), X.astype(np.float32)
    P_pad = np.pad(P, ((0, jg.num_cams - m), (0, 0)))
    X_pad = np.pad(X, ((0, jg.num_pts - n), (0, 0)))
    return P_pad, X_pad, torch.from_numpy(P), torch.from_numpy(X)


def assert_close(got, want, name):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5 * scale, err_msg=name)


def spy_on(monkeypatch, name):
    calls = []

    def spy(*a, _fn=getattr(jax_fused_loss, name), **k):
        calls.append(1)
        return _fn(*a, **k)

    monkeypatch.setattr(jax_fused_loss, name, spy)
    return calls


def projections(P, X, graph):
    """(E, 3) P[cam] . X[pt] per edge, each a left-to-right sum of four
    products, as the kernels write it; and the gathered rows."""
    Pe = P[graph.cam_idx.long()].reshape(-1, 3, 4)
    Xe = X[graph.pt_idx.long()]
    pr = Pe[:, :, 0] * Xe[:, None, 0]
    for j in range(1, 4):
        pr = pr + Pe[:, :, j] * Xe[:, None, j]
    return pr, Pe, Xe


# ---- the forward (#7) ----------------------------------------------------------------


def edge_terms(P, X, graph, hinge, hinge_w):
    """(E,) terms and (E,) positive-depth flags, esfm_term's formula."""
    pr, _, _ = projections(P, X, graph)
    depth = pr[:, 2]
    pos = depth >= MARGIN if hinge else depth.abs() >= MARGIN
    den = torch.where(pos, depth, torch.ones_like(depth))
    rx = pr[:, 0] / den - graph.uv[:, 0]
    ry = pr[:, 1] / den - graph.uv[:, 1]
    sq = rx * rx + ry * ry
    rn = torch.where(sq > 0, torch.sqrt(sq), torch.zeros_like(sq))
    term = torch.where(pos, rn, (MARGIN - depth) * hinge_w)
    return term, pos.to(F32)


def group_sum_tree(x):
    """csrc/common.cuh ``group_sum`` over the last-but-one axis (32 lanes):
    lane i adds lane i + 16, then i + 8, ..., the value lane 0 holds."""
    while x.shape[-2] > 1:
        h = x.shape[-2] // 2
        x = x[..., :h, :] + x[..., h:, :]
    return x[..., 0, :]


def block_sum3(v):
    """csrc/fused_loss.cu ``block_sum3`` of (..., 256, 3) thread values:
    each warp's group_sum, then the eight warps from 0 in warp order."""
    warps = group_sum_tree(v.reshape(*v.shape[:-2], TERMS_THREADS // 32, 32, 3))
    t = torch.zeros(*v.shape[:-2], 3, dtype=F32)
    for w in range(TERMS_THREADS // 32):
        t = t + warps[..., w, :]
    return t


def terms_model(P, X, graph, hinge, hinge_w):
    """(3,) as the forward kernel computes it: per-thread sums over its four
    edges, one partial per block, the partials summed by the last block."""
    term, pos = edge_terms(P, X, graph, hinge, hinge_w)
    E = term.shape[0]
    nb = max(1, -(-E // TERMS_EDGES))
    rows = torch.zeros(nb * TERMS_EDGES, 3, dtype=F32)  # nothing added for a missing edge
    rows[:E, 0], rows[:E, 1], rows[:E, 2] = term, 1.0, pos
    rows = rows.reshape(nb, TERMS_EDGES // TERMS_THREADS, TERMS_THREADS, 3)
    v = torch.zeros(nb, TERMS_THREADS, 3, dtype=F32)
    for j in range(rows.shape[1]):
        v = v + rows[:, j]
    partials = block_sum3(v)  # (nb, 3)
    t = torch.zeros(TERMS_THREADS, 3, dtype=F32)
    for b0 in range(0, nb, TERMS_THREADS):
        chunk = partials[b0:b0 + TERMS_THREADS]
        t[:chunk.shape[0]] = t[:chunk.shape[0]] + chunk
    return block_sum3(t)


@pytest.mark.parametrize("graph_name", ["scene", "empty_segments"])
@pytest.mark.parametrize("hinge", [True, False])
def test_terms_model_matches_jax_forward(graphs, monkeypatch, graph_name, hinge):
    """The forward's block partials and their block-order merge against the
    JAX forward (its _fwd_raw reached, interpret mode) and the plain
    version; the counts exact."""
    calls = spy_on(monkeypatch, "_fwd_raw")
    jg, pg, _ = graphs[graph_name]
    P_pad, X_pad, P, X = operands(jg, pg, seed=31)
    hinge_w = 1.0 if hinge else 0.0
    eq_mode = "valid_only" if hinge else "all"  # selects the count JAX hands back
    edge_sum, count = jax_fused_loss.fused_esfm_terms(
        jnp.asarray(P_pad), jnp.asarray(X_pad), jg.uv, jg, MARGIN, hinge, hinge_w, eq_mode,
        interpret=True)
    assert calls
    got = terms_model(P, X, pg, hinge, hinge_w)
    assert_close(got[0].numpy(), float(edge_sum), "sum of terms")
    assert float(got[2 if hinge else 1]) == float(count)
    assert float(got[1]) == pg.num_edges
    if hinge:
        assert 0 < float(got[2]) < pg.num_edges  # both branches taken
    plain = fused_esfm_terms_plain(P, X, pg, MARGIN, hinge, hinge_w)
    assert_close(got.numpy(), plain.numpy(), "against the plain version")
    assert torch.equal(got[1:], plain[1:])


# ---- the backward (#8) ---------------------------------------------------------------


def edge_grad_rows(P, X, graph, hinge, hinge_w, eq_mode, coef, count):
    """Each edge's rows as the backward's row sources make them with
    ``esfm_edge_grad``: (E, 4) P[cam]^T g, (E, 12) g x X[pt]."""
    pr, Pe, Xe = projections(P, X, graph)
    depth = pr[:, 2]
    pos = depth >= MARGIN if hinge else depth.abs() >= MARGIN
    denom = torch.where(pos, depth, torch.ones_like(depth))
    inv_d = 1.0 / denom
    px, py = pr[:, 0] / denom, pr[:, 1] / denom
    rx, ry = px - graph.uv[:, 0], py - graph.uv[:, 1]
    sq = rx * rx + ry * ry
    nz = sq > 0
    inv_rn = torch.where(nz, 1.0 / torch.sqrt(torch.where(nz, sq, torch.ones_like(sq))),
                         torch.zeros_like(sq))
    hx, hy = rx * inv_rn, ry * inv_rn
    zero = torch.zeros_like(hx)
    g0 = torch.where(pos, hx * inv_d * coef, zero)
    g1 = torch.where(pos, hy * inv_d * coef, zero)
    rdotp = hx * (pr[:, 0] * inv_d) + hy * (pr[:, 1] * inv_d)
    gd = torch.where(pos, -rdotp * inv_d, torch.full_like(hx, -hinge_w)) * coef
    if eq_mode != "none":
        icnt = 1.0 / max(float(count), 1.0)
        n3 = torch.sqrt(g0 * g0 + g1 * g1 + gd * gd)
        scale = icnt / torch.clamp_min(n3, 1e-12)
        take = pos if eq_mode == "valid_only" else torch.ones_like(pos)
        g0, g1, gd = (torch.where(take, c * scale, c) for c in (g0, g1, gd))
    g = torch.stack([g0, g1, gd], 1)  # (E, 3)
    pt_rows = Pe[:, 0] * g[:, 0:1] + Pe[:, 1] * g[:, 1:2] + Pe[:, 2] * g[:, 2:3]
    cam_rows = (g[:, :, None] * Xe[:, None, :]).reshape(-1, 12)
    return pt_rows, cam_rows


def walk_units(graph, side, rows=SUM_PART_ROWS, long_above=SUM_ROWS):
    """The walk's units of ``side``: [(segment, kind, part index within the
    segment, CSR rows [b, e))]; kind "short" (a lane group), "whole" (a long
    segment of one part) or "part" (a hub's part, merged later)."""
    ptr = (graph.pt_ptr if side == "point" else graph.cam_ptr).long().tolist()
    units = []
    for s in range(len(ptr) - 1):
        b, e = ptr[s], ptr[s + 1]
        if e - b <= long_above:
            units.append((s, "short", 0, b, e))
            continue
        n = -(-(e - b) // rows)
        for k in range(n):
            units.append((s, "whole" if n == 1 else "part", k, b + k * rows,
                          min(b + (k + 1) * rows, e)))
    return units


def butterfly(x):
    """The value lane 0 holds after a butterfly over the last-but-one axis
    (lanes 1, 2, 4, ... apart): adjacent pairs, then pairs of pairs."""
    while x.shape[-2] > 1:
        x = x[..., 0::2, :] + x[..., 1::2, :]
    return x[..., 0, :]


def lane_sums(data, lanes):
    """(lanes, D): lane i % lanes sums rows i // lanes of ``data`` (its
    unit's rows in CSR order) in order, from 0."""
    steps = -(-data.shape[0] // lanes)
    grid = torch.zeros(steps * lanes, data.shape[1], dtype=F32)
    grid[:data.shape[0]] = data
    grid = grid.reshape(steps, lanes, data.shape[1])
    acc = torch.zeros(lanes, data.shape[1], dtype=F32)
    for j in range(steps):
        acc = acc + grid[j]
    return acc


def walk_model(rows_of_edge, graph, side, rows=SUM_PART_ROWS, long_above=SUM_ROWS,
               warps=LOSS_BWD_WARPS):
    """(S, D) segment sums of the per-edge rows over ``side`` in the walk's
    order (module docstring); an empty segment gives 0."""
    edge = (torch.arange(graph.num_edges) if side == "point" else graph.cam_perm.long())
    S = graph.num_pts if side == "point" else graph.num_cams
    D = rows_of_edge.shape[1]
    out = torch.zeros(S, D, dtype=F32)
    parts = {}
    for s, kind, k, b, e in walk_units(graph, side, rows, long_above):
        data = rows_of_edge[edge[b:e]]
        if kind == "short":
            out[s] = butterfly(lane_sums(data, GROUP_LANES))
            continue
        per_warp = butterfly(lane_sums(data, warps * 32).reshape(warps, 32, D))
        t = torch.zeros(D, dtype=F32)
        for w in range(warps):
            t = t + per_warp[w]
        if kind == "whole":
            out[s] = t
        else:
            parts.setdefault(s, []).append(t)
    for s, ps in parts.items():  # the merge launch: MERGE_WARPS runs in part order
        per = -(-len(ps) // MERGE_WARPS)
        total = torch.zeros(D, dtype=F32)
        for r0 in range(0, len(ps), per):
            run = torch.zeros(D, dtype=F32)
            for p in ps[r0:r0 + per]:
                run = run + p
            total = total + run
        out[s] = total
    return out


def jax_grads(jg, P_pad, X_pad, hinge, hinge_w, eq_mode, coef):
    def f(P, X):
        return jax_fused_loss.fused_esfm_terms(P, X, jg.uv, jg, MARGIN, hinge, hinge_w, eq_mode,
                                               interpret=True)

    (edge_sum, count), vjp = jax.vjp(f, jnp.asarray(P_pad), jnp.asarray(X_pad))
    dP, dX = vjp((jnp.asarray(coef, jnp.float32), jnp.zeros_like(count)))
    return np.asarray(dP), np.asarray(dX), float(count)


@pytest.mark.parametrize("graph_name", ["scene", "empty_segments"])
@pytest.mark.parametrize("hinge", [True, False])
@pytest.mark.parametrize("eq_mode", ["none", "all", "valid_only"])
def test_walk_model_matches_jax_backward(graphs, monkeypatch, graph_name, hinge, eq_mode):
    """dP and dX of the walk model, at the production split and at parts of
    16 rows (segments over 32 long: the hub point in three parts, every
    camera in several, merged in part order), against the VJP of the JAX
    kernel (its _bwd_raw reached, interpret mode) and autograd of the plain
    version; the empty segments' rows 0."""
    calls = spy_on(monkeypatch, "_bwd_raw")
    jg, pg, _ = graphs[graph_name]
    P_pad, X_pad, P, X = operands(jg, pg, seed=41)
    hinge_w = 1.0 if hinge else 0.0
    coef = 1.0 / pg.num_edges
    want_P, want_X, count = jax_grads(jg, P_pad, X_pad, hinge, hinge_w, eq_mode, coef)
    assert calls
    pt_rows, cam_rows = edge_grad_rows(P, X, pg, hinge, hinge_w, eq_mode, coef, count)
    leaves = [P.clone().requires_grad_(), X.clone().requires_grad_()]
    terms = fused_esfm_terms_plain(*leaves, pg, MARGIN, hinge, hinge_w, eq_mode)
    plain = torch.autograd.grad(terms[0] * coef, leaves)
    ptr_p, ptr_c = pg.pt_ptr.long(), pg.cam_ptr.long()
    empty_p = torch.nonzero(ptr_p[1:] == ptr_p[:-1]).flatten()
    empty_c = torch.nonzero(ptr_c[1:] == ptr_c[:-1]).flatten()
    assert empty_p.numel() and empty_c.numel()
    for rows, pt_long, cam_long in ((SUM_PART_ROWS, LONG_POINT, SUM_ROWS), (16, 32, 32)):
        dX = walk_model(pt_rows, pg, "point", rows, pt_long)
        dP = walk_model(cam_rows, pg, "camera", rows, cam_long)
        tag = f" (parts of {rows})"
        assert_close(dP.numpy(), want_P[:pg.num_cams], "dP" + tag)
        assert_close(dX.numpy(), want_X[:pg.num_pts], "dX" + tag)
        assert_close(dP.numpy(), plain[0].numpy(), "dP against the plain version" + tag)
        assert_close(dX.numpy(), plain[1].numpy(), "dX against the plain version" + tag)
        assert (dX[empty_p] == 0).all() and (dP[empty_c] == 0).all()
    kinds = {side: {kind for _, kind, _, _, _ in walk_units(pg, side, 16, 32)}
             for side in ("point", "camera")}
    assert kinds["point"] == kinds["camera"] == {"short", "part"}
    assert HUB in {s for s, kind, _, _, _ in walk_units(pg, "point", SUM_PART_ROWS, LONG_POINT)
                   if kind == "whole"}


@pytest.mark.parametrize("rows,long_above", [(SUM_PART_ROWS, None), (16, 32)])
@pytest.mark.parametrize("side", ["point", "camera"])
def test_walk_covers_every_edge_once(graphs, side, rows, long_above):
    """The walk's units (short segments, long ones' parts) list every edge
    of ``side`` exactly once, each under its own segment, a short unit of
    at most ``long_above`` rows, a part of at most ``rows``; and the units
    are what the kernel's split hands it (ViewGraph.pt_chunks / cam_chunks:
    the long segments and their parts' first rows), on the scene and on
    hub_parts_graph (a point of 4,500 edges: three parts)."""
    if long_above is None:  # the production split of the side
        long_above = LONG_POINT if side == "point" else SUM_ROWS
    hub = hub_parts_graph("cpu")
    for graph in (graphs["scene"][1], hub):
        edge = (torch.arange(graph.num_edges) if side == "point"
                else graph.cam_perm.long()).numpy()
        seg_of_edge = (graph.pt_idx if side == "point" else graph.cam_idx).numpy()
        covered = np.zeros(graph.num_edges, np.int64)
        units = walk_units(graph, side, rows, long_above)
        for s, kind, _, b, e in units:
            assert e - b <= (long_above if kind == "short" else rows)
            assert (seg_of_edge[edge[b:e]] == s).all()
            covered[edge[b:e]] += 1
        assert (covered == 1).all()
        chunks = graph.pt_chunks if side == "point" else graph.cam_chunks
        sp = chunks(rows, long_above)
        longs = [(s, b) for s, kind, _, b, _ in units if kind != "short"]
        assert longs == list(zip(sp.chunk_seg.tolist(), sp.chunk_begin.tolist()))
        assert sorted({s for s, _ in longs}) == sp.long_seg.tolist()
    if side == "point" and rows == SUM_PART_ROWS:
        assert [u for u in walk_units(hub, "point", rows, long_above) if u[1] != "short"] == [
            (0, "part", 0, 0, 2048), (0, "part", 1, 2048, 4096), (0, "part", 2, 4096, 4500)]
