"""The graphs on which ``chip_smoke.py`` holds the attention, the dual
core, the segment sum and the layer step's edge tiles against their plain
versions, and on which ``tools/kernel_device_time.py`` times them: each is a
bench scene's graph with segments added or emptied at the lengths where the
kernels split their work, or a small graph of its own.

- :func:`graph_with_empty_segments`: every 50th point and camera 1 without
  edges;
- :func:`graph_with_edges`: a graph plus given edges, in the port's edge
  order (the base of the next two and of ``chip_smoke.py``'s hub graph);
- :func:`hub_camera_graph`: plus one camera that sees every point;
- :func:`degree_graph`: plus cameras of 31, 32, 33 and 64 edges and a
  point of 133;
- :func:`hub_point_graph`: plus a point seen by every camera and points of
  L - 1, L, L + 1 and 2L edges (L = 32, the split length);
- :func:`tile_boundary_graph`: a point over four 32-edge tiles, empty
  points and an empty camera, E not a multiple of 32;
- :func:`hub_parts_graph`: 4,500 cameras, each point on 1 to 5 of them,
  and one point on all: a point of more rows than the segment sum's part
  (2,048), cut into three parts.

They keep ``ViewGraph``'s layout (edges by point, then camera; both CSRs
and ``cam_perm`` consistent): ``tests/test_torch_port_attn.py`` checks it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gasfm_tpu_torch.graph.view_graph import ViewGraph


def csr_offsets(ids, S):
    """(S + 1,) int32 CSR offsets of the sorted (or counted) segment ids."""
    ptr = torch.zeros(S + 1, dtype=torch.int32, device=ids.device)
    ptr[1:] = torch.cumsum(torch.bincount(ids.long(), minlength=S), 0)
    return ptr


def graph_with_empty_segments(graph):
    """``graph`` without the edges of every 50th point and of camera 1,
    whose segments are then empty (as a point column with no valid entry
    is)."""
    keep = (graph.pt_idx % 50 != 0) & (graph.cam_idx != 1)
    pt_idx, cam_idx = graph.pt_idx[keep], graph.cam_idx[keep]
    return dataclasses.replace(
        graph, uv=graph.uv[keep], cam_idx=cam_idx, pt_idx=pt_idx,
        pt_ptr=csr_offsets(pt_idx, graph.num_pts), cam_ptr=csr_offsets(cam_idx, graph.num_cams),
        cam_perm=torch.argsort(cam_idx, stable=True).to(torch.int32))


def graph_with_edges(graph, pt_idx, cam_idx, n, m):
    """``graph`` plus the edges (pt_idx, cam_idx) over n points and m
    cameras (the new ones valid), in the port's edge order: by point, then
    camera."""
    dev = graph.device
    pt = torch.cat([graph.pt_idx, pt_idx.to(dev, torch.int32)])
    cam = torch.cat([graph.cam_idx, cam_idx.to(dev, torch.int32)])
    order = torch.argsort(pt.long() * m + cam.long(), stable=True)
    pt, cam = pt[order], cam[order]
    uv = torch.cat([graph.uv, torch.zeros((pt_idx.shape[0], 2), device=dev)])[order]

    def grown(valid, S):
        return torch.cat([valid, torch.ones(S - valid.shape[0], dtype=torch.bool, device=dev)])

    return dataclasses.replace(
        graph, uv=uv, cam_idx=cam, pt_idx=pt, pt_ptr=csr_offsets(pt, n),
        cam_ptr=csr_offsets(cam, m), cam_perm=torch.argsort(cam, stable=True).to(torch.int32),
        cam_valid=grown(graph.cam_valid, m), pt_valid=grown(graph.pt_valid, n))


def hub_camera_graph(graph):
    """``graph`` plus one camera that sees every point (on the dense scene:
    8,192 edges in one camera)."""
    n, m = graph.num_pts, graph.num_cams
    return graph_with_edges(graph, torch.arange(n), torch.full((n,), m), n, m + 1)


def degree_graph(graph, seed=17):
    """``graph`` plus four cameras of exactly L - 1, L, L + 1 and 2L edges
    (L = 32, the dual core backward's split length) on random points, and a
    point seen by 133 of the graph's own cameras (the power-law scene's
    longest track)."""
    gen = torch.Generator().manual_seed(seed)
    n, m = graph.num_pts, graph.num_cams
    assert m >= 133, "degree_graph needs at least 133 cameras"
    pts, cams = [], []
    for j, d in enumerate((31, 32, 33, 64)):
        pts.append(torch.randperm(n, generator=gen)[:d])
        cams.append(torch.full((d,), m + j))
    pts.append(torch.full((133,), n))
    cams.append(torch.sort(torch.randperm(m, generator=gen)[:133]).values)
    return graph_with_edges(graph, torch.cat(pts), torch.cat(cams), n + 1, m + 4)


def hub_point_graph(graph, L=32, seed=13):
    """``graph`` plus five points after its own: one seen by every camera
    (a hub; on the wide scene 1,280 edges), and four seen by exactly L - 1,
    L, L + 1 and 2L cameras, L the split length of the attention and the
    segment sum: a short point at and below it, a long one of a ragged and
    of two whole chunks."""
    gen = torch.Generator().manual_seed(seed)
    m, n = graph.num_cams, graph.num_pts
    degrees = (m, L - 1, L, L + 1, 2 * L)
    cams = [torch.sort(torch.randperm(m, generator=gen)[:d]).values for d in degrees]
    pts = [torch.full((d,), n + j) for j, d in enumerate(degrees)]
    return graph_with_edges(graph, torch.cat(pts), torch.cat(cams), n + len(degrees), m)


def tile_boundary_graph(dev, seed=11):
    """A graph for the layer step's tiles of 32 edges: point 0 seen by 99 of
    the 100 cameras (its edges span four tiles), every 7th point and camera
    5 without edges, the others on 1 to 5 cameras, and E not a multiple of
    32."""
    rng = np.random.default_rng(seed)
    m, n = 100, 400
    cams = np.array([c for c in range(m) if c != 5])
    pts, cids = [], []
    for p in range(n):
        if p % 7 == 0 and p > 0:
            continue
        seen = cams if p == 0 else np.sort(rng.choice(cams, rng.integers(1, 6), replace=False))
        pts += [p] * len(seen)
        cids += list(seen)
    if len(pts) % 32 == 0:
        pts, cids = pts[:-1], cids[:-1]
    return graph_of_edges(np.array(pts), np.array(cids), n, m, dev, rng)


def hub_parts_graph(dev, m=4500, n=8192, seed=19):
    """A graph of m cameras whose point 0 is seen by all of them and every
    other point by 1 to 5 random ones: with m = 4,500 the hub point's rows
    are three parts of the segment sum (2,048, 2,048 and 404 rows), merged
    by its second launch, as a camera's rows are on the hub-camera graph."""
    rng = np.random.default_rng(seed)
    pts, cids = [np.zeros(m, dtype=np.int64)], [np.arange(m)]
    for p in range(1, n):
        seen = np.sort(rng.choice(m, rng.integers(1, 6), replace=False))
        pts.append(np.full(seen.shape[0], p))
        cids.append(seen)
    return graph_of_edges(np.concatenate(pts), np.concatenate(cids), n, m, dev, rng)


def graph_of_edges(pt_idx, cam_idx, n, m, dev, rng):
    """The ViewGraph of the edges (pt_idx, cam_idx), numpy arrays already in
    the port's edge order (by point, then camera), every point and camera
    valid, uv drawn from ``rng``."""

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=dev)

    def offsets(ids, S):
        return t(np.concatenate([[0], np.cumsum(np.bincount(ids, minlength=S))]))

    E = pt_idx.shape[0]
    return ViewGraph(
        uv=torch.as_tensor(rng.standard_normal((E, 2)), dtype=torch.float32, device=dev),
        cam_idx=t(cam_idx), pt_idx=t(pt_idx), pt_ptr=offsets(pt_idx, n),
        cam_perm=t(np.argsort(cam_idx, kind="stable")), cam_ptr=offsets(cam_idx, m),
        cam_valid=torch.ones(m, dtype=torch.bool, device=dev),
        pt_valid=torch.ones(n, dtype=torch.bool, device=dev))
