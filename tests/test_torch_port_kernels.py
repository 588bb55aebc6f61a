"""The port's four kernels (their plain PyTorch versions, which is what a CPU
tensor runs) against the JAX package's Pallas kernels run in interpret mode.

The two packages lay edges out differently: the JAX graph pads every point
window's edge run to a chunk multiple and masks the padding; the port keeps
the valid edges only. Both sort the valid edges by (point, camera), so the
JAX arrays' masked-in rows, in order, ARE the port's rows: inputs are drawn
per real edge with numpy and scattered into both layouts, and outputs are
compared on real rows only.

Tolerances: float32 on both sides with sums taken in a different order (the
TPU kernels' one-hot matmuls and running window shifts against the port's
index sums and global segment shift): atol 1e-5 x the reference's scale,
rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.graph.view_graph import build_view_graph as jax_build_view_graph
from gasfm_tpu.models.layers import PendingUpdate as JaxPendingUpdate
from gasfm_tpu.ops.gatv2 import (
    gatv2_attend_dual as jax_attend_dual,
    gatv2_layer_frontend as jax_layer_frontend,
    merged_layer_frontend as jax_merged_frontend,
)
from gasfm_tpu.ops.pallas.fused_loss import fused_esfm_terms as jax_esfm_terms
from gasfm_tpu.ops.pallas.packing import pack_edges, unpack_edges
from gasfm_tpu.ops.segment import set_kernel_mode

from gasfm_tpu_torch.graph.view_graph import build_view_graph
from gasfm_tpu_torch.ops.kernels.fused_dual_attn import fused_dual_attend, fused_frontend
from gasfm_tpu_torch.ops.kernels.fused_layer_step import fused_layer_step
from gasfm_tpu_torch.ops.kernels.fused_loss import fused_esfm_terms

HEADS = 4
LAYER_STEP_FORMS = ["skip_and_res", "first_layer", "raw_prologue"]


@pytest.fixture(autouse=True)
def _interpret_mode():
    set_kernel_mode("interpret")
    yield
    set_kernel_mode("auto")


def make_graphs():
    """The JAX graph, the port graph and the JAX real-edge mask of one
    small scene."""
    data = jax_synthetic_scene(n_views=8, n_points=600, visibility=0.5, seed=9)
    jg = jax_build_view_graph(data.M, data.Ns)
    pg = build_view_graph(data.M, data.Ns, device="cpu")
    mask = np.asarray(jg.edge_mask)
    assert mask.sum() == pg.num_edges
    return jg, pg, mask


@pytest.fixture(scope="module")
def graphs():
    return make_graphs()


class Draw:
    """Seeded inputs handed to both packages: per-edge arrays in both edge
    layouts, per-node tables padded to the JAX capacities."""

    def __init__(self, graphs, seed):
        self.jg, self.pg, self.mask = graphs
        self.rng = np.random.default_rng(seed)

    def arr(self, *shape, scale=1.0):
        return (self.rng.standard_normal(shape) * scale).astype(np.float32)

    def edges(self, d, scale=1.0):
        real = self.arr(self.pg.num_edges, d, scale=scale)
        padded = np.zeros((self.mask.shape[0], d), np.float32)
        padded[self.mask] = real
        return padded, torch.from_numpy(real)

    def ln_edges(self, d):
        """Edge rows for a LayerNorm input. The flax-form variance
        E[x^2] - mean^2 loses most digits when an edge's features nearly
        coincide, which random pairs do at De = 2; keep the two apart."""
        padded, real = self.edges(d, scale=2.0)
        if d == 2:
            gap = self.rng.uniform(0.5, 2.0, size=real.shape[0]).astype(np.float32)
            sign = np.where(self.rng.random(real.shape[0]) < 0.5, -1.0, 1.0).astype(np.float32)
            rows = real.numpy()  # shares memory with the tensor
            rows[:, 1] = rows[:, 0] - sign * gap
            padded[self.mask] = rows
        return padded, real

    def table(self, rows_real, rows_cap, d, scale=1.0):
        real = self.arr(rows_real, d, scale=scale)
        padded = np.zeros((rows_cap, d), np.float32)
        padded[:rows_real] = real
        return padded, torch.from_numpy(real)

    def pt_table(self, d, scale=1.0):
        return self.table(self.pg.num_pts, self.jg.num_pts, d, scale)

    def cam_table(self, d, scale=1.0):
        return self.table(self.pg.num_cams, self.jg.num_cams, d, scale)


def assert_close(got, want, name):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5 * scale, err_msg=name)


def frontend_params(draw, De, D):
    """Per-edge frontend parameters: LayerNorm (De,), the two source linears
    in flax (in, out) layout, attention vectors (H, C), query tables."""
    C = D // HEADS
    p = dict(
        lng=draw.arr(De) * 0.5 + 1.0, lnb=draw.arr(De, scale=0.1),
        wlp=draw.arr(De, D, scale=0.3), blp=draw.arr(D, scale=0.1),
        wlc=draw.arr(De, D, scale=0.3), blc=draw.arr(D, scale=0.1),
        att_p=draw.arr(HEADS, C), att_c=draw.arr(HEADS, C),
    )
    p["xr_p"], p["xr_p_t"] = draw.pt_table(D)
    p["xr_c"], p["xr_c_t"] = draw.cam_table(D)
    return p


def jax_frontend_args(p, jg, D):
    C = D // HEADS
    j = {k: jnp.asarray(v) for k, v in p.items() if not k.endswith("_t")}
    return (j["wlp"], j["blp"], j["att_p"], j["xr_p"].reshape(-1, HEADS, C),
            jg.pt_idx, jg.num_pts, jg.pt_segment_windows(),
            j["wlc"], j["blc"], j["att_c"], j["xr_c"].reshape(-1, HEADS, C),
            jg.cam_idx, jg.num_cams)


def port_frontend_args(p):
    t = {k: torch.from_numpy(v) for k, v in p.items() if not k.endswith("_t")}
    return (t["wlp"].T, t["blp"], t["wlc"].T, t["blc"], p["xr_p_t"], p["xr_c_t"],
            t["att_p"].reshape(-1), t["att_c"].reshape(-1))


def dual_attend_pairs(graphs, D):
    """[(output name, port, JAX)] for the dual core at width D."""
    draw = Draw(graphs, seed=1)
    jg, pg, mask = graphs
    C = D // HEADS
    xl_p, xl_p_t = draw.edges(D)
    xl_c, xl_c_t = draw.edges(D)
    xr_p, xr_p_t = draw.pt_table(D)
    xr_c, xr_c_t = draw.cam_table(D)
    att_p, att_c = draw.arr(HEADS, C), draw.arr(HEADS, C)
    want_p, want_c = jax_attend_dual(
        jnp.asarray(xl_p).reshape(-1, HEADS, C), jnp.asarray(xr_p).reshape(-1, HEADS, C),
        jnp.asarray(att_p), jg.pt_idx, jg.num_pts, jg.pt_segment_windows(),
        jnp.asarray(xl_c).reshape(-1, HEADS, C), jnp.asarray(xr_c).reshape(-1, HEADS, C),
        jnp.asarray(att_c), jg.cam_idx, jg.num_cams, edge_mask=jg.edge_mask,
    )
    got_p, got_c = fused_dual_attend(
        xl_p_t, xl_c_t, xr_p_t, xr_c_t, torch.from_numpy(att_p).reshape(-1),
        torch.from_numpy(att_c).reshape(-1), pg, HEADS)
    return [("out_pt", got_p, np.asarray(want_p).reshape(-1, D)[: pg.num_pts]),
            ("out_cam", got_c, np.asarray(want_c).reshape(-1, D)[: pg.num_cams])]


@pytest.mark.parametrize("D", [32, 4])
def test_fused_dual_attend_matches_jax(graphs, D):
    for name, got, want in dual_attend_pairs(graphs, D):
        assert_close(got, want, name)


def frontend_pairs(graphs, De, D, raw_prologue):
    draw = Draw(graphs, seed=2)
    jg, pg, mask = graphs
    e, e_t = draw.ln_edges(De)
    p = frontend_params(draw, De, D)
    en, want_p, want_c = jax_layer_frontend(
        jnp.asarray(e), jnp.asarray(p["lng"]), jnp.asarray(p["lnb"]), 1e-5,
        *jax_frontend_args(p, jg, D), edge_mask=jg.edge_mask, raw_prologue=raw_prologue,
    )
    got_en, got_p, got_c = fused_frontend(
        e_t, torch.from_numpy(p["lng"]), torch.from_numpy(p["lnb"]),
        *port_frontend_args(p), pg, HEADS, eps=1e-5, raw_prologue=raw_prologue)
    return [("e_norm", got_en, np.asarray(en)[mask]),
            ("out_pt", got_p, np.asarray(want_p).reshape(-1, D)[: pg.num_pts]),
            ("out_cam", got_c, np.asarray(want_c).reshape(-1, D)[: pg.num_cams])]


@pytest.mark.parametrize("raw_prologue", [False, True])
@pytest.mark.parametrize("De,D", [(2, 4), (32, 32)])
def test_fused_frontend_matches_jax(graphs, De, D, raw_prologue):
    for name, got, want in frontend_pairs(graphs, De, D, raw_prologue):
        assert_close(got, want, name)


def layer_step_pairs(graphs, form):
    draw = Draw(graphs, seed=3)
    jg, pg, mask = graphs
    De = D = 32
    d_in, d2 = (2, 2) if form == "first_layer" else (32, 2)
    has_res = form != "first_layer"
    raw = form == "raw_prologue"
    chunk = jg.chunk
    en, en_t = draw.edges(d_in)
    skip2, skip2_t = draw.edges(d2)
    res, res_t = draw.edges(De) if has_res else (None, None)
    w_e, w_uv = draw.arr(d_in, De, scale=0.3), draw.arr(d2, De, scale=0.3)
    b = draw.arr(De, scale=0.1)
    ps, ps_t = draw.pt_table(De)
    pv, pv_t = draw.cam_table(De)
    pgl = draw.arr(1, De)
    p = frontend_params(draw, De, D)
    if raw:  # the final aggregation: dummy LayerNorm operands
        p["lng"], p["lnb"] = np.ones(De, np.float32), np.zeros(De, np.float32)

    pending = JaxPendingUpdate(
        en=pack_edges(jnp.asarray(en), chunk), skip2=pack_edges(jnp.asarray(skip2), chunk),
        res=pack_edges(jnp.asarray(res), chunk) if has_res else None,
        w_e=jnp.asarray(w_e), b=jnp.asarray(b), w_uv=jnp.asarray(w_uv),
        ps=jnp.asarray(ps), pv=jnp.asarray(pv), pg=jnp.asarray(pgl),
    )
    e_prev, en_next, want_p, want_c = jax_merged_frontend(
        pending, jnp.asarray(p["lng"]), jnp.asarray(p["lnb"]), 1e-5,
        *jax_frontend_args(p, jg, D), edge_mask=jg.edge_mask, raw_prologue=raw,
    )
    w = torch.from_numpy(np.concatenate([w_e, w_uv], axis=0).T.copy())
    got_el, got_en, got_p, got_c = fused_layer_step(
        en_t, skip2_t, res_t, w, torch.from_numpy(b), ps_t, pv_t, torch.from_numpy(pgl),
        torch.from_numpy(p["lng"]), torch.from_numpy(p["lnb"]),
        *port_frontend_args(p), pg, HEADS, eps=1e-5, raw_prologue=raw)
    return [("e_l", got_el, np.asarray(unpack_edges(e_prev, chunk))[mask]),
            ("e_norm_next", got_en, np.asarray(unpack_edges(en_next, chunk))[mask]),
            ("out_pt", got_p, np.asarray(want_p).reshape(-1, D)[: pg.num_pts]),
            ("out_cam", got_c, np.asarray(want_c).reshape(-1, D)[: pg.num_cams])]


@pytest.mark.parametrize("form", LAYER_STEP_FORMS)
def test_fused_layer_step_matches_jax(graphs, form):
    for name, got, want in layer_step_pairs(graphs, form):
        assert_close(got, want, name)


def esfm_terms_pairs(graphs, hinge):
    """[(name, port, JAX)] for the loss terms: the edge sum, then the count
    the JAX kernel hands back beside it."""
    draw = Draw(graphs, seed=4)
    jg, pg, mask = graphs
    margin, hinge_w = 1e-4, 1.0 if hinge else 0.0
    # Random cameras and points: depths of both signs exercise both terms.
    P, P_t = draw.cam_table(12)
    X, X_t = draw.pt_table(4)
    X[:, 3] = 1.0
    X_t[:, 3] = 1.0
    # eq_mode only selects which count the JAX kernel hands back:
    # valid-and-positive for "valid_only", all valid edges for "all".
    eq_mode = "valid_only" if hinge else "all"
    edge_sum, count = jax_esfm_terms(
        jnp.asarray(P), jnp.asarray(X), jg.uv, jg, margin, hinge, hinge_w, eq_mode,
        interpret=True)
    got = fused_esfm_terms(P_t, X_t, pg, margin, hinge, hinge_w).numpy()
    depth = np.einsum("ej,ej->e", P_t.numpy()[pg.cam_idx.long()][:, 8:12],
                      X_t.numpy()[pg.pt_idx.long()])
    assert 0 < (depth >= margin).sum() < pg.num_edges  # both branches taken
    assert got[1] == pg.num_edges
    return [("edge_sum", got[0], float(edge_sum)),
            ("count", got[2 if hinge else 1], float(count))]


@pytest.mark.parametrize("hinge", [True, False])
def test_fused_esfm_terms_matches_jax(graphs, hinge):
    (name, got, want), (_, got_count, want_count) = esfm_terms_pairs(graphs, hinge)
    assert_close(got, want, name)
    assert got_count == want_count  # counts are exact


# ---------------------------------------------------------------------------
# Backward: the port's plain versions under autograd (the reference gradient
# of every backward kernel) against jax.vjp through the JAX package's
# custom_vjp kernels, in interpret mode. Same inputs as above, seeded
# cotangents on the real rows (zero on the JAX layout's padding); gradients
# compared on real rows. Tolerance: atol 1e-5 x the reference's scale, rtol
# 1e-4, as for the forward — except the De = 2 frontend's d e (see below).
# ---------------------------------------------------------------------------


def port_grads(fn, leaves, cots):
    """{name: d leaf} of sum <fn(**leaves), cots> (None: output unused)."""
    ls = {k: v.detach().clone().requires_grad_() for k, v in leaves.items()}
    outs = fn(**ls)
    used = [(o, c) for o, c in zip(outs, cots) if c is not None]
    grads = torch.autograd.grad([o for o, _ in used], list(ls.values()),
                                [torch.as_tensor(c) for _, c in used])
    return dict(zip(ls, grads))


def padded_rows(real, rows_cap):
    out = np.zeros((rows_cap,) + real.shape[1:], np.float32)
    out[: real.shape[0]] = real
    return out


def dual_attend_grad_pairs(graphs):
    """[(gradient name, port, JAX)] for the dual core at D = 32."""
    import jax

    draw = Draw(graphs, seed=11)
    jg, pg, mask = graphs
    D = 32
    C = D // HEADS
    xl_p, xl_p_t = draw.edges(D)
    xl_c, xl_c_t = draw.edges(D)
    xr_p, xr_p_t = draw.pt_table(D)
    xr_c, xr_c_t = draw.cam_table(D)
    att_p, att_c = draw.arr(HEADS, C), draw.arr(HEADS, C)
    g_p, g_c = draw.arr(pg.num_pts, D), draw.arr(pg.num_cams, D)

    def f(xl_p, xr_p, att_p, xl_c, xr_c, att_c):
        return jax_attend_dual(
            xl_p.reshape(-1, HEADS, C), xr_p.reshape(-1, HEADS, C), att_p, jg.pt_idx,
            jg.num_pts, jg.pt_segment_windows(), xl_c.reshape(-1, HEADS, C),
            xr_c.reshape(-1, HEADS, C), att_c, jg.cam_idx, jg.num_cams, edge_mask=jg.edge_mask)

    outs, vjp = jax.vjp(f, *map(jnp.asarray, (xl_p, xr_p, att_p, xl_c, xr_c, att_c)))
    cots = (padded_rows(g_p, jg.num_pts).reshape(outs[0].shape),
            padded_rows(g_c, jg.num_cams).reshape(outs[1].shape))
    want = dict(zip(("xl_p", "xr_p", "att_p", "xl_c", "xr_c", "att_c"),
                    map(np.asarray, vjp(tuple(map(jnp.asarray, cots))))))
    got = port_grads(
        lambda **a: fused_dual_attend(a["xl_p"], a["xl_c"], a["xr_p"], a["xr_c"], a["att_p"],
                                      a["att_c"], pg, HEADS),
        dict(xl_p=xl_p_t, xl_c=xl_c_t, xr_p=xr_p_t, xr_c=xr_c_t,
             att_p=torch.from_numpy(att_p).reshape(-1), att_c=torch.from_numpy(att_c).reshape(-1)),
        (g_p, g_c))
    pairs = []
    for side, n_rows in (("p", pg.num_pts), ("c", pg.num_cams)):
        pairs += [(f"d xl_{side}", got[f"xl_{side}"], want[f"xl_{side}"][mask]),
                  (f"d xr_{side}", got[f"xr_{side}"], want[f"xr_{side}"][:n_rows]),
                  (f"d att_{side}", got[f"att_{side}"], want[f"att_{side}"].reshape(-1))]
    return pairs


def test_fused_dual_attend_grads_match_jax(graphs):
    for name, got, want in dual_attend_grad_pairs(graphs):
        assert_close(got, want, name)


HUB_POINT, HUB_CAM = 5, 3  # of hub_graphs: a point every view sees, a camera most points do


@pytest.fixture(scope="module")
def hub_graphs():
    """A 40-view scene in which point HUB_POINT is seen by every view and
    camera HUB_CAM sees nine points in ten: on the port's side both are long
    segments, cut into several 32-edge chunks by the dual core's backward."""
    data = jax_synthetic_scene(n_views=40, n_points=400, visibility=0.3, seed=4)
    M = data.M.copy()
    rng = np.random.default_rng(6)
    M[:, HUB_POINT] = rng.uniform(400.0, 600.0, M.shape[0])
    seen = rng.random(M.shape[1]) < 0.9
    M[2 * HUB_CAM:2 * HUB_CAM + 2, seen] = rng.uniform(400.0, 600.0, (2, int(seen.sum())))
    jg = jax_build_view_graph(M, data.Ns)
    pg = build_view_graph(M, data.Ns, device="cpu")
    mask = np.asarray(jg.edge_mask)
    assert mask.sum() == pg.num_edges
    return jg, pg, mask


def test_fused_dual_attend_grads_match_jax_hub(hub_graphs, monkeypatch):
    """The plain backward (what the card's #2 is held to) against the JAX
    dual kernel's backward ``_dual_bwd_raw`` in interpret mode, where a
    point and a camera span several of the port's 32-edge chunks."""
    from gasfm_tpu.ops.pallas import fused_dual_attn as jax_fda

    from gasfm_tpu_torch.ops.kernels.fused_dual_attn import SPLIT_ROWS

    calls = []

    def spy(*a, _fn=jax_fda._dual_bwd_raw, **k):
        calls.append(1)
        return _fn(*a, **k)

    monkeypatch.setattr(jax_fda, "_dual_bwd_raw", spy)
    _, pg, _ = hub_graphs
    n_views, n_points = pg.num_cams, pg.num_pts
    assert int(pg.pt_ptr[HUB_POINT + 1] - pg.pt_ptr[HUB_POINT]) == n_views > SPLIT_ROWS
    assert int(pg.cam_ptr[HUB_CAM + 1] - pg.cam_ptr[HUB_CAM]) >= 0.8 * n_points
    assert HUB_POINT in pg.pt_chunks(SPLIT_ROWS).long_seg
    assert HUB_CAM in pg.cam_chunks(SPLIT_ROWS).long_seg
    for name, got, want in dual_attend_grad_pairs(hub_graphs):
        assert_close(got, want, name)
    assert calls  # the JAX kernel's backward was reached


def jax_frontend_fn(jg, D, raw_prologue):
    C = D // HEADS

    def f(e, lng, lnb, wlp, blp, att_p, xr_p, wlc, blc, att_c, xr_c):
        en, op, oc = jax_layer_frontend(
            e, lng, lnb, 1e-5, wlp, blp, att_p, xr_p.reshape(-1, HEADS, C), jg.pt_idx,
            jg.num_pts, jg.pt_segment_windows(), wlc, blc, att_c, xr_c.reshape(-1, HEADS, C),
            jg.cam_idx, jg.num_cams, edge_mask=jg.edge_mask, raw_prologue=raw_prologue)
        return en, op, oc

    return f


FRONT_KEYS = ("lng", "lnb", "wlp", "blp", "att_p", "xr_p", "wlc", "blc", "att_c", "xr_c")


def param_grad_pairs(got, want, pg, raw_prologue):
    """The frontend parameters' and queries' gradients: the port's torch
    layouts against the JAX flax layouts, real rows."""
    pairs = [("d xr_p", got["xr_p"], want["xr_p"][: pg.num_pts]),
             ("d xr_c", got["xr_c"], want["xr_c"][: pg.num_cams])]
    if not raw_prologue:
        pairs += [("d ln_scale", got["ln_scale"], want["lng"]),
                  ("d ln_bias", got["ln_bias"], want["lnb"])]
    for side in ("p", "c"):
        pairs += [(f"d wl{side}", got[f"wl{side}"].T, want[f"wl{side}"]),
                  (f"d bl{side}", got[f"bl{side}"], want[f"bl{side}"]),
                  (f"d att_{side}", got[f"att_{side}"], want[f"att_{side}"].reshape(-1))]
    return pairs


def frontend_grad_pairs(graphs, De, D, raw_prologue):
    import jax

    draw = Draw(graphs, seed=12)
    jg, pg, mask = graphs
    e, e_t = draw.ln_edges(De)
    p = frontend_params(draw, De, D)
    g_en, g_p, g_c = draw.arr(pg.num_edges, De), draw.arr(pg.num_pts, D), draw.arr(pg.num_cams, D)
    f = jax_frontend_fn(jg, D, raw_prologue)
    args = [jnp.asarray(e)] + [jnp.asarray(p[k]) for k in FRONT_KEYS]
    outs, vjp = jax.vjp(f, *args)
    g_en_pad = np.zeros(outs[0].shape, np.float32)
    g_en_pad[mask] = g_en
    cots = (g_en_pad, padded_rows(g_p, jg.num_pts).reshape(outs[1].shape),
            padded_rows(g_c, jg.num_cams).reshape(outs[2].shape))
    want = dict(zip(("e",) + FRONT_KEYS, map(np.asarray, vjp(tuple(map(jnp.asarray, cots))))))
    t = {k: torch.from_numpy(v) for k, v in p.items() if not k.endswith("_t")}
    leaves = dict(e=e_t, wlp=t["wlp"].T.contiguous(), blp=t["blp"], wlc=t["wlc"].T.contiguous(),
                  blc=t["blc"], xr_p=p["xr_p_t"], xr_c=p["xr_c_t"],
                  att_p=t["att_p"].reshape(-1), att_c=t["att_c"].reshape(-1))
    if not raw_prologue:
        leaves.update(ln_scale=t["lng"], ln_bias=t["lnb"])
    got = port_grads(
        lambda **a: fused_frontend(
            a["e"], a.get("ln_scale"), a.get("ln_bias"), a["wlp"], a["blp"], a["wlc"], a["blc"],
            a["xr_p"], a["xr_c"], a["att_p"], a["att_c"], pg, HEADS, eps=1e-5,
            raw_prologue=raw_prologue),
        leaves, (g_en, g_p, g_c))
    return [("d e", got["e"], want["e"][mask])] + param_grad_pairs(got, want, pg, raw_prologue)


@pytest.mark.parametrize("raw_prologue", [False, True])
@pytest.mark.parametrize("De,D", [(2, 4), (32, 32)])
def test_fused_frontend_grads_match_jax(graphs, De, D, raw_prologue):
    for name, got, want in frontend_grad_pairs(graphs, De, D, raw_prologue):
        if name == "d e" and De == 2 and not raw_prologue:
            # Over two features the LayerNorm's output is +-1/sqrt(1 + eps/var)
            # whatever the input, so d e is a near-zero difference of O(1)
            # terms: its rounding scales with those terms (~1), not with |d e|.
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5, err_msg=name)
        else:
            assert_close(got, want, name)


def layer_step_grad_pairs(graphs, form):
    import jax

    draw = Draw(graphs, seed=13)
    jg, pg, mask = graphs
    De = D = 32
    C = D // HEADS
    d_in, d2 = (2, 2) if form == "first_layer" else (32, 2)
    has_res = form != "first_layer"
    raw = form == "raw_prologue"
    chunk = jg.chunk
    en, en_t = draw.edges(d_in)
    skip2, skip2_t = draw.edges(d2)
    res, res_t = draw.edges(De) if has_res else (None, None)
    w_e, w_uv = draw.arr(d_in, De, scale=0.3), draw.arr(d2, De, scale=0.3)
    b = draw.arr(De, scale=0.1)
    ps, ps_t = draw.pt_table(De)
    pv, pv_t = draw.cam_table(De)
    pgl = draw.arr(1, De)
    p = frontend_params(draw, De, D)
    if raw:
        p["lng"], p["lnb"] = np.ones(De, np.float32), np.zeros(De, np.float32)
    E = pg.num_edges
    g_el, g_en = draw.arr(E, De), draw.arr(E, De)
    g_p, g_c = draw.arr(pg.num_pts, D), draw.arr(pg.num_cams, D)

    upd_keys = ("en", "skip2") + (("res",) if has_res else ()) + (
        "w_e", "b", "w_uv", "ps", "pv", "pg")

    def f(*a):
        u = dict(zip(upd_keys, a[: len(upd_keys)]))
        fr = dict(zip(FRONT_KEYS, a[len(upd_keys):]))
        pending = JaxPendingUpdate(
            en=pack_edges(u["en"], chunk), skip2=pack_edges(u["skip2"], chunk),
            res=pack_edges(u["res"], chunk) if has_res else None, w_e=u["w_e"], b=u["b"],
            w_uv=u["w_uv"], ps=u["ps"], pv=u["pv"], pg=u["pg"])
        e_prev, en_next, op, oc = jax_merged_frontend(
            pending, fr["lng"], fr["lnb"], 1e-5, fr["wlp"], fr["blp"], fr["att_p"],
            fr["xr_p"].reshape(-1, HEADS, C), jg.pt_idx, jg.num_pts, jg.pt_segment_windows(),
            fr["wlc"], fr["blc"], fr["att_c"], fr["xr_c"].reshape(-1, HEADS, C), jg.cam_idx,
            jg.num_cams, edge_mask=jg.edge_mask, raw_prologue=raw)
        return unpack_edges(e_prev, chunk), unpack_edges(en_next, chunk), op, oc

    upd = dict(en=en, skip2=skip2, res=res, w_e=w_e, b=b, w_uv=w_uv, ps=ps, pv=pv, pg=pgl)
    args = [jnp.asarray(upd[k]) for k in upd_keys] + [jnp.asarray(p[k]) for k in FRONT_KEYS]
    outs, vjp = jax.vjp(f, *args)

    def edge_pad(real):
        out = np.zeros(outs[0].shape, np.float32)
        out[mask] = real
        return out

    cots = (edge_pad(g_el), edge_pad(g_en), padded_rows(g_p, jg.num_pts).reshape(outs[2].shape),
            padded_rows(g_c, jg.num_cams).reshape(outs[3].shape))
    want = dict(zip(upd_keys + FRONT_KEYS, map(np.asarray, vjp(tuple(map(jnp.asarray, cots))))))

    t = {k: torch.from_numpy(v) for k, v in p.items() if not k.endswith("_t")}
    leaves = dict(en=en_t, skip2=skip2_t, w=torch.from_numpy(np.concatenate([w_e, w_uv]).T.copy()),
                  b=torch.from_numpy(b), ps=ps_t, pv=pv_t, pg=torch.from_numpy(pgl),
                  wlp=t["wlp"].T.contiguous(), blp=t["blp"], wlc=t["wlc"].T.contiguous(),
                  blc=t["blc"], xr_p=p["xr_p_t"], xr_c=p["xr_c_t"],
                  att_p=t["att_p"].reshape(-1), att_c=t["att_c"].reshape(-1))
    if has_res:
        leaves["res"] = res_t
    if not raw:
        leaves.update(ln_scale=t["lng"], ln_bias=t["lnb"])
    # Under raw_prologue the port's e_norm_next IS e_l: one tensor, both
    # cotangents.
    got = port_grads(
        lambda **a: fused_layer_step(
            a["en"], a["skip2"], a.get("res"), a["w"], a["b"], a["ps"], a["pv"], a["pg"],
            a.get("ln_scale"), a.get("ln_bias"), a["wlp"], a["blp"], a["wlc"], a["blc"],
            a["xr_p"], a["xr_c"], a["att_p"], a["att_c"], pg, HEADS, eps=1e-5, raw_prologue=raw),
        leaves, (g_el + g_en, None, g_p, g_c) if raw else (g_el, g_en, g_p, g_c))
    pairs = [(f"d {k}", got[k], want[k][mask])
             for k in ("en", "skip2") + (("res",) if has_res else ())]
    pairs += [("d w_e", got["w"][:, :d_in].T, want["w_e"]),
              ("d w_uv", got["w"][:, d_in:].T, want["w_uv"]),
              ("d b", got["b"], want["b"]), ("d pg", got["pg"], want["pg"]),
              ("d ps", got["ps"], want["ps"][: pg.num_pts]),
              ("d pv", got["pv"], want["pv"][: pg.num_cams])]
    return pairs + param_grad_pairs(got, want, pg, raw)


@pytest.mark.parametrize("form", LAYER_STEP_FORMS)
def test_fused_layer_step_grads_match_jax(graphs, form):
    for name, got, want in layer_step_grad_pairs(graphs, form):
        assert_close(got, want, name)


def esfm_terms_grad_pairs(graphs, eq_mode, hinge):
    import jax

    draw = Draw(graphs, seed=14)
    jg, pg, mask = graphs
    margin, hinge_w = 1e-4, 1.0 if hinge else 0.0
    P, P_t = draw.cam_table(12)
    X, X_t = draw.pt_table(4)
    X[:, 3] = 1.0
    X_t[:, 3] = 1.0
    coef = 1.0 / pg.num_edges

    def f(P, X):
        return jax_esfm_terms(P, X, jg.uv, jg, margin, hinge, hinge_w, eq_mode, interpret=True)

    (edge_sum, count), vjp = jax.vjp(f, jnp.asarray(P), jnp.asarray(X))
    dP, dX = vjp((jnp.asarray(coef, jnp.float32), jnp.zeros_like(count)))
    got = port_grads(
        lambda **a: (fused_esfm_terms(a["P"], a["X"], pg, margin, hinge, hinge_w, eq_mode)[0],),
        dict(P=P_t, X=X_t), (torch.tensor(coef, dtype=torch.float32),))
    depth = np.einsum("ej,ej->e", P_t.numpy()[pg.cam_idx.long()][:, 8:12],
                      X_t.numpy()[pg.pt_idx.long()])
    assert 0 < (depth >= margin).sum() < pg.num_edges  # both branches taken
    return [("d P", got["P"], np.asarray(dP)[: pg.num_cams]),
            ("d X", got["X"], np.asarray(dX)[: pg.num_pts])]


@pytest.mark.parametrize("hinge", [True, False])
@pytest.mark.parametrize("eq_mode", ["none", "all", "valid_only"])
def test_fused_esfm_terms_grads_match_jax(graphs, eq_mode, hinge):
    for name, got, want in esfm_terms_grad_pairs(graphs, eq_mode, hinge):
        assert_close(got, want, name)


@pytest.mark.parametrize("De,K,Dp,Dc", [(32, 34, 32, 32), (32, 4, 32, 32), (5, 7, 3, 6)])
def test_layer_step_bwd_partial_row_splits_into_the_weight_gradients(De, K, Dp, Dc):
    """The layer step's backward writes its weight gradients as one row per
    block (``StepRow``, csrc/edge_tile.cuh: d wlp (Dp, De), d blp, d wlc
    (Dc, De), d blc, d w (De, K), d b, d ln_scale, d ln_bias) and sums the
    rows; ``split_step_sums`` hands back each gradient from a row built by
    hand in that order, as views of it."""
    from gasfm_tpu_torch.ops.kernels.fused_layer_step import split_step_sums, step_sums_len

    gen = torch.Generator().manual_seed(De * K)
    want = [torch.randn(shape, generator=gen) for shape in
            ((Dp, De), (Dp,), (Dc, De), (Dc,), (De, K), (De,), (De,), (De,))]
    row = torch.cat([t.reshape(-1) for t in want])
    assert row.numel() == step_sums_len(De, K, Dp, Dc)
    got = split_step_sums(row, De, K, Dp, Dc)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        assert torch.equal(g, w) and g.data_ptr() >= row.data_ptr()
    assert got[4][De - 1, K - 1] == row[(Dp + Dc) * (De + 1) + De * K - 1]
