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
