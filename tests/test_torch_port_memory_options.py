"""The JAX package's two activation-memory options in the port:
``compile.stream_dtype = "bf16"`` (the merged path's edge streams and their
cotangents stored in bfloat16, ``GraphAttnSfMNet(stream_dtype=...)``) and
``model.remat_layers`` (each layer rematerialized in the backward).

The JAX side runs as tests/test_packed.py's ``TestBF16Streams`` runs it:
``GASFM_STREAM_DTYPE``, ``GASFM_PACKED`` and ``GASFM_MERGED`` set, its
Pallas kernels in interpret mode; the port carries the JAX weights in
through ``params_from_jax`` and runs its kernels' plain versions (CPU
tensors). One small scene (8 views, 600 points), the 4-layer model of
tests/test_torch_port_model.py.

The JAX package's layer-step backward clamps exp(l - m) at 1 where a logit
recomputed from the stored stream passes its shift m; the port's shifts
past the forward's max by a margin and clamps nothing. On the JAX init the
two runs agree as below; on other weights the gap this leaves reaches a
quarter of the bf16 shift on the first layer's leaves (PERF.md §6).

Tolerances: bf16 streams round the activations and their cotangents once
per layer, so the port's bf16 run is held against the JAX package's bf16
run relative to what the rounding itself moves: per output and per
gradient leaf ``|port_bf16 - jax_bf16| <= RATIO * |jax_bf16 - jax_f32|``
(Frobenius norms), RATIO = 0.25 (see ``assert_follows_jax_rounding`` for
the leaves that are zero in exact arithmetic, and its floor); the
kernels' plain versions under bf16 against their JAX kernels: float32
outputs at the f32 kernels' tolerance (tests/test_torch_port_kernels.py),
bf16 outputs within one bf16 ulp of the larger magnitude plus that
tolerance. The layer step's backward recomputes from its stored e_l, which
the two packages round differently on the few edges whose float32 sums lie
at a bf16 tie, and whose softmax the JAX kernel clamps at its window's max
(``assert_bf16_close_but_ties``): its per-edge cotangents are held on all
but TIE_ROWS of the edges, all of them and its summed gradients at TIE_TOL
in relative Frobenius norm (measured: up to 6.3e-4 in the interior form,
up to 2.1e-3 in the final aggregation's raw form on its camera side, whose
logits, of the unnormalized stream, span more).
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gasfm_tpu.config import ConfigFactory
from gasfm_tpu.data.synthetic import generate_synthetic_scene as jax_synthetic_scene
from gasfm_tpu.graph.view_graph import build_scene_graph as jax_build_scene_graph
from gasfm_tpu.losses import DirectDepthLoss as JaxDirectDepthLoss
from gasfm_tpu.losses import ESFMLoss as JaxESFMLoss
from gasfm_tpu.models.convert import convert_reference_state_dict
from gasfm_tpu.graph.view_graph import WINDOW
from gasfm_tpu.models.gasfm import GraphAttnSfMNet as JaxGraphAttnSfMNet
from gasfm_tpu.models.layers import PendingUpdate as JaxPendingUpdate
from gasfm_tpu.ops.gatv2 import merged_layer_frontend as jax_merged_frontend
from gasfm_tpu.ops.pallas import fused_proj_update as jax_fused_proj_update
from gasfm_tpu.ops.pallas.packing import pack_edges, unpack_edges
from gasfm_tpu.ops.segment import set_kernel_mode

from gasfm_tpu_torch.graph.view_graph import build_scene_graph
from gasfm_tpu_torch.losses import DEPTH_LOSS, DirectDepthLoss, ESFMLoss, FLAGSHIP_LOSS
from gasfm_tpu_torch.models.convert import params_from_jax
from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
from gasfm_tpu_torch.ops.kernels.fused_dual_attn import fused_frontend
from gasfm_tpu_torch.ops.kernels.fused_layer_step import fused_layer_step
from gasfm_tpu_torch.ops.kernels.fused_proj_update import projection_update
from gasfm_tpu_torch.train.loop import TrainingSession

import test_torch_port_kernels as K

from test_torch_port_depth import DEPTH3
from test_torch_port_depth import conf as depth_conf
from test_torch_port_model import CONFIGS
from test_torch_port_train import conf

FLAGSHIP_SHAPE = CONFIGS["flagship_shape"]
SMALL = dict(n_views=8, n_points=600, visibility=0.5, seed=9)
RATIO = 0.25
NOISE = 1e-5  # a leaf below NOISE x the largest f32 gradient is zero in exact arithmetic
FLOOR = 1e-7
TIE_ROWS = 0.01  # at most this share of a layer step's edges off by more (see below)
TIE_TOL = 3e-3  # what those edges move the layer step's gradients by


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    set_kernel_mode("auto")


@pytest.fixture(scope="module")
def kernel_graphs():
    return K.make_graphs()


@functools.lru_cache(maxsize=None)
def scene_data(depth=False):
    return jax_synthetic_scene(**SMALL, store_depth_targets=depth)


def jax_graph(depth=False):
    data = scene_data(depth)
    return jax_build_scene_graph(data.M, data.Ns, data.y,
                                 gt_depths_dense=data.depths if depth else None)


def port_scene(depth=False):
    data = scene_data(depth)
    return build_scene_graph(data.M, data.Ns, data.y, device="cpu",
                             gt_depths_dense=data.depths if depth else None)


@functools.lru_cache(maxsize=None)
def jax_params(widths_key):
    """The JAX package's init of the model (its composite path, jitted)."""
    widths = dict(widths_key)
    scene = jax_graph(widths.get("depth_head_enabled", False))
    params = jax.jit(JaxGraphAttnSfMNet(**widths).init)(jax.random.PRNGKey(0), scene.graph)
    return jax.tree_util.tree_map(np.asarray, params)


def jax_loss(depth):
    return JaxDirectDepthLoss(depth_conf()) if depth else JaxESFMLoss(conf())


@functools.lru_cache(maxsize=None)
def jax_run(widths_key, stream, remat=False):
    """The JAX package's loss and parameter gradients under
    ``GASFM_STREAM_DTYPE=stream``, packed and merged, interpret mode, as one
    jitted program (op by op, interpret mode compiles each of some 600
    primitives on its own)."""
    widths = dict(widths_key)
    depth = widths.get("depth_head_enabled", False)
    params = jax_params(widths_key)
    mp = pytest.MonkeyPatch()
    mp.setenv("GASFM_STREAM_DTYPE", stream)
    mp.setenv("GASFM_PACKED", "1")
    mp.setenv("GASFM_MERGED", "1")
    set_kernel_mode("interpret")
    try:
        scene = jax_graph(depth)
        model, loss = JaxGraphAttnSfMNet(**widths, remat_layers=remat), jax_loss(depth)
        value, grads = jax.jit(jax.value_and_grad(
            lambda p: loss(model.apply(p, scene.graph), scene)))(params)
        return float(value), jax.tree_util.tree_map(np.asarray, grads)
    finally:
        set_kernel_mode("auto")
        mp.undo()


def port_model(widths_key, **options):
    model = GraphAttnSfMNet(**dict(widths_key), **options)
    model.load_state_dict(params_from_jax(jax_params(widths_key)), strict=True)
    return model


@functools.lru_cache(maxsize=None)
def port_run(widths_key, stream_dtype=torch.float32, remat=False):
    """The port's loss and parameter gradients (plain path) as a flax tree,
    from the JAX init, and as the port's tensors."""
    depth = dict(widths_key).get("depth_head_enabled", False)
    model = port_model(widths_key, stream_dtype=stream_dtype, remat_layers=remat)
    loss = DirectDepthLoss(**DEPTH_LOSS) if depth else ESFMLoss(**FLAGSHIP_LOSS)
    session = TrainingSession(model, loss, device="cpu")
    value, _, grads = session.loss_and_grads(port_scene(depth))
    names = [k for k, p in session.model.named_parameters() if p.requires_grad]
    tree = convert_reference_state_dict({k: t.detach().numpy() for k, t in zip(names, grads)},
                                        "graph_attn_sfm.GraphAttnSfMNet")
    return float(value), tree, [g.detach().clone() for g in grads]


def leaf_pairs(*trees):
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(trees[0])]
    return list(zip(paths, zip(*(jax.tree_util.tree_leaves(t) for t in trees))))


def key(widths):
    return tuple(sorted(widths.items()))


FLAGSHIP_KEY = key(FLAGSHIP_SHAPE)
DEPTH_KEY = key(DEPTH3)


def assert_follows_jax_rounding(widths_key, f32_remat=False):
    """Loss and every gradient leaf: the port's bf16-stream run within RATIO
    of the JAX package's bf16 run, in units of what bf16 moves the JAX run
    from its f32 run (the port's f32 run as close). A leaf that is zero in
    exact arithmetic (its f32 gradient below NOISE x the largest;
    test_torch_port_train.py's NOISE note) is rounding noise in both
    packages, and bf16 moves it by what the rounded cotangents leave
    unbalanced: it is held within the JAX package's own shift (ratio 1).
    Every leaf gets FLOOR x the largest gradient entry besides. With
    ``f32_remat`` the JAX package's f32 run is its remat_layers run
    (tests/test_models.py holds it to the run without), which
    test_remat_layers_matches_jax_remat shares."""
    want_f32, want_bf16 = jax_run(widths_key, "f32", f32_remat), jax_run(widths_key, "bf16")
    got_f32, got_bf16 = port_run(widths_key)[:2], port_run(widths_key, torch.bfloat16)[:2]
    moved = abs(want_bf16[0] - want_f32[0])
    assert moved > 0, "bf16 streams moved nothing"
    assert abs(got_bf16[0] - want_bf16[0]) <= RATIO * moved, (got_bf16[0], want_bf16[0], moved)
    assert abs(got_f32[0] - want_f32[0]) <= RATIO * moved, (got_f32[0], want_f32[0], moved)
    largest = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(want_f32[1]))
    pairs = leaf_pairs(want_f32[1], want_bf16[1], got_f32[1], got_bf16[1])
    assert pairs
    for path, (wf, wb, gf, gb) in pairs:
        moved = float(np.linalg.norm(wb - wf))
        ratio = 1.0 if float(np.abs(wf).max()) < NOISE * largest else RATIO
        assert np.linalg.norm(gb - wb) <= ratio * moved + FLOOR * largest, (path, moved)
        assert np.linalg.norm(gf - wf) <= ratio * moved + FLOOR * largest, (path, moved)


def test_bf16_streams_follow_the_jax_rounding_points():
    """The 4-layer merged model (#3/#4 at layer 0, #5/#6 at layers 1-3 and
    the final aggregation): loss and gradients."""
    assert_follows_jax_rounding(FLAGSHIP_KEY, f32_remat=True)


def test_depth_flagship_bf16_streams_follow_the_jax_rounding_points():
    """The 3-layer depth model: its merged layer 1 materializes its update
    through #9/#10 in bf16, and its last, widening layer takes the stream
    upcast to float32."""
    assert_follows_jax_rounding(DEPTH_KEY)


@pytest.mark.parametrize("widths", [
    dict(FLAGSHIP_SHAPE, use_norm_proj_update=False),  # the unfused layer, ReLU only
    dict(FLAGSHIP_SHAPE, n_feat_proj=16),  # the unfused layer (16 wide)
], ids=["no_norm", "width16"])
def test_unfused_path_is_bitwise_unchanged(widths):
    model = GraphAttnSfMNet(**widths, generator=torch.Generator().manual_seed(0))
    assert not model.merged_path(port_scene().graph)
    runs = []
    for stream_dtype in (torch.float32, torch.bfloat16):
        m = copy.deepcopy(model)
        m.stream_dtype = stream_dtype
        session = TrainingSession(m, ESFMLoss(**FLAGSHIP_LOSS), device="cpu")
        value, _, grads = session.loss_and_grads(port_scene())
        runs.append((value, grads))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_dpesfm_is_bitwise_unchanged_by_the_key():
    """DPESFM from the learning conf with and without compile.stream_dtype
    = bf16: the same model, the same gradients bit for bit."""
    from gasfm_tpu_torch.config import load_config
    from gasfm_tpu_torch.losses import DPESFM_LOSS
    from gasfm_tpu_torch.models import get_model

    runs = []
    for extra in ([], ["compile.stream_dtype=bf16"]):
        conf = load_config("synth/optim_synth_dpesfm.conf", external_params=extra,
                           validate=False)
        model = get_model(conf, generator=torch.Generator().manual_seed(0))
        session = TrainingSession(model, ESFMLoss(**DPESFM_LOSS), device="cpu")
        value, _, grads = session.loss_and_grads(port_scene())
        runs.append((value, grads))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("stream_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_remat_layers_is_bitwise_the_same_step(stream_dtype):
    """model.remat_layers: the loss and gradients bit for bit those without
    it, under either stream dtype."""
    l0, _, g0 = port_run(FLAGSHIP_KEY, stream_dtype)
    l1, _, g1 = port_run(FLAGSHIP_KEY, stream_dtype, True)
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_remat_layers_matches_jax_remat():
    """The port with remat_layers against the JAX package with
    remat_layers=True (f32 streams): tests/test_torch_port_train.py's model
    tolerance (loss rtol 1e-5; gradients atol 5e-4 x the leaf's scale, rtol
    2e-3)."""
    want_loss, want = jax_run(FLAGSHIP_KEY, "f32", True)
    got_loss, got, _ = port_run(FLAGSHIP_KEY, torch.float32, True)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    for path, (w, g) in leaf_pairs(want, got):
        scale = max(2e-4, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=5e-4 * scale, rtol=2e-3, err_msg=path)


# ---------------------------------------------------------------------------
# The kernels' plain versions under bf16 streams against the JAX kernels
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


def bf16_round(a):
    """float32 numpy values rounded to bf16 (to nearest even), as float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


def assert_bf16_close(got, want, name):
    """bf16 results: within one bf16 ulp of the larger magnitude plus the
    float32 kernels' tolerance (tests/test_torch_port_kernels.py)."""
    got = (got.float() if isinstance(got, torch.Tensor) else torch.as_tensor(got)).numpy()
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    bound = ulp + 1e-4 * np.abs(want) + 1e-5 * scale
    assert np.all(np.abs(got - want) <= bound), (name, float(np.max(np.abs(got - want) - bound)))


def vjp_pairs(jax_fn, args, jax_outs_bf16, port_fn, leaves, out_names, grad_names, mask, pg,
              draw):
    """Run ``jax_fn`` (float32 arguments, its bf16 outputs upcast) under
    jax.vjp and ``port_fn`` (the port's leaves) under autograd with the same
    cotangents, bf16-rounded for the bf16 outputs. Returns (outputs, grads):
    [(name, port, JAX)] on real rows, the outputs' bf16 flags, and the
    JAX gradients by argument name."""
    set_kernel_mode("interpret")
    outs, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in args.values()))
    cots_j, cots_t = [], []
    for o, is_bf16, kind in zip(outs, jax_outs_bf16, out_names):
        rows = {"edge": pg.num_edges, "pt": pg.num_pts, "cam": pg.num_cams}[kind[1]]
        real = draw.arr(rows, o.shape[-1] if o.ndim == 2 else int(np.prod(o.shape[1:])))
        if is_bf16:
            real = bf16_round(real)
        pad = np.zeros((o.shape[0], real.shape[1]), np.float32)
        if kind[1] == "edge":
            pad[mask] = real
        else:
            pad[:rows] = real
        cots_j.append(jnp.asarray(pad.reshape(o.shape)))
        cots_t.append(torch.from_numpy(real).to(BF16 if is_bf16 else torch.float32))
    want = dict(zip(args, map(np.asarray, vjp(tuple(cots_j)))))
    ls = {k: v.detach().clone().requires_grad_() for k, v in leaves.items()}
    got_outs = port_fn(**ls)
    used = [(o, c) for o, c in zip(got_outs, cots_t) if o is not None]
    got = dict(zip(ls, torch.autograd.grad([o for o, _ in used], list(ls.values()),
                                           [c for _, c in used], allow_unused=True)))
    pairs = []
    for (name, kind), o, j, is_bf16 in zip(out_names, got_outs, outs, jax_outs_bf16):
        if o is None:
            continue
        j = np.asarray(j).reshape(j.shape[0], -1)
        rows = {"edge": mask, "pt": slice(0, pg.num_pts), "cam": slice(0, pg.num_cams)}[kind]
        pairs.append((name, o.detach(), j[rows], is_bf16))
    return pairs, got, want


def assert_bf16_close_but_ties(got, want, name):
    """A layer step's per-edge cotangents: its backward recomputes from e_l
    as each package stored it, and on an edge whose float32 update lies at
    a bf16 rounding tie (the packages sum in other orders) the stored rows
    differ by one ulp, and with them that edge's recomputed LayerNorm and
    source rows; the JAX kernel's backward also clamps exp(l - m) at 1
    against a window's max, which an edge's recomputed logit may pass. All
    but TIE_ROWS of the edges within assert_bf16_close's bound, and the
    whole within TIE_TOL (relative Frobenius norm)."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    bound = ulp + 1e-4 * np.abs(want) + 1e-5 * max(1.0, float(np.abs(want).max()))
    off = (np.abs(got - want) > bound).any(axis=1)
    assert off.sum() <= TIE_ROWS * len(off), (name, int(off.sum()))
    assert np.linalg.norm(got - want) <= TIE_TOL * np.linalg.norm(want), name


def check_pairs(pairs):
    for name, got, want, is_bf16 in pairs:
        if is_bf16:
            assert got.dtype == BF16, name
            assert_bf16_close(got, want, name)
        else:
            K.assert_close(got, want, name)


def test_frontend_bf16_matches_jax(kernel_graphs):
    """#3/#4 at the first layer's widths (De = 2, Dp = Dc = 4): a float32
    stream in, its e_norm stored bf16 (the JAX package's first-layer
    deferral rounds it, models/layers.py:793); its cotangent comes back
    rounded."""
    draw = K.Draw(kernel_graphs, seed=31)
    jg, pg, mask = kernel_graphs
    De, D = 2, 4
    e, e_t = draw.ln_edges(De)
    p = K.frontend_params(draw, De, D)
    f = K.jax_frontend_fn(jg, D, False)

    def jax_fn(e, *rest):
        en, op, oc = f(e, *rest)
        return en.astype(jnp.bfloat16).astype(jnp.float32), op, oc

    args = dict(e=e, **{k: p[k] for k in K.FRONT_KEYS})
    t = {k: torch.from_numpy(v) for k, v in p.items() if not k.endswith("_t")}
    leaves = dict(e=e_t, ln_scale=t["lng"], ln_bias=t["lnb"], wlp=t["wlp"].T.contiguous(),
                  blp=t["blp"], wlc=t["wlc"].T.contiguous(), blc=t["blc"], xr_p=p["xr_p_t"],
                  xr_c=p["xr_c_t"], att_p=t["att_p"].reshape(-1), att_c=t["att_c"].reshape(-1))

    def port_fn(**a):
        return fused_frontend(a["e"], a["ln_scale"], a["ln_bias"], a["wlp"], a["blp"], a["wlc"],
                              a["blc"], a["xr_p"], a["xr_c"], a["att_p"], a["att_c"], pg,
                              K.HEADS, eps=1e-5, en_dtype=BF16)

    pairs, got, want = vjp_pairs(jax_fn, args, (True, False, False),
                                 port_fn, leaves, (("e_norm", "edge"), ("out_pt", "pt"),
                                                   ("out_cam", "cam")), None, mask, pg, draw)
    check_pairs(pairs)
    np.testing.assert_allclose(got["e"].numpy(), want["e"][mask], rtol=1e-4, atol=1e-5,
                               err_msg="d e")  # a near-zero difference: see the f32 test
    for name, g, w in K.param_grad_pairs(got, want, pg, False):
        K.assert_close(g, w, name)


@pytest.mark.parametrize("raw", [False, True], ids=["layer", "final"])
def test_layer_step_bf16_matches_jax(kernel_graphs, raw):
    """#5/#6 at the interior widths with bf16 [en | skip2] and res: e_l and
    e_norm_next stored bf16, their cotangents and d en, d skip2, d res
    rounded; the backward at the stream as stored. ``final``: the final
    aggregation's raw prologue."""
    draw = K.Draw(kernel_graphs, seed=33)
    jg, pg, mask = kernel_graphs
    De = D = 32
    C = D // K.HEADS
    chunk = jg.chunk
    en, en_t = draw.edges(De)
    skip2, skip2_t = draw.edges(2)
    res, res_t = draw.edges(De)
    en, skip2, res = map(bf16_round, (en, skip2, res))
    w_e, w_uv = draw.arr(De, De, scale=0.3), draw.arr(2, De, scale=0.3)
    b, pgl = draw.arr(De, scale=0.1), draw.arr(1, De)
    ps, ps_t = draw.pt_table(De)
    pv, pv_t = draw.cam_table(De)
    p = K.frontend_params(draw, De, D)
    if raw:
        p["lng"], p["lnb"] = np.ones(De, np.float32), np.zeros(De, np.float32)
    upd = ("en", "skip2", "res", "w_e", "b", "w_uv", "ps", "pv", "pg")

    def jax_fn(*a):
        u = dict(zip(upd, a[:len(upd)]))
        fr = dict(zip(K.FRONT_KEYS, a[len(upd):]))
        pack = lambda x: pack_edges(x, chunk).astype(jnp.bfloat16)  # noqa: E731
        pending = JaxPendingUpdate(en=pack(u["en"]), skip2=pack(u["skip2"]), res=pack(u["res"]),
                                   w_e=u["w_e"], b=u["b"], w_uv=u["w_uv"], ps=u["ps"],
                                   pv=u["pv"], pg=u["pg"])
        e_l, en_next, op, oc = jax_merged_frontend(
            pending, fr["lng"], fr["lnb"], 1e-5, fr["wlp"], fr["blp"], fr["att_p"],
            fr["xr_p"].reshape(-1, K.HEADS, C), jg.pt_idx, jg.num_pts, jg.pt_segment_windows(),
            fr["wlc"], fr["blc"], fr["att_c"], fr["xr_c"].reshape(-1, K.HEADS, C), jg.cam_idx,
            jg.num_cams, edge_mask=jg.edge_mask, raw_prologue=raw)
        up = lambda x: unpack_edges(x, chunk).astype(jnp.float32)  # noqa: E731
        return (up(e_l), op, oc) if raw else (up(e_l), up(en_next), op, oc)

    args = dict(en=en, skip2=skip2, res=res, w_e=w_e, b=b, w_uv=w_uv, ps=ps, pv=pv, pg=pgl,
                **{k: p[k] for k in K.FRONT_KEYS})
    t = {k: torch.from_numpy(v) for k, v in p.items() if not k.endswith("_t")}
    real = lambda x: torch.from_numpy(x[mask]).to(BF16)  # noqa: E731
    leaves = dict(en=real(en), skip2=real(skip2), res=real(res),
                  w=torch.from_numpy(np.concatenate([w_e, w_uv]).T.copy()),
                  b=torch.from_numpy(b), ps=ps_t, pv=pv_t, pg=torch.from_numpy(pgl),
                  wlp=t["wlp"].T.contiguous(), blp=t["blp"], wlc=t["wlc"].T.contiguous(),
                  blc=t["blc"], xr_p=p["xr_p_t"], xr_c=p["xr_c_t"],
                  att_p=t["att_p"].reshape(-1), att_c=t["att_c"].reshape(-1))
    if not raw:
        leaves.update(ln_scale=t["lng"], ln_bias=t["lnb"])

    def port_fn(**a):
        e_l, en_next, op, oc = fused_layer_step(
            a["en"], a["skip2"], a["res"], a["w"], a["b"], a["ps"], a["pv"], a["pg"],
            a.get("ln_scale"), a.get("ln_bias"), a["wlp"], a["blp"], a["wlc"], a["blc"],
            a["xr_p"], a["xr_c"], a["att_p"], a["att_c"], pg, K.HEADS, eps=1e-5,
            raw_prologue=raw)
        return (e_l, op, oc) if raw else (e_l, en_next, op, oc)

    names = (("e_l", "edge"),) + (() if raw else (("e_norm_next", "edge"),)) + (
        ("out_pt", "pt"), ("out_cam", "cam"))
    flags = (True,) + (() if raw else (True,)) + (False, False)
    pairs, got, want = vjp_pairs(jax_fn, args, flags, port_fn, leaves, names, None, mask, pg,
                                 draw)
    check_pairs(pairs)
    for k in ("en", "skip2", "res"):
        assert got[k].dtype == BF16
        assert_bf16_close_but_ties(got[k], want[k][mask], f"d {k}")
    grads = [("d w_e", got["w"][:, :De].T, want["w_e"]), ("d w_uv", got["w"][:, De:].T,
                                                          want["w_uv"]),
             ("d b", got["b"], want["b"]), ("d pg", got["pg"], want["pg"]),
             ("d ps", got["ps"], want["ps"][: pg.num_pts]),
             ("d pv", got["pv"], want["pv"][: pg.num_cams])]
    for name, g, w in grads + K.param_grad_pairs(got, want, pg, raw):
        g, w = np.asarray(g), np.asarray(w)
        assert np.linalg.norm(g - w) <= TIE_TOL * max(1e-30, np.linalg.norm(w)), name


def test_projection_update_bf16_matches_jax(kernel_graphs):
    """#9/#10 with bf16 [en | skip2] and res: e stored bf16; d en, d skip2
    rounded, d res the cotangent; the tables' and weights' gradients from
    the float32 cotangent."""
    draw = K.Draw(kernel_graphs, seed=35)
    jg, pg, mask = kernel_graphs
    De, chunk = 32, jg.chunk
    en, _ = draw.edges(De)
    skip2, _ = draw.edges(2)
    res, _ = draw.edges(De)
    en, skip2, res = map(bf16_round, (en, skip2, res))
    w_e, w_uv = draw.arr(De, De, scale=0.3), draw.arr(2, De, scale=0.3)
    b, pgl = draw.arr(De, scale=0.1), draw.arr(1, De)
    ps, ps_t = draw.pt_table(De)
    pv, pv_t = draw.cam_table(De)
    window = jg.pt_segment_windows()
    keys = ("en", "skip2", "res", "w_e", "b", "w_uv", "ps", "pv", "pg")

    def jax_fn(*a):
        u = dict(zip(keys, a))
        pack = lambda x: pack_edges(x, chunk).astype(jnp.bfloat16)  # noqa: E731
        out = jax_fused_proj_update.packed_edge_update(
            pack(u["en"]), pack(u["skip2"]), pack(u["res"]), u["w_e"], u["b"], u["w_uv"],
            u["ps"], u["pv"], u["pg"], jg.pt_idx.reshape(-1, chunk),
            jg.cam_idx.reshape(-1, chunk), window.block, jg.num_pts, jg.num_cams, WINDOW,
            interpret=True, nlive=window.nlive)
        return (unpack_edges(out, chunk).astype(jnp.float32),)

    args = dict(en=en, skip2=skip2, res=res, w_e=w_e, b=b, w_uv=w_uv, ps=ps, pv=pv, pg=pgl)
    real = lambda x: torch.from_numpy(x[mask]).to(BF16)  # noqa: E731
    leaves = dict(en=real(en), skip2=real(skip2), res=real(res),
                  w=torch.from_numpy(np.concatenate([w_e, w_uv]).T.copy()),
                  b=torch.from_numpy(b), ps=ps_t, pv=pv_t, pg=torch.from_numpy(pgl))

    def port_fn(**a):
        return (projection_update(a["en"], a["skip2"], a["res"], a["w"], a["b"], a["ps"],
                                  a["pv"], a["pg"], pg),)

    pairs, got, want = vjp_pairs(jax_fn, args, (True,), port_fn, leaves, (("e", "edge"),),
                                 None, mask, pg, draw)
    check_pairs(pairs)
    for k in ("en", "skip2", "res"):
        assert got[k].dtype == BF16
        assert_bf16_close(got[k], want[k][mask], f"d {k}")
    for name, g, w in [("d w_e", got["w"][:, :De].T, want["w_e"]),
                       ("d w_uv", got["w"][:, De:].T, want["w_uv"]),
                       ("d b", got["b"], want["b"]), ("d pg", got["pg"], want["pg"]),
                       ("d ps", got["ps"], want["ps"][: pg.num_pts]),
                       ("d pv", got["pv"], want["pv"][: pg.num_cams])]:
        K.assert_close(g, w, name)


def test_stream_operands_are_validated():
    """The launchers take the streams of one call in one dtype, float32 or
    bf16, on the card: mixed dtypes, another dtype or a CPU tensor raise
    (a bf16 stream is never upcast to run the float32 kernel)."""
    from gasfm_tpu_torch.ops.kernels import build as kb
    from gasfm_tpu_torch.ops.kernels import fused_proj_update as fpu

    f32 = torch.float32
    f, b = torch.zeros(4, 2, dtype=f32), torch.zeros(4, 2, dtype=BF16)
    assert kb.stream_dtype(f, None, f) == torch.float32
    assert kb.stream_dtype(b, b) == BF16
    for bad in ((f, b), (f.half(),), (f.double(), f.double())):
        with pytest.raises(TypeError, match="float32 CUDA tensors or bfloat16 ones"):
            kb.stream_dtype(*bad)
    graph = port_scene().graph
    E, n, m = graph.num_edges, graph.num_pts, graph.num_cams
    with pytest.raises(TypeError, match="bfloat16 CUDA tensor"):
        fpu.projection_update_forward(
            torch.zeros(E, 32, dtype=BF16), torch.zeros(E, 2, dtype=BF16), None,
            torch.zeros(32, 34, dtype=f32), torch.zeros(32, dtype=f32),
            torch.zeros(n, 32, dtype=f32), torch.zeros(m, 32, dtype=f32),
            torch.zeros(1, 32, dtype=f32), graph)
    with pytest.raises(TypeError, match="float32 CUDA tensors or bfloat16 ones"):
        fpu.projection_update_forward(
            torch.zeros(E, 32, dtype=BF16), torch.zeros(E, 2, dtype=f32), None,
            torch.zeros(32, 34, dtype=f32), torch.zeros(32, dtype=f32),
            torch.zeros(n, 32, dtype=f32), torch.zeros(m, 32, dtype=f32),
            torch.zeros(1, 32, dtype=f32), graph)
