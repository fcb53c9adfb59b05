"""Spatially sharded training against naf_tpu, f32 on the CPU.

The banded K4 plain version and the banded K2 gradient (the twin on the
plain K3/K4) are held against ``jax.vjp`` of the JAX package's whole-grid
functions: a band's dq (K4) or enc gradient (K2) is the band's rows of the
whole grid's, and the bands' keys / values (dk / dv) gradients sum to the
whole grid's, at 2e-3 (ROADMAP's parity bar for gradients). The forward rows
at 2e-4.

The train step runs on two gloo ranks (data 1, space 2; one spawn through
``naf_torch.dryrun.each``) at the JAX dry run's training shapes
(``__graft_entry__._dryrun_impl``: output (96, 48), image (1, 192, 96, 3),
features (1, 24, 12, 32), target (1, 96, 48, 32), AdamW 2e-4) at small
widths, from JAX-initialised weights, and is held to ``jax.value_and_grad``
of the dry run's loss with ``optax.adamw``: loss rtol 1e-5, each gradient
tensor rel 1e-4 in the 2-norm, parameters after two steps at the JAX
package's data-parallel bar (atol 5e-4, rtol 1e-3), as
``tests/test_torch_parallel.py`` bars its step, and the update the two steps
applied (parameters after minus before, over all of them) at rel 1e-3 in the
2-norm: AdamW moves each parameter by ~lr a step whatever its gradient, so
at lr 2e-4 the parameters' bar alone would pass a step that applied none.
Against the port's one-process step (``model(image, lr_feats, out_hw)`` on
the whole batch) the loss is held at rtol 1e-6, the gradients at rel 1e-4,
the parameters at atol 1e-5 and the update as for JAX: the one-process step
on CPU tensors runs the modules' own GroupNorm, not K1's fused statistics,
and its gradients lie ~1e-5 (rel) off JAX's as the step's do. Every rank
ends with the same parameters.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from naf_torch.convert import state_dict_from_jax_params
from naf_torch.dryrun import _model, each, spatial_train_case
from naf_torch.kernels.na2d_fused import cross_scale_na2d_fused
from naf_torch.kernels.na2d_fused_q import naf_upsample_attention
from naf_torch.parallel import naf_spatial_train_step, run_ranks
from naf_tpu.kernels.na2d_fused_q import _fused_q_twin as j_fused_q_twin
from naf_tpu.models.naf import NAF as JNAF
from naf_tpu.ops.na2d import cross_scale_na2d as j_cross_scale_na2d

torch.set_num_threads(1)
GRAD_TOL = dict(atol=2e-3, rtol=2e-3)
FWD_TOL = dict(atol=2e-4, rtol=2e-4)

# K4: a 40-row query grid over 10 LR rows (ratio 4), k 5; bands of LR cell rows
# [0, 4), [4, 8) and the ragged [8, 10)
K4_BANDS = {"first": (0, 4), "second": (4, 4), "ragged_third": (8, 2)}


@pytest.fixture(scope="module")
def k4_whole():
    rng = np.random.RandomState(3)
    q = rng.randn(1, 40, 24, 2, 16).astype(np.float32)
    k = rng.randn(1, 10, 6, 2, 16).astype(np.float32)
    v = rng.randn(1, 10, 6, 2, 24).astype(np.float32)
    g = rng.randn(1, 40, 24, 2, 24).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: j_cross_scale_na2d(a, b, c, 5),
                       *map(jnp.asarray, (q, k, v)))
    return (q, k, v, g), np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _k4_band(inputs, c0, cells):
    q, k, v, g = (torch.from_numpy(a) for a in inputs)
    rows = slice(c0 * 4, (c0 + cells) * 4)
    ins = [q[:, rows].clone().requires_grad_(), k.clone().requires_grad_(),
           v.clone().requires_grad_()]
    out = cross_scale_na2d_fused(*ins, 5, row_cell0=c0, full_hq=40)
    out.backward(g[:, rows])
    return rows, out.detach(), [t.grad for t in ins]


@pytest.mark.parametrize("band", list(K4_BANDS))
def test_banded_k4_plain_version_gives_the_rows_of_the_whole_grid_dq(k4_whole, band):
    inputs, out, (dq, _, _) = k4_whole
    rows, got, (got_dq, _, _) = _k4_band(inputs, *K4_BANDS[band])
    np.testing.assert_allclose(got.numpy(), out[:, rows], **FWD_TOL)
    np.testing.assert_allclose(got_dq.numpy(), dq[:, rows], **GRAD_TOL)


def test_banded_k4_plain_version_dk_dv_sum_over_the_bands(k4_whole):
    inputs, _, (_, dk, dv) = k4_whole
    sums = [0, 0]
    for c0, cells in K4_BANDS.values():
        _, _, (_, gk, gv) = _k4_band(inputs, c0, cells)
        sums = [sums[0] + gk, sums[1] + gv]
    # a band's dk is zero on the LR rows no window of it reaches
    _, _, (_, gk, _) = _k4_band(inputs, 0, 4)
    assert float(gk[:, 7:].abs().max()) == 0.0
    np.testing.assert_allclose(sums[0].numpy(), dk, **GRAD_TOL)
    np.testing.assert_allclose(sums[1].numpy(), dv, **GRAD_TOL)


# K2: enc 16^2 pooled up to 32^2 queries over 8^2 LR cells (ratio 4), C 32 in
# 2 heads (d 16, RoPE heads of 16), Cv 48, k 5; two bands of 4 cell rows, each
# with the 8 encoder rows it pools from (enc_banded)
K2_BANDS = (0, 4)


@pytest.fixture(scope="module")
def k2_whole():
    rng = np.random.RandomState(4)
    enc = rng.randn(1, 16, 16, 32).astype(np.float32)
    keys = rng.randn(1, 8, 8, 32).astype(np.float32)
    values = rng.randn(1, 8, 8, 48).astype(np.float32)
    rows_tab = rng.randn(32, 64).astype(np.float32)
    cols_tab = rng.randn(32, 64).astype(np.float32)
    g = rng.randn(1, 32, 32, 48).astype(np.float32)
    out, vjp = jax.vjp(lambda e, k, v: j_fused_q_twin(e, k, v, jnp.asarray(rows_tab),
                                                      jnp.asarray(cols_tab), 16, 2, 5, 0.25),
                       *map(jnp.asarray, (enc, keys, values)))
    return ((enc, keys, values, rows_tab, cols_tab, g), np.asarray(out),
            [np.asarray(t) for t in vjp(jnp.asarray(g))])


def _k2_band(inputs, c0):
    enc, keys, values, rows_tab, cols_tab, g = (torch.from_numpy(a) for a in inputs)
    ins = [enc[:, c0 * 2 : c0 * 2 + 8].clone().requires_grad_(), keys.clone().requires_grad_(),
           values.clone().requires_grad_()]
    out = naf_upsample_attention(*ins, rows_tab, cols_tab, 16, num_heads=2, kernel_size=5,
                                 row_cell0=c0, band_cells=4, enc_banded=True)
    rows = slice(c0 * 4, c0 * 4 + 16)
    out.backward(g[:, rows])
    return rows, out.detach(), [t.grad for t in ins]


@pytest.mark.parametrize("c0", K2_BANDS)
def test_banded_k2_gradient_gives_the_rows_of_the_whole_grid_enc_gradient(k2_whole, c0):
    inputs, out, (d_enc, _, _) = k2_whole
    rows, got, (got_enc, _, _) = _k2_band(inputs, c0)
    np.testing.assert_allclose(got.numpy(), out[:, rows], **FWD_TOL)
    np.testing.assert_allclose(got_enc.numpy(), d_enc[:, c0 * 2 : c0 * 2 + 8], **GRAD_TOL)


def test_banded_k2_keys_and_values_gradients_sum_over_the_bands(k2_whole):
    inputs, _, (_, d_keys, d_values) = k2_whole
    grads = [_k2_band(inputs, c0)[2] for c0 in K2_BANDS]
    np.testing.assert_allclose(sum(g[1] for g in grads).numpy(), d_keys, **GRAD_TOL)
    np.testing.assert_allclose(sum(g[2] for g in grads).numpy(), d_values, **GRAD_TOL)


def test_k2_out_acc_raises_under_autograd(k2_whole):
    enc, keys, values, rows_tab, cols_tab, _ = (torch.from_numpy(a) for a in k2_whole[0])
    with pytest.raises(NotImplementedError, match="inference-only"):
        naf_upsample_attention(enc.requires_grad_(), keys, values, rows_tab, cols_tab, 16,
                               num_heads=2, kernel_size=5, row_cell0=4, band_cells=4,
                               out_acc=torch.zeros(1, 32, 32, 48))
    with torch.no_grad():  # and runs without one
        out = naf_upsample_attention(enc, keys, values, rows_tab, cols_tab, 16, num_heads=2,
                                     kernel_size=5, row_cell0=4, band_cells=4,
                                     out_acc=torch.zeros(1, 32, 32, 48))
    assert bool((out[:, :16] == 0).all()) and bool((out[:, 16:] != 0).any())


# the step: SMALL_NAF of tests/test_torch_parallel.py on the fused path
NAF = dict(dim=32, heads_attn=2, heads_rope=2, kernel_size=5, img_layers=1)
SPACE = 2
OUT_HW = (48 * SPACE, 48)


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    """Two gloo ranks (data 1, space 2) take two spatial steps from
    JAX-initialised weights, rank 0 also the one-process steps; JAX takes the
    dry run's jitted ``value_and_grad`` step with ``optax.adamw(2e-4)``."""
    rng = np.random.RandomState(0)
    image = rng.randn(1, 96 * SPACE, 96, 3).astype(np.float32)
    feats = rng.randn(1, 12 * SPACE, 12, 32).astype(np.float32)
    target = rng.randn(1, *OUT_HW, 32).astype(np.float32)
    jm = JNAF(**NAF)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(image), jnp.asarray(feats),
                     OUT_HW)["params"]
    state = state_dict_from_jax_params(params, img_layers=1, heads_rope=2)
    res = run_ranks(each, 2, args=([(spatial_train_case, dict(
        naf=NAF, state=state, image=image, feats=feats, target=target, out_hw=OUT_HW, data=1,
        space=SPACE, use_bf16=False, steps=2, one_process=True))],), device="cpu", timeout=180,
        workdir=str(tmp_path_factory.mktemp("spatial")))

    tx = optax.adamw(2e-4)

    def loss_fn(p):
        pred = jm.apply({"params": p}, jnp.asarray(image), jnp.asarray(feats), OUT_HW)
        return jnp.mean((pred - jnp.asarray(target)) ** 2)

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    p, opt_state, losses, grads = params, tx.init(params), [], None
    for _ in range(2):
        loss, g = value_and_grad(p)
        grads = g if grads is None else grads
        updates, opt_state = tx.update(g, opt_state, p)
        p = optax.apply_updates(p, updates)
        losses.append(float(loss))
    convert = lambda t: state_dict_from_jax_params(t, img_layers=1, heads_rope=2)  # noqa: E731
    jax_ref = {"losses": losses, "grads": convert(grads), "params": convert(p)}
    return [r[0] for r in res], jax_ref, state


LOSS_RTOL = {"jax": 1e-5, "one_process": 1e-6}
PARAM_BAR = {"jax": (5e-4, 1e-3), "one_process": (1e-5, 0.0)}
# the steps' update (parameters after minus before) over all parameters, rel in
# the 2-norm: 2.6e-5 to JAX's, 2.8e-5 to the one-process step's; none is off by 1
UPDATE_REL = {"jax": 1e-3, "one_process": 1e-3}


@pytest.mark.parametrize("reference", ["jax", "one_process"])
def test_spatial_step_matches_the_whole_batch_step(step_run, reference):
    res, jax_ref, start = step_run
    ref = jax_ref if reference == "jax" else res[0]["single"]
    atol, rtol = PARAM_BAR[reference]
    for r in res:  # every rank returns the global loss and the reduced gradients
        got = r["spatial"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL[reference])
        assert set(got["grads"]) <= set(ref["grads"])
        for name, g in got["grads"].items():
            want = ref["grads"][name].float()
            rel = float((g - want).norm() / want.norm().clamp_min(1e-30))
            assert rel <= 1e-4, (name, rel)
        for name, want in ref["params"].items():
            if name in got["params"]:
                np.testing.assert_allclose(got["params"][name].numpy(), want.float().numpy(),
                                           atol=atol, rtol=rtol, err_msg=name)
        # the update itself: AdamW moves every parameter by ~lr a step whatever
        # its gradient, so the bars above would pass a step that applied none
        got_d, want_d = (torch.cat([(p[k].float() - start[k].float()).flatten()
                                    for k in got["grads"]]) for p in (got["params"],
                                                                       ref["params"]))
        rel = float((got_d - want_d).norm() / want_d.norm())
        assert rel <= UPDATE_REL[reference], rel


def test_spatial_step_leaves_every_rank_with_the_same_parameters(step_run):
    res, _, _ = step_run
    first, second = (r["spatial"] for r in res)
    assert first["losses"] == second["losses"]
    assert all(torch.equal(first["params"][k], second["params"][k]) for k in first["params"])
    # CPU tensors take the plain versions: no kernel launched
    assert all(n == 0 for step in first["launches"] for n in step.values())


def _fake_mesh(data, space):
    """The mesh attributes the step reads before any collective."""
    return types.SimpleNamespace(mesh_dim_names=("data", "space"),
                                 size=lambda i: (data, space)[i], get_local_rank=lambda n: 0)


@pytest.mark.parametrize("batch,side,hk,out,match", [
    (1, 64, 15, 60, "space=2 must divide the LR rows"),
    (3, 64, 16, 64, "data=2 .* the batch"),
    (2, 64, 16, 60, "whole cell rows"),
    (2, 33, 16, 64, "no whole encoder rows"),
])
def test_spatial_step_raises_where_the_band_rules_refuse(batch, side, hk, out, match):
    model = _model({"naf": NAF, "seed": 0}, torch.device("cpu"), torch.float32)
    step = naf_spatial_train_step(_fake_mesh(2, 2), model,
                                  torch.optim.AdamW(model.parameters(), lr=2e-4), False)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=match):
        step(torch.zeros(batch, side, side, 3), torch.zeros(batch, hk, hk, 16),
             torch.zeros(batch // 2 or 1, out // 2, out, 16), (out, out))
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_spatial_step_raises_on_the_xla_path():
    model = _model({"naf": dict(NAF, na_impl="xla"), "seed": 0}, torch.device("cpu"),
                   torch.float32)
    with pytest.raises(ValueError, match="fused path"):
        naf_spatial_train_step(_fake_mesh(1, 2), model,
                               torch.optim.AdamW(model.parameters(), lr=2e-4), False)


@pytest.mark.parametrize("k", [1, 3])
def test_band_twin_keeps_the_whole_stack_twin_s_bf16_gradients(k):
    """A band's encoder backward (the twin of ``encoder_fused._chain`` over
    a band, the whole grid here) gives in bf16 the gradients of the whole stack's twin
    (``encoder_fused._stacks_ref``, what the one-process step
    differentiates): the gradient reaching each conv's output is summed and
    kept in f32. Rounded to bf16 there, the earlier layers' gradients were
    off by 5-10% against 1% for the twin (f32 as the reference)."""
    from naf_torch.kernels import encoder_fused as ef
    from naf_torch.nn.conv import Encoder

    torch.manual_seed(0)
    enc = Encoder(32, kernel_size=k, ks_res=k, num_layers=2)
    spec = ef._stack_spec(enc)
    x, g = torch.randn(1, 48, 40, 3), torch.randn(1, 48, 40, 32)

    def grads(fn):
        params = [p.detach().bfloat16().requires_grad_() for p in ef._stack_params(enc)]
        fn(x.bfloat16(), params).float().mul(g).sum().backward()
        return [p.grad.float() for p in params]

    want = grads(lambda xx, ps: ef._stacks_ref(xx, ps, (spec,)))
    got = grads(lambda xx, ps: ef._chain(xx, ps, spec, (0, 48),
                                         stats=ef._band_stats(lambda t: t), twin=True))  # a group of one rank
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-3)
