"""naf_torch.ops against naf_tpu.ops (and torch's own resize/pool), f32 on CPU.

Inputs come from numpy with a fixed seed and go through both packages;
atol = rtol = 2e-4 unless stated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from naf_torch.ops.na2d import cross_scale_na2d, na2d
from naf_torch.ops.pool import adaptive_avg_pool2d
from naf_torch.ops.resize import resize_bicubic, resize_bilinear, resize_nearest_exact
from naf_torch.ops import window as t_window
from naf_tpu.ops.na2d import cross_scale_na2d as j_cross_scale_na2d
from naf_tpu.ops.na2d import na2d as j_na2d
from naf_tpu.ops import pool as j_pool
from naf_tpu.ops import resize as j_resize
from naf_tpu.ops import window as j_window

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("src,dst", [
    ((13, 17), (5, 7)),     # ragged pool-down
    ((16, 12), (4, 3)),     # integer pool-down
    ((7, 5), (16, 12)),     # ragged pool-up
    ((9, 9), (9, 9)),       # identity
])
def test_adaptive_avg_pool2d_matches_jax_and_torch(src, dst):
    x = _rand(0, 2, *src, 8)
    got = adaptive_avg_pool2d(torch.from_numpy(x), dst).numpy()
    want = np.asarray(j_pool.adaptive_avg_pool2d(jnp.asarray(x), dst))
    np.testing.assert_allclose(got, want, **TOL)
    ref = F.adaptive_avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
    np.testing.assert_allclose(got, ref.permute(0, 2, 3, 1).numpy(), **TOL)


@pytest.mark.parametrize("hr,lr,k", [
    (64, 16, 9), (448, 28, 9), (2048, 28, 9), (100, 28, 9), (16, 8, 9), (30, 7, 5),
    (64, 32, 9),
])
def test_window_tables_equal(hr, lr, k):
    np.testing.assert_array_equal(
        t_window.cross_scale_lr_indices(hr, lr, k), j_window.cross_scale_lr_indices(hr, lr, k))
    np.testing.assert_array_equal(
        t_window.nearest_exact_src_index(lr, hr), j_window.nearest_exact_src_index(lr, hr))
    d = max(hr // lr, 1)
    if hr >= k * d:
        np.testing.assert_array_equal(
            t_window.na_gather_indices(hr, k, d), j_window.na_gather_indices(hr, k, d))


def test_window_start_rejects_what_natten_rejects():
    with pytest.raises(ValueError):
        t_window.na_window_start(np.arange(8), 8, 4, 1)
    with pytest.raises(ValueError):
        t_window.na_window_start(np.arange(8), 8, 5, 2)


@pytest.mark.parametrize("src,dst", [((20, 30), (7, 11)), ((7, 5), (16, 23)), ((8, 8), (8, 8))])
def test_resize_bilinear_matches_jax_and_torch(src, dst):
    x = _rand(1, 1, *src, 3)
    got = resize_bilinear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, np.asarray(j_resize.resize_bilinear(jnp.asarray(x), dst)),
                               **TOL)
    ref = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=dst, mode="bilinear",
                        align_corners=False)
    np.testing.assert_allclose(got, ref.permute(0, 2, 3, 1).numpy(), **TOL)


@pytest.mark.parametrize("src,dst", [
    ((9, 11), (27, 33)),    # integer upsample
    ((28, 28), (56, 56)),   # FeatUp's first stage
    ((9, 11), (18, 23)),    # ragged upsample
    ((20, 30), (7, 11)),    # downsample
    ((6, 6), (6, 6)),       # identity
])
def test_resize_nearest_exact_and_bicubic_match_jax(src, dst):
    x = _rand(11, 2, *src, 5)
    got_n = resize_nearest_exact(torch.from_numpy(x), dst).numpy()
    np.testing.assert_array_equal(
        got_n, np.asarray(j_resize.resize_nearest_exact(jnp.asarray(x), dst)))
    got_c = resize_bicubic(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got_c, np.asarray(j_resize.resize_bicubic(jnp.asarray(x), dst)),
                               atol=1e-5, rtol=1e-5)


def test_resize_keeps_leading_axes_and_int_dtypes():
    x = _rand(12, 2, 3, 7, 9, 4)
    got = resize_bicubic(torch.from_numpy(x), (14, 5))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_resize.resize_bicubic(jnp.asarray(x), (14, 5))),
        atol=1e-5, rtol=1e-5)
    xi = (np.abs(x) * 50).astype(np.int32)
    gi = resize_bicubic(torch.from_numpy(xi), (14, 5))
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(
        gi.numpy(), np.asarray(j_resize.resize_bicubic(jnp.asarray(xi), (14, 5))))


@pytest.mark.parametrize("hq,wq,hk,wk,k", [
    (32, 32, 8, 8, 5),      # integer ratio
    (30, 22, 7, 5, 3),      # ragged ratio
    (16, 16, 8, 8, 9),      # dilation clamp
])
def test_cross_scale_na2d_matches_jax(hq, wq, hk, wk, k):
    n, d, dv = 2, 8, 6
    q, kk, v = _rand(2, 1, hq, wq, n, d), _rand(3, 1, hk, wk, n, d), _rand(4, 1, hk, wk, n, dv)
    got, w = cross_scale_na2d(torch.from_numpy(q), torch.from_numpy(kk), torch.from_numpy(v),
                              k, return_weights=True)
    want, ww = j_cross_scale_na2d(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(v), k,
                                       return_weights=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(ww), **TOL)


def test_cross_scale_na2d_row_blocks_change_nothing():
    q, kk, v = _rand(5, 1, 24, 20, 2, 8), _rand(6, 1, 6, 5, 2, 8), _rand(7, 1, 6, 5, 2, 4)
    args = (torch.from_numpy(q), torch.from_numpy(kk), torch.from_numpy(v), 3)
    full, wf = cross_scale_na2d(*args, return_weights=True, row_block=0)
    blk, wb = cross_scale_na2d(*args, return_weights=True, row_block=5)
    torch.testing.assert_close(blk, full)
    torch.testing.assert_close(wb, wf)


def test_na2d_dense_matches_jax():
    q, kk, v = _rand(8, 1, 12, 14, 2, 8), _rand(9, 1, 12, 14, 2, 8), _rand(10, 1, 12, 14, 2, 8)
    got = na2d(torch.from_numpy(q), torch.from_numpy(kk), torch.from_numpy(v), 3, dilation=2)
    want = j_na2d(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(v), 3, dilation=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
