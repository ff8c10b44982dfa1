"""The port's host ops against the JAX package, on the CPU.

ducosy_tpu_torch.ops.{hu, filters, resize}, models.layers and
infer.postprocess each take the same numpy inputs (made from a seed) as
their ducosy_tpu counterpart. Tolerance: fp32 rtol/atol 1e-5 (the two
sides differ only in summation order); int16 outputs may differ by one
stored unit where a float lands on the truncation boundary.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ducosy_tpu.infer import postprocess as jpost
from ducosy_tpu.models import layers as jlayers
from ducosy_tpu.ops import filters as jfilters
from ducosy_tpu.ops import hu as jhu
from ducosy_tpu.ops import resize as jresize
from ducosy_tpu_torch.infer import postprocess as tpost
from ducosy_tpu_torch.models import layers as tlayers
from ducosy_tpu_torch.ops import filters as tfilters
from ducosy_tpu_torch.ops import hu as thu
from ducosy_tpu_torch.ops import resize as tresize

RTOL = ATOL = 1e-5


class _Range:
    def __init__(self, hu_min, hu_max):
        self.hu_min, self.hu_max = hu_min, hu_max


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


HU_CASES = {
    "stored_to_hu": lambda m, x: m.stored_to_hu(x, 1.5, -1024.0),
    "normalize_window": lambda m, x: m.normalize_window(x, -150.0, 250.0),
    "soft_squeeze": lambda m, x: m.soft_squeeze(x, -150.0, 250.0),
    "denormalize_to_hu": lambda m, x: m.denormalize_to_hu(
        x / 3000.0, -1000.0, -150.0),
    "hu_to_stored": lambda m, x: m.hu_to_stored(x, 1.5, -1024.0),
    "hu_transform": lambda m, x: m.hu_transform(x, 1.5, -1024.0, -150.0,
                                                250.0),
    "hu_transform_linear": lambda m, x: m.hu_transform(
        x, 1.5, -1024.0, -1000.0, -150.0, use_soft_squeezing=False),
    "preprocess_dual": lambda m, x: m.preprocess_dual(
        x, 1.5, -1024.0, _Range(-150.0, 250.0), _Range(-1000.0, -150.0))[1],
}


@pytest.mark.parametrize("name", sorted(HU_CASES))
def test_hu_matches_jax(name):
    x = np.random.default_rng(1).uniform(-1500, 3000, (3, 17, 19)) \
        .astype(np.float32)
    fn = HU_CASES[name]
    _close(fn(thu, torch.from_numpy(x)), fn(jhu, jnp.asarray(x)))


@pytest.mark.parametrize("axis,sigma", [(0, 0.8), (1, 1.2), (2, 3.0),
                                        (0, 2.5)])
def test_gaussian_filter_1d_matches_jax(axis, sigma):
    # sigma 2.5 on a 5-slice axis: the kernel radius (10) exceeds the axis,
    # so the scipy reflect boundary is applied iteratively
    vol = np.random.default_rng(2).uniform(0, 2000, (5, 12, 14)) \
        .astype(np.float32)
    got = tfilters.gaussian_filter_1d(torch.from_numpy(vol), sigma, axis=axis)
    ref = jfilters.gaussian_filter_1d(jnp.asarray(vol), sigma, axis=axis)
    _close(got, ref, atol=1e-3)   # values up to 2000: rtol 1e-5 -> 2e-2


def test_gaussian_filter_3d_matches_jax():
    vol = np.random.default_rng(3).normal(0, 1, (6, 16, 18)).astype(np.float32)
    sig = (0.7, 0.05, 1.2)
    _close(tfilters.gaussian_filter_3d(torch.from_numpy(vol), sig),
           jfilters.gaussian_filter_3d(jnp.asarray(vol), sig))


@pytest.mark.parametrize("src,dst", [((48, 48), (32, 32)),
                                     ((32, 32), (48, 48)),
                                     ((30, 40), (64, 17))])
def test_resize_matches_jax(src, dst):
    """jax.image.resize linear+antialias, including a 48 -> 32 down-scale
    (where the triangle kernel widens) and a mixed up/down resize."""
    x = np.random.default_rng(4).normal(0, 1, (2, 3) + src).astype(np.float32)
    _close(tresize.resize_hw(torch.from_numpy(x), *dst),
           jresize.resize_hw(jnp.asarray(x), *dst))


@pytest.mark.parametrize("antialias", [True, False])
def test_resize_nhwc_matches_jax(antialias):
    """NHWC (and HWC) on H, W; antialias off narrows the down-scale's
    kernel to jax's unscaled triangle."""
    x = np.random.default_rng(5).normal(0, 1, (2, 40, 30, 3)).astype(
        np.float32)
    _close(tresize.resize_nhwc(torch.from_numpy(x), 24, 45,
                               antialias=antialias),
           jresize.resize_nhwc(jnp.asarray(x), 24, 45, antialias=antialias))
    _close(tresize.resize_nhwc(torch.from_numpy(x[0]), 24, 45),
           jresize.resize_nhwc(jnp.asarray(x[0]), 24, 45))


@pytest.mark.parametrize("sigma", [0.0, 1.5, 6.0])
def test_gaussian_blur_hw_matches_jax(sigma):
    """scipy reflect boundary on H and W of NHWC; sigma 6 on a 12-pixel
    axis reflects more than once."""
    x = np.random.default_rng(6).normal(0, 1, (2, 12, 20, 3)).astype(
        np.float32)
    _close(tfilters.gaussian_blur_hw(torch.from_numpy(x), sigma),
           jfilters.gaussian_blur_hw(jnp.asarray(x), sigma))


def test_resize_same_size_is_identity():
    x = torch.randn(2, 16, 16)
    assert torch.equal(tresize.resize_hw(x, 16, 16), x)


def test_instance_norm_matches_jax():
    x = np.random.default_rng(5).normal(3, 2, (2, 9, 11, 16)).astype(np.float32)
    _close(tlayers.instance_norm(torch.from_numpy(x)),
           jlayers.instance_norm(jnp.asarray(x)))


def test_reflect_pad_and_upsample_match_jax():
    x = np.random.default_rng(6).normal(0, 1, (2, 7, 9, 4)).astype(np.float32)
    t = torch.from_numpy(x)
    for p in (1, 3):
        np.testing.assert_array_equal(tlayers.reflect_pad(t, p).numpy(),
                                      np.asarray(jlayers.reflect_pad(x, p)))
    np.testing.assert_array_equal(tlayers.upsample_nearest_2x(t).numpy(),
                                  np.asarray(jlayers.upsample_nearest_2x(x)))


def test_unsharp_mask_matches_jax():
    rng = np.random.default_rng(7)
    orig = rng.uniform(0, 2000, (4, 20, 20)).astype(np.float32)
    smooth = orig + rng.normal(0, 5, orig.shape).astype(np.float32)
    got = tpost.unsharp_mask(torch.from_numpy(smooth), torch.from_numpy(orig),
                             amount=1.7, radius=1.2)
    ref = jpost.unsharp_mask(jnp.asarray(smooth), jnp.asarray(orig),
                             amount=1.7, radius=1.2)
    _close(got, ref, atol=1e-2)   # values up to 2000


def test_postprocess_gaussian3d_matches_jax():
    """The serving path's postprocess: gaussian3d + unsharp, stored values
    >= 750 restored from the original, int16 (truncation)."""
    rng = np.random.default_rng(8)
    vol = rng.uniform(0, 1600, (6, 24, 24)).astype(np.float32)
    kw = dict(sigma_z=0.7, sigma_xy=0.05, sharpen_amount=1.7,
              sharpen_radius=1.2)
    got = tpost.postprocess_ct_volume(torch.from_numpy(vol), "gaussian3d",
                                      **kw).numpy()
    ref = np.asarray(jpost._postprocess_impl(
        jnp.asarray(vol), method="gaussian3d", enhance_sharpness=True,
        hu_threshold=tpost.RESTORE_THRESHOLD, sigma=1.0, base_sigma=1.5,
        max_sigma=3.0,
        kernel_size=3, process_variance=1e-5, measurement_variance=1e-2,
        **kw))
    assert got.dtype == np.int16 and got.shape == vol.shape
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1 and np.mean(d == 0) >= 0.999
    keep = vol >= 750
    np.testing.assert_array_equal(got[keep], vol[keep].astype(np.int16))
