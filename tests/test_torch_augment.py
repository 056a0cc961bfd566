"""The port's training augmentation (sat_tpu_torch.data.transforms) on the
CPU: its resample against sat_tpu's separable_resample_mxu at float32 on
the same coordinates, the crop's bounds, the flip rule, the noise and the
identity when augmentation is off."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.ops.image_ops import separable_resample_mxu
from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.data import transforms as TT
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

S = 64


def images(b=6, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8))


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("oh,ow", [(S, S), (40, 52)])
def test_resample_matches_jax(oh, ow):
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(3, S, S, 3)).astype(np.float32)
    # inside, on the border, and outside the image (clamped)
    py = rng.uniform(-3, S + 2, size=(3, oh)).astype(np.float32)
    px = rng.uniform(-3, S + 2, size=(3, ow)).astype(np.float32)
    py[0, :4], px[0, :4] = (0.0, S - 1.0, 7.0, 7.5), (0.0, S - 1.0, 3.0, 3.25)
    ref = separable_resample_mxu(jnp.asarray(x), jnp.asarray(py), jnp.asarray(px),
                                 compute_dtype=jnp.float32)
    got = TT.separable_resample(torch.from_numpy(x), torch.from_numpy(py),
                                torch.from_numpy(px))
    assert got.shape == (3, oh, ow, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    # integer coordinates sample pixels exactly
    np.testing.assert_allclose(got[0, 2, 2].numpy(), x[0, 7, 3], rtol=1e-6)


@pytest.mark.parametrize("lo", [0.08, 0.9])
def test_crop_bounds(lo):
    theta = TT._rrc_theta(gen(2), 4000, lo, torch.device("cpu")).numpy()
    cw, tx, ch, ty = theta[:, 0, 0], theta[:, 0, 2], theta[:, 1, 1], theta[:, 1, 2]
    assert (cw > 0).all() and (cw <= 1).all() and (ch > 0).all() and (ch <= 1).all()
    # the crop stays inside the image
    assert (np.abs(tx) <= 1 - cw + 1e-6).all() and (np.abs(ty) <= 1 - ch + 1e-6).all()
    inside = (cw < 1) & (ch < 1)           # not clamped: the drawn area and aspect
    area, ratio = cw * ch, cw / ch
    assert (area[inside] >= lo - 1e-5).all() and (area <= 1 + 1e-6).all()
    assert (ratio[inside] >= 3 / 4 - 1e-5).all() and (ratio[inside] <= 4 / 3 + 1e-5).all()
    np.testing.assert_array_equal(theta[:, 2], np.tile([0, 0, 1], (4000, 1)))
    np.testing.assert_array_equal(theta[:, 0, 1], 0)
    np.testing.assert_array_equal(theta[:, 1, 0], 0)
    assert abs(np.median(np.log(ratio[inside]))) < 0.02


def cfg_(**kw):
    base = dict(input_size=S, aug_scale=1.0, aug_hflip=0.0, aug_noise_std=0.0)
    base.update(kw)
    return SATConfig(**base)


def test_identity_when_off():
    x = images()
    got = TT.build_train_augment(cfg_())(gen(), x)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, x.float() / 255.0, rtol=0, atol=0)
    torch.testing.assert_close(TT.val_preprocess(x), x.float() / 255.0)


@pytest.mark.parametrize("p,flips", [(0.0, False), (1.0, False), (0.5, True)])
def test_flip_rule(p, flips):
    """Flip only where 0 < aug_hflip < 1, as the reference adds its
    RandomHorizontalFlip; each image is itself or its mirror."""
    x = images(b=32)
    got = TT.build_train_augment(cfg_(aug_hflip=p))(gen(3), x)
    base = x.float() / 255.0
    same = (got == base).flatten(1).all(1)
    mirrored = (got == base.flip(2)).flatten(1).all(1)
    assert (same | mirrored).all()
    assert bool(mirrored.any() & ~same.all()) == flips
    if flips:
        assert 8 <= int(mirrored.sum()) <= 24


def test_flip_with_crop_mirrors_columns():
    """With the crop on, the flip reverses the sampled columns: the same
    draws with the flip forced give the column-mirror of the unflipped."""
    x = images(b=16)
    a = TT.build_train_augment(cfg_(aug_scale=0.5))(gen(4), x)
    b = TT.build_train_augment(cfg_(aug_scale=0.5, aug_hflip=0.5))(gen(4), x)
    same = torch.isclose(a, b, atol=1e-6).flatten(1).all(1)
    mirrored = torch.isclose(a.flip(2), b, atol=1e-6).flatten(1).all(1)
    assert (same | mirrored).all() and mirrored.any() and same.any()
    assert not torch.allclose(a, x.float() / 255.0)    # the crop resampled


@pytest.mark.parametrize("std", [0.01, 0.2])
def test_noise_std(std):
    x = images(b=8)
    got = TT.build_train_augment(cfg_(aug_noise_std=std))(gen(5), x)
    noise = (got - x.float() / 255.0).numpy()
    assert abs(noise.std() / std - 1) < 0.01
    assert abs(noise.mean()) < 0.01 * std * 10


def test_crop_output_range_and_scale():
    x = images(b=8)
    got = TT.build_train_augment(cfg_(aug_scale=0.9, aug_noise_std=0.0))(gen(6), x)
    assert got.shape == (8, S, S, 3) and got.dtype == torch.float32
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


@pytest.mark.parametrize("kw", [dict(aug_color_jitter=0.4),
                                dict(aug_optical_strength=0.5)])
def test_unported_augments_raise(kw):
    with pytest.raises(NotImplementedError):
        TT.build_train_augment(cfg_(**kw))
