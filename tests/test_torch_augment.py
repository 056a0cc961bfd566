"""The port's training augmentation (sat_tpu_torch.data.transforms,
sat_tpu_torch.ops.image_ops) on the CPU: the separable resample against
sat_tpu's separable_resample_mxu at float32 on the same coordinates, the
crop's bounds, the flip rule, the noise and the identity when augmentation
is off; the colour ops, the grid sample and the warps' homographies against
sat_tpu.ops.image_ops and sat_tpu.data.transforms, and the whole augment
against JAX's with the port's draws (``_draws``) replaced by the ones
``jax.random`` makes from JAX's split keys (``jax_draws``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.config import SATConfig as JaxConfig
from sat_tpu.data import transforms as JT
from sat_tpu.models.decoder import fast_key
from sat_tpu.ops import image_ops as JO
from sat_tpu.ops.image_ops import separable_resample_mxu
from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.data import transforms as TT
from sat_tpu_torch.ops import image_ops as TO
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
    d = TT._draws(gen(2), 4000, (S, S), cfg_(aug_scale=lo), torch.device("cpu"))
    theta = TT._rrc_theta(d["area"], d["log_ratio"], d["crop_x"], d["crop_y"]).numpy()
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




# ---------------------------------------------------------------------------
# colour jitter and the optical warps against JAX
# ---------------------------------------------------------------------------

def jax_draws(key, b, cfg):
    """The numbers JAX's augment draws from ``key`` for b images, by the
    names of the port's ``_draws``: the same jax.random calls on the same
    split keys as sat_tpu.data.transforms.build_train_augment."""
    (r_rrc, r_flip, r_cb, r_cc, r_cs, r_ch, r_opt, r_choice,
     r_noise) = jax.random.split(key, 9)
    on, d, u = TT._settings(cfg), {}, jax.random.uniform
    if on["crop"]:
        ra, rr, rx, ry = jax.random.split(r_rrc, 4)
        d["area"] = u(ra, (b,), minval=cfg.aug_scale, maxval=1.0)
        d["log_ratio"] = u(rr, (b,), minval=jnp.log(3 / 4), maxval=jnp.log(4 / 3))
        d["crop_x"] = u(rx, (b,), minval=-1.0, maxval=1.0)
        d["crop_y"] = u(ry, (b,), minval=-1.0, maxval=1.0)
    if on["flip"]:
        d["flip"] = jax.random.bernoulli(r_flip, cfg.aug_hflip, (b,))
    if on["jitter"]:
        v = cfg.aug_color_jitter
        for k, r in zip(("brightness", "contrast", "saturation"), (r_cb, r_cc, r_cs)):
            d[k] = u(r, (b,), minval=max(0, 1 - v), maxval=1 + v)
        d["hue"] = u(r_ch, (b,), minval=-0.03, maxval=0.03)
    if on["optical"]:
        s = cfg.aug_optical_strength
        rad = jnp.deg2rad(45.0 * s)
        d["perspective"] = u(r_opt, (b, 4, 2), minval=0.0, maxval=0.5 * s)
        r1, r2 = jax.random.split(r_opt)
        d["affine_angle"] = u(r1, (b,), minval=-rad, maxval=rad)
        d["shear_angle"] = u(r2, (b,), minval=-rad, maxval=rad)
        d["rotation"] = u(r_opt, (b,), minval=-jnp.deg2rad(45 * s),
                          maxval=jnp.deg2rad(45 * s))
        d["choice"] = jax.random.randint(r_choice, (b,), 0, 3)
    if on["noise"]:
        dtype = jnp.bfloat16 if TT._out_dtype(cfg) == torch.bfloat16 else jnp.float32
        d["noise"] = jax.random.normal(fast_key(r_noise, cfg.fast_rng),
                                       (b, cfg.input_size, cfg.input_size, 3), dtype)
    out = {k: torch.from_numpy(np.array(v)) for k, v in d.items() if k != "noise"}
    if on["noise"]:     # bf16 goes through float32, exactly
        out["noise"] = torch.from_numpy(np.array(d["noise"].astype(jnp.float32))).to(
            TT._out_dtype(cfg))
    return out


def bf16_ulp(x):
    """One bf16 unit in the last place at each value of x (8 bits)."""
    a = np.maximum(np.abs(x.astype(np.float32)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def assert_matches(got, ref, dtype, atol=1e-5):
    """float32 within atol; bf16 within one bf16 ulp of JAX's value."""
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    assert got.shape == ref.shape
    if dtype == "bfloat16":
        assert (np.abs(got - ref) <= bf16_ulp(ref)).all()
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def pixels(b=4, h=32, w=40, seed=7):
    """Seeded pixels in [0, 1] with a grey patch (hue and saturation leave
    it) and a black one."""
    x = np.random.default_rng(seed).uniform(size=(b, h, w, 3)).astype(np.float32)
    x[0, :4, :4] = 0.5
    x[1, :3, :5] = 0.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["adjust_brightness", "adjust_contrast",
                                "adjust_saturation", "adjust_hue"])
def test_colour_ops_match_jax(op, dtype):
    x = pixels()
    rng = np.random.default_rng(8)
    if op == "adjust_hue":
        # negative and wrapping shifts: floor-mod takes the divisor's sign
        f = np.array([0.03, -0.03, -0.6, 0.45], np.float32)
    else:
        f = rng.uniform(0.6, 1.4, size=4).astype(np.float32)
        f[0] = 1.4           # clipped at 1
    ref = getattr(JO, op)(jnp.asarray(x).astype(dtype), jnp.asarray(f))
    got = getattr(TO, op)(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(f))
    assert got.dtype == getattr(torch, dtype)
    assert_matches(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fill", [0.0, 0.25])
def test_grid_sample_matches_jax(dtype, fill):
    """Inside, on the border and outside the image (each corner out of
    range contributes fill); a bf16 image on a float32 grid gives float32."""
    x = pixels()
    rng = np.random.default_rng(9)
    gy = rng.uniform(-3, 35, size=(4, 20, 24)).astype(np.float32)
    gx = rng.uniform(-3, 43, size=(4, 20, 24)).astype(np.float32)
    gy[0, 0, :4], gx[0, 0, :4] = (0.0, 31.0, -0.5, 31.5), (0.0, 39.0, 7.25, 39.5)
    ref = JO.grid_sample_bilinear(jnp.asarray(x).astype(dtype), jnp.asarray(gy),
                                  jnp.asarray(gx), fill=fill)
    got = TO.grid_sample_bilinear(torch.from_numpy(x).to(getattr(torch, dtype)),
                                  torch.from_numpy(gy), torch.from_numpy(gx), fill=fill)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def homographies(b=4, seed=10):
    th = np.random.default_rng(seed).normal(size=(b, 3, 3)).astype(np.float32) * 0.2
    return th + np.eye(3, dtype=np.float32)


def test_affine_grid_and_warp_match_jax():
    """The perspective divide and the half-pixel centres, at another
    output than input size."""
    th, x = homographies(), pixels()
    ref = JO.affine_grid(jnp.asarray(th), (30, 36), (32, 40))
    got = TO.affine_grid(torch.from_numpy(th), (30, 36), (32, 40))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5)
    for dtype in ("float32", "bfloat16"):
        ref = JO.warp_affine(jnp.asarray(x).astype(dtype), jnp.asarray(th), (30, 36))
        got = TO.warp_affine(torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(th), (30, 36))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


OPTICAL = dict(input_size=S, aug_scale=0.5, aug_hflip=0.5, aug_noise_std=0.0,
               aug_optical_strength=0.5)


@pytest.mark.parametrize("builder", ["rrc", "rotation", "affine", "perspective"])
def test_theta_builders_match_jax(builder):
    """Each homography from the uniform draws jax.random gives for JAX's
    split keys; up to a float32 rounding or two (sin, cos and the 8 x 8
    solve are other implementations)."""
    b, key = 16, jax.random.PRNGKey(11)
    d = jax_draws(key, b, SATConfig(**OPTICAL))
    r_rrc, r_opt = (jax.random.split(key, 9)[i] for i in (0, 6))
    if builder == "rrc":
        ref = JT._rrc_theta(r_rrc, b, OPTICAL["aug_scale"])
        got = TT._rrc_theta(d["area"], d["log_ratio"], d["crop_x"], d["crop_y"])
    elif builder == "rotation":
        ref = JT._rotation_theta(jnp.asarray(d["rotation"].numpy()))
        got = TT._rotation_theta(d["rotation"])
    elif builder == "affine":
        ref = JT._affine_theta(r_opt, b, OPTICAL["aug_optical_strength"])
        got = TT._affine_theta(d["affine_angle"], d["shear_angle"])
    else:
        ref = JT._perspective_theta(r_opt, b, 0.5 * OPTICAL["aug_optical_strength"])
        got = TT._perspective_theta(d["perspective"])
    assert got.shape == (b, 3, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=3e-7)


def run_both(kw, b=6, seed=12, monkeypatch=None):
    """JAX's jitted augment and the port's with JAX's draws, on seeded
    uint8 images; returns (port, JAX, the draws)."""
    base = dict(input_size=S, aug_scale=1.0, aug_hflip=0.0, aug_noise_std=0.0)
    base.update(kw)
    imgs = np.random.default_rng(seed).integers(0, 256, (b, S, S, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(seed)
    ref = jax.jit(JT.build_train_augment(JaxConfig(**base)))(key, jnp.asarray(imgs))
    cfg = SATConfig(**base)
    d = jax_draws(key, b, cfg)
    monkeypatch.setattr(TT, "_draws", lambda g, bb, hw, c, dev: d)
    got = TT.build_train_augment(cfg)(gen(), torch.from_numpy(imgs))
    return got, ref, d


@pytest.mark.parametrize("precision", [32, 16])
@pytest.mark.parametrize("kw", [
    dict(aug_color_jitter=0.4),
    dict(aug_optical_strength=0.5),
    dict(aug_color_jitter=0.4, aug_optical_strength=0.5, aug_scale=0.5, aug_hflip=0.5,
         aug_noise_std=0.05),
], ids=["jitter", "optical", "jitter_optical_crop_flip_noise"])
def test_augment_matches_jax(kw, precision, monkeypatch):
    """The whole augment at JAX's draws.  Jitter alone keeps the image's
    type (bf16 at precision 16, within one bf16 ulp of JAX's); with the
    optical warps the result is float32 at both precisions, as JAX's.
    Those warps sample at coordinates up to S / 2 times a homography's
    entries, which differ from JAX's by a rounding (sin, cos and the solve):
    on images of uniform noise, whose neighbours differ by up to 1, that
    moves a value by up to ~2e-5, so the warped cases are held to 3e-5."""
    got, ref, d = run_both(dict(kw, precision=precision), monkeypatch=monkeypatch)
    optical = "aug_optical_strength" in kw
    want = torch.bfloat16 if precision == 16 and not optical else torch.float32
    assert got.dtype == want and str(ref.dtype) == str(want).split(".")[1]
    dtype = "bfloat16" if want == torch.bfloat16 else "float32"
    assert_matches(got, ref, dtype, atol=3e-5 if optical else 1e-5)
    if optical:
        assert set(d["choice"].tolist()) <= {0, 1, 2}


@pytest.mark.parametrize("choice", [0, 1, 2])
def test_each_optical_choice_matches_jax(choice, monkeypatch):
    """Every image warped by one choice: perspective, affine, rotation."""
    kw = dict(aug_optical_strength=1.0, precision=32)
    base = dict(input_size=S, aug_scale=1.0, aug_hflip=0.0, aug_noise_std=0.0, **kw)
    b, key = 4, jax.random.PRNGKey(13)
    imgs = np.random.default_rng(13).integers(0, 256, (b, S, S, 3), dtype=np.uint8)
    cfg = SATConfig(**base)
    d = jax_draws(key, b, cfg)
    d["choice"] = torch.full((b,), choice, dtype=torch.int32)
    # JAX's augment with its choice draw forced the same way
    real = jax.random.randint
    monkeypatch.setattr(jax.random, "randint",
                        lambda k, shape, lo, hi: jnp.full(shape, choice, jnp.int32))
    ref = jax.jit(JT.build_train_augment(JaxConfig(**base)))(key, jnp.asarray(imgs))
    monkeypatch.setattr(jax.random, "randint", real)
    monkeypatch.setattr(TT, "_draws", lambda g, bb, hw, c, dev: d)
    got = TT.build_train_augment(cfg)(gen(), torch.from_numpy(imgs))
    assert_matches(got, ref, "float32", atol=3e-5)
    # a warp moves the picture and leaves black corners (a rotation or a
    # shear always does at strength 1; the perspective shrinks inward)
    assert not torch.allclose(got, torch.from_numpy(imgs).float() / 255)


def test_draws_ranges():
    """The port's own draws: the jitter factors in U(max(0, 1 - v), 1 + v),
    the hue shift in U(-0.03, 0.03), the angles within 45 s degrees, the
    perspective shifts within 0.5 s, every choice drawn, the noise of the
    output's type and size."""
    v, s, n = 0.4, 0.5, 3000
    cfg = SATConfig(input_size=S, aug_scale=1.0, aug_hflip=0.0, aug_color_jitter=v,
                    aug_optical_strength=s, aug_noise_std=0.1, precision=16)
    d = TT._draws(gen(14), n, (S, S), cfg, torch.device("cpu"))
    for k in ("brightness", "contrast", "saturation"):
        assert d[k].min() >= 1 - v and d[k].max() <= 1 + v
        assert abs(float(d[k].mean()) - 1) < 0.02
    assert d["hue"].abs().max() <= 0.03
    rad = np.deg2rad(45 * s)
    for k in ("affine_angle", "shear_angle", "rotation"):
        assert d[k].abs().max() <= rad and d[k].abs().max() > 0.9 * rad
    assert d["perspective"].shape == (n, 4, 2)
    assert d["perspective"].min() >= 0 and d["perspective"].max() <= 0.5 * s
    assert sorted(torch.bincount(d["choice"]).tolist())[0] > n / 4
    # with the optical warps on, precision 16 gives float32, as JAX
    assert d["noise"].shape == (n, S, S, 3) and d["noise"].dtype == torch.float32
    assert "area" not in d and "flip" not in d


def test_jitter_and_optical_ranges():
    """Outputs stay in [0, 1] without noise; the jitter changes colours."""
    x = images(b=8)
    cfg = cfg_(aug_color_jitter=0.4, aug_optical_strength=0.5, aug_scale=0.5,
               aug_hflip=0.5)
    got = TT.build_train_augment(cfg)(gen(15), x)
    assert got.shape == (8, S, S, 3) and got.dtype == torch.float32
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    jit = TT.build_train_augment(cfg_(aug_color_jitter=0.4))(gen(16), x)
    assert not torch.allclose(jit, x.float() / 255)
