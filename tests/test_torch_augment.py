"""The port's on-device training augmentation against the JAX package's
`train_augment`, on the same draws: the test repeats the JAX function's own
`jax.random` calls on the same keys and hands the values to the port's
`apply_train_augment`, so a draw applied wrongly shows up as a wrong image.
Also the port's CLAHE against the JAX `clahe_rgb` alone."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptersis_tpu.data.augment import train_augment
from adaptersis_tpu.data.clahe import clahe_rgb as jax_clahe_rgb
from adaptersis_tpu.data.clahe import rgb_to_lab as jax_rgb_to_lab
from adaptersis_tpu_torch.data.augment import apply_train_augment, draw_train_augment
from adaptersis_tpu_torch.data.clahe import clahe_rgb, rgb_to_lab
from adaptersis_tpu_torch.data.synthetic import SyntheticSeg


def _images(B, H, W, seed):
    """Synthetic frames with seeded noise, so every CLAHE tile has texture."""
    rng = np.random.default_rng(seed)
    ds = SyntheticSeg(n=B, imsize=max(H, W), num_classes=2, seed=seed)
    imgs, masks = next(ds.batches(B))
    noisy = imgs[:, :H, :W].astype(np.int32) + rng.integers(-20, 21, (B, H, W, 3))
    return np.clip(noisy, 0, 255).astype(np.uint8), masks[:, :H, :W]


def _jax_draws(rng, B, S, use_clahe=True):
    """The draws of `train_augment`, by its own random calls on its keys."""
    keys = jax.random.split(rng, 10)
    cols = {k: [] for k in ("size", "y0", "x0", "flip", "k90")}
    for key in jax.random.split(keys[0], B):
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        do_crop = jax.random.bernoulli(k1, 0.5)
        size = jax.random.randint(k2, (), int(S * 0.5), S + 1).astype(jnp.float32)
        size = jnp.where(do_crop, size, float(S))
        max_off = jnp.maximum(S - size, 0.0)
        kf, kr, kp = jax.random.split(k5, 3)
        cols["size"].append(size)
        cols["y0"].append(jax.random.uniform(k3, ()) * max_off)
        cols["x0"].append(jax.random.uniform(k4, ()) * max_off)
        cols["flip"].append(jax.random.bernoulli(kf, 0.5))
        cols["k90"].append(jnp.where(jax.random.bernoulli(kp, 0.5),
                                     jax.random.randint(kr, (), 0, 4), 0))
    d = {k: np.asarray(jnp.stack(v)) for k, v in cols.items()}
    if use_clahe:
        d["clahe"] = np.asarray(jax.random.bernoulli(keys[1], 0.8, (B,)))
        d["clip"] = np.asarray(jax.random.uniform(keys[7], (B,), minval=1.0, maxval=4.0))
    d["bc"] = np.asarray(jax.random.bernoulli(keys[2], 0.8, (B,)))
    d["alpha"] = np.asarray(1.0 + jax.random.uniform(keys[3], (B,), minval=-0.2, maxval=0.2))
    d["beta"] = np.asarray(jax.random.uniform(keys[4], (B,), minval=-0.2, maxval=0.2))
    d["gamma_on"] = np.asarray(jax.random.bernoulli(keys[5], 0.8, (B,)))
    d["gamma"] = np.asarray(jax.random.uniform(keys[6], (B,), minval=0.8, maxval=1.2))
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("seed,use_clahe", [(0, True), (1, True), (2, False)])
def test_train_augment_matches_jax_on_the_same_draws(seed, use_clahe):
    B, S = 6, 60                         # 60 is no multiple of CLAHE's 8 tiles
    imgs, masks = _images(B, S, S, seed)
    rng = jax.random.PRNGKey(seed)
    want_x, want_m = train_augment(jnp.asarray(imgs), jnp.asarray(masks), rng,
                                   use_clahe=use_clahe)
    draws = _jax_draws(rng, B, S, use_clahe)
    assert draws["size"].min() < S and draws["flip"].any() and (draws["k90"] > 0).any()
    x, m = apply_train_augment(torch.from_numpy(imgs), torch.from_numpy(masks), draws)
    np.testing.assert_array_equal(m.numpy(), np.asarray(want_m))
    # every stage rounds to uint8. Where the two frameworks' fp32 pow, cbrt
    # and sums differ by an ulp, a value sitting on .5 rounds the other way:
    # 1/255 at most, on under 0.1% of the values
    diff = np.abs(x.numpy() * 255.0 - np.asarray(want_x) * 255.0)
    assert diff.max() <= 1.0 + 1e-3
    assert (diff > 0.5).mean() < 1e-3
    assert x.dtype == torch.float32 and x.shape == (B, S, S, 3)


def test_draws_are_seeded_and_well_formed():
    a = draw_train_augment(torch.Generator().manual_seed(3), 64, 60)
    b = draw_train_augment(torch.Generator().manual_seed(3), 64, 60)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    crop = a["size"] < 60
    assert 0 < crop.float().mean() < 1 and (a["size"] >= 30).all()
    assert ((a["y0"] <= 60 - a["size"]) & (a["y0"] >= 0)).all()
    assert (a["y0"][~crop] == 0).all() and set(a["k90"].tolist()) == {0, 1, 2, 3}
    assert (a["clip"] >= 1).all() and (a["clip"] <= 4).all()
    assert "clahe" not in draw_train_augment(torch.Generator(), 4, 60, use_clahe=False)


# (image size, largest difference, share of differing values). 61×58 is
# padded to 64×64 with tiles of 8×8 pixels, as 588 px is padded with tiles
# of 74: an ulp of difference in the colour transforms can round an output
# channel the other way. 72×72 has tiles of 9×9: XLA divides the pixel index
# by 9 as a multiplication by a rounded 1/9, so the JAX package's blend
# weights of rows and columns at multiples of 9 sit an ulp off the exact
# 1/2, and a blend of integer LUT values that is exactly x.5 rounds the other
# way: its L moves by 1, its RGB by up to 3
@pytest.mark.parametrize("hw,max_diff,share", [((61, 58), 1, 1e-3), ((72, 72), 3, 0.015)])
@pytest.mark.parametrize("clip", [1.0, 2.5, 4.0])
def test_clahe_matches_jax(clip, hw, max_diff, share):
    imgs, _ = _images(2, *hw, seed=int(clip * 10))
    want = np.asarray(jax_clahe_rgb(jnp.asarray(imgs), clip))
    got = clahe_rgb(torch.from_numpy(imgs), clip).numpy()
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= max_diff and (diff > 0).mean() < share, (diff.max(), (diff > 0).mean())


def test_rgb_to_lab_matches_jax():
    rgb = np.random.default_rng(0).uniform(0, 1, (4, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(rgb_to_lab(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jax_rgb_to_lab(jnp.asarray(rgb))), atol=1e-4, rtol=0)
