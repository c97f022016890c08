"""The port's Mask2Former head and criterion (`models/mask2former.py`,
`models/m2f_loss.py`) against the JAX package at a small size (32
channels, 10 queries, 3 decoder layers), every parameter drawn from a
seed, the JAX package's random points fed to both; then an independent
oracle of the matching and loss math, re-derived from the upstream
Mask2Former formulas (detectron2's `point_sample` by `grid_sample`, the
matcher's costs, `sigmoid_ce_loss`, `dice_loss`, the weighted CE), with the
JAX package's departures from upstream asserted as named differences:

  * "border padding": `point_sample` clamps its corners to the map
    (grid_sample's padding_mode="border"), where upstream reads zeros
    outside it;
  * "ground truth resized first": the ground-truth masks go to the mask
    logits' size by nearest resampling before they are point-sampled,
    where upstream samples the full-resolution masks;
  * "nearest uncertainty": the uncertainty of an oversampled point is
    −|logit| at its nearest pixel, where upstream samples the logits
    bilinearly.
The port follows the JAX package."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

import jax
import jax.numpy as jnp

from adaptersis_tpu.models import m2f_loss as jax_loss
from adaptersis_tpu.models import mask2former as jax_m2f
from adaptersis_tpu_torch.models import m2f_loss, mask2former
from torch_parity import (init_perturbed, load, m2f_layer_draws, m2f_total_draws, n,  # noqa: F401
                          single_thread, t)

pytestmark = pytest.mark.usefixtures("single_thread")

E, C, Q, NC = 24, 32, 10, 3          # adapter width, head width, queries, classes
FEAT_HW = (16, 8, 4, 2)              # f1 .. f4
# fp32 on both sides; flax's LayerNorm takes E[x²] − E[x]², torch two passes
ATOL = 1e-4


def _feats(seed, B=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, s, s, E)).astype(np.float32) for s in FEAT_HW]


def _close(got, want, atol=ATOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(n(got), want, atol=atol * max(1.0, np.abs(want).max()), rtol=0)


def test_sine_positional_encoding():
    for hw, f in (((5, 7), 16), ((64, 64), 128)):
        _close(mask2former.sine_positional_encoding(hw, f),
               jax_m2f.sine_positional_encoding(hw, f), atol=1e-6)


def test_point_sample_and_semantic_inference():
    rng = np.random.default_rng(1)
    m = rng.standard_normal((6, 13, 9)).astype(np.float32)
    p = rng.uniform(-0.1, 1.1, (6, 50, 2)).astype(np.float32)
    _close(mask2former.point_sample(t(m), t(p)), jax_m2f.point_sample(jnp.asarray(m),
                                                                      jnp.asarray(p)), 1e-6)
    cls = rng.standard_normal((2, Q, NC + 1)).astype(np.float32)
    masks = rng.standard_normal((2, Q, 8, 8)).astype(np.float32)
    _close(mask2former.mask2former_semantic_inference(t(cls), t(masks), (30, 30)),
           jax_m2f.mask2former_semantic_inference(jnp.asarray(cls), jnp.asarray(masks),
                                                  (30, 30)), 1e-6)


def test_uncertainty_sample_points_with_the_jax_draws():
    """The same points as the JAX function from its key, ties included (the
    logits are constant over 2×2 blocks, so many candidates share a pixel)."""
    rng = np.random.default_rng(2)
    logits = np.repeat(np.repeat(rng.standard_normal((4, 7, 7)), 2, 1), 2, 2)
    logits = logits.astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jax_m2f.uncertainty_sample_points(jnp.asarray(logits), 64, key)
    k1, k2 = jax.random.split(key)
    over = np.asarray(jax.random.uniform(k1, (4, 192, 2)))
    rand = np.asarray(jax.random.uniform(k2, (4, 16, 2)))
    got = mask2former.uncertainty_sample_points(t(logits), 64, t(over), t(rand))
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_ground_truth_prep():
    """semantic_to_instances, naive_dice and the half-pixel nearest resize
    (518 → 130 as at the default size, where F.interpolate's nearest
    differs) against the JAX package."""
    rng = np.random.default_rng(4)
    sem = rng.integers(0, NC, (2, 518, 518)).astype(np.int32)
    sem[1][sem[1] == 2] = 0                         # class 2 absent in image 1
    masks, labels = m2f_loss.semantic_to_instances(torch.from_numpy(sem), NC, NC + 1)
    jm, jl = jax.vmap(lambda s: jax_loss.semantic_to_instances(s, NC, NC + 1))(jnp.asarray(sem))
    np.testing.assert_array_equal(n(masks), np.asarray(jm))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    small = m2f_loss.resize_nearest_half(masks, (130, 130))
    want = jax.image.resize(jm, (2, NC + 1, 130, 130), "nearest")
    np.testing.assert_array_equal(n(small), np.asarray(want))
    assert not torch.equal(F.interpolate(masks, size=(130, 130), mode="nearest"), small)
    p, g = rng.uniform(size=(5, 40)).astype(np.float32), (rng.uniform(size=(5, 40)) > 0.5)
    _close(m2f_loss.naive_dice(t(p), t(g)), jax_loss.naive_dice(jnp.asarray(p),
                                                                 jnp.asarray(g, jnp.float32)),
           1e-6)


def test_slide_inference():
    """Overlapping windows (a 30 × 26 image, window 16, stride 10) through a
    fixed per-pixel map, averaged where they overlap."""
    rng = np.random.default_rng(16)
    img = rng.uniform(size=(2, 30, 26, 3)).astype(np.float32)
    w = rng.standard_normal((3, NC)).astype(np.float32)

    def fwd(crop):
        return crop @ (t(w) if isinstance(crop, torch.Tensor) else jnp.asarray(w)) + 0.1 * crop[
            ..., :1]

    _close(m2f_loss.slide_inference(fwd, t(img), 16, 10, NC),
           jax_loss.slide_inference(fwd, jnp.asarray(img), 16, 10, NC), 1e-6)


def _head_pair(layers=3):
    jhead = jax_m2f.Mask2FormerHead(num_classes=NC, num_queries=Q, feat_channels=C,
                                    num_decoder_layers=layers)
    return jhead, mask2former.Mask2FormerHead(E, NC, Q, C, layers)


def test_pixel_decoder():
    feats = _feats(5)
    jdec = jax_m2f.MSDeformAttnPixelDecoder(feat_channels=C)
    args = [jnp.asarray(f) for f in feats]
    variables = init_perturbed(jdec, 6, args)
    want_mf, want_mems = jax.jit(jdec.apply)(variables, args)
    dec = load(mask2former.MSDeformAttnPixelDecoder(E, C), variables)
    with torch.no_grad():
        mf, mems = dec([t(f) for f in feats])
    _close(mf, want_mf)
    assert [tuple(m.shape[1:3]) for m in mems] == [(2, 2), (4, 4), (8, 8)]
    for got, want in zip(mems, want_mems):
        _close(got, want)


def test_head_predictions():
    """cls_all and mask_all of every prediction (the initial queries and 3
    decoder layers cycling over the levels, masked cross-attention)."""
    feats = _feats(7)
    jhead, head = _head_pair()
    args = [jnp.asarray(f) for f in feats]
    variables = init_perturbed(jhead, 8, args)
    want_cls, want_mask = jax.jit(jhead.apply)(variables, args)
    with torch.no_grad():
        cls_all, mask_all = load(head, variables)([t(f) for f in feats])
    assert len(cls_all) == 4 and tuple(mask_all[-1].shape) == (2, Q, 16, 16)
    for got, want in zip(cls_all + mask_all, list(want_cls) + list(want_mask)):
        _close(got, want)


def _loss_inputs(seed, L=3, B=2, G=NC):
    rng = np.random.default_rng(seed)
    cls = rng.standard_normal((L, B, Q, NC + 1)).astype(np.float32)
    masks = (2 * rng.standard_normal((L, B, Q, 14, 14))).astype(np.float32)
    sem = rng.integers(0, NC, (B, 56, 56)).astype(np.int32)
    sem[0][sem[0] == 1] = 0                 # a padded (absent) segment in image 0
    gm, gl = m2f_loss.semantic_to_instances(torch.from_numpy(sem), NC, G)
    return cls, masks, gm, gl


def test_layer_and_total_loss_with_the_jax_draws(monkeypatch):
    """Per layer loss_cls, loss_mask and loss_dice within 1e-5, and the
    total over the layers, from the same key. The JAX package runs its
    device LAPJV here (`ASN_M2F_DEVICE_HUNGARIAN=1`, its TPU path): its host
    scipy path returns the pairs in query order, not in gt-slot order, so
    each pair's uncertainty points come from another row of the draws
    there (ROADMAP.md, "Found in the JAX package")."""
    monkeypatch.setenv("ASN_M2F_DEVICE_HUNGARIAN", "1")
    cls, masks, gm, gl = _loss_inputs(9)
    key = jax.random.PRNGKey(10)
    jgm, jgl = jnp.asarray(n(gm)), jnp.asarray(gl.numpy())
    layer_loss = jax.jit(jax_loss.m2f_layer_loss)
    for li in range(3):
        want = layer_loss(jnp.asarray(cls[li]), jnp.asarray(masks[li]), jgm, jgl, key)
        d = {k: t(v) for k, v in m2f_layer_draws(key, 2, NC).items()}
        got = m2f_loss.m2f_layer_loss(t(cls[li]), t(masks[li]), gm, gl, d)
        for part, v in want.items():
            assert abs(float(got[part]) - float(v)) <= 1e-5 * max(1.0, abs(float(v))), part
    total, logs = jax.jit(jax_loss.m2f_total_loss)(list(jnp.asarray(cls)),
                                                   list(jnp.asarray(masks)), jgm, jgl, key)
    got_total, got_logs = m2f_loss.m2f_total_loss(list(t(cls)), list(t(masks)), gm, gl,
                                                  m2f_total_draws(key, 3, 2, NC))
    assert abs(float(got_total) - float(total)) <= 1e-5 * abs(float(total))
    for part, v in logs.items():
        assert abs(float(got_logs[part]) - float(v)) <= 1e-5 * max(1.0, abs(float(v))), part


# ---- the independent oracle: upstream Mask2Former's formulas

def upstream_point_sample(x, coords, padding_mode="zeros"):
    """detectron2's point_sample: grid_sample at 2·p − 1, align_corners=False."""
    return F.grid_sample(x[:, None], 2.0 * coords[:, None] - 1.0, mode="bilinear",
                         padding_mode=padding_mode, align_corners=False)[:, 0, 0]


def upstream_costs(logits, tgt_ids, out_pts, tgt_pts):
    """HungarianMatcher's class, batch_sigmoid_ce and batch_dice costs."""
    cost_class = -logits.softmax(-1)[:, tgt_ids]
    pos = F.binary_cross_entropy_with_logits(out_pts, torch.ones_like(out_pts), reduction="none")
    neg = F.binary_cross_entropy_with_logits(out_pts, torch.zeros_like(out_pts),
                                             reduction="none")
    cost_mask = (torch.einsum("nc,mc->nm", pos, tgt_pts)
                 + torch.einsum("nc,mc->nm", neg, 1 - tgt_pts)) / out_pts.shape[1]
    p = out_pts.sigmoid()
    num = 2 * torch.einsum("nc,mc->nm", p, tgt_pts)
    den = p.sum(-1)[:, None] + tgt_pts.sum(-1)[None, :]
    return cost_class, cost_mask, 1 - (num + 1) / (den + 1)


def upstream_mask_losses(out_pts, tgt_pts, num_masks):
    """sigmoid_ce_loss and dice_loss."""
    ce = F.binary_cross_entropy_with_logits(out_pts, tgt_pts, reduction="none").mean(1)
    p = out_pts.sigmoid()
    dice = 1 - (2 * (p * tgt_pts).sum(-1) + 1) / (p.sum(-1) + tgt_pts.sum(-1) + 1)
    return ce.sum() / num_masks, dice.sum() / num_masks


def test_departure_border_padding():
    rng = np.random.default_rng(11)
    m = torch.from_numpy(rng.standard_normal((3, 9, 11)).astype(np.float32))
    inside = torch.from_numpy(rng.uniform(0.1, 0.9, (3, 40, 2)).astype(np.float32))
    edge = torch.from_numpy(rng.uniform(-0.05, 0.05, (3, 40, 2)).astype(np.float32))
    got_in = mask2former.point_sample(m, inside)
    # the same four corners and weights, rounded in other orders
    torch.testing.assert_close(got_in, upstream_point_sample(m, inside), atol=1e-5, rtol=0)
    got_edge = mask2former.point_sample(m, edge)
    torch.testing.assert_close(got_edge, upstream_point_sample(m, edge, "border"),
                               atol=1e-5, rtol=0)
    assert (got_edge - upstream_point_sample(m, edge)).abs().max() > 0.1


def test_departure_ground_truth_resized_first():
    """A one-pixel-wide stripe of the 56 px mask vanishes from the 14 px
    map the JAX package samples; upstream's samples of the full mask see it."""
    gt = torch.zeros(1, 56, 56)
    gt[0, :, 29] = 1.0
    pts = torch.tensor([[[29.5 / 56, 0.5]]])
    small = m2f_loss.resize_nearest_half(gt, (14, 14))
    assert float(mask2former.point_sample(small, pts)) == 0.0
    assert float(upstream_point_sample(gt, pts)) == 1.0


def test_departure_nearest_uncertainty():
    rng = np.random.default_rng(12)
    logits = torch.from_numpy(rng.standard_normal((2, 6, 6)).astype(np.float32))
    over = torch.from_numpy(rng.uniform(size=(2, 96, 2)).astype(np.float32))
    rand = torch.zeros(2, 8, 2)
    got = mask2former.uncertainty_sample_points(logits, 32, over, rand)[:, :24]
    unc = -upstream_point_sample(logits, over, "border").abs()
    idx = unc.topk(24, dim=1).indices
    upstream = over.gather(1, idx[..., None].expand(-1, -1, 2))
    assert not torch.equal(got.sort(1).values, upstream.sort(1).values)


def test_oracle_costs_and_point_losses():
    rng = np.random.default_rng(13)
    logits = torch.from_numpy(rng.standard_normal((1, Q, NC + 1)).astype(np.float32))
    mp = torch.from_numpy(3 * rng.standard_normal((1, Q, 64)).astype(np.float32))
    gp = torch.from_numpy(rng.uniform(size=(1, 2, 64)).astype(np.float32))
    labels = torch.tensor([[2, 0]])
    costs = m2f_loss.match_costs(logits, labels, mp, gp)
    want = upstream_costs(logits[0], labels[0], mp[0], gp[0])
    for got, w in zip((costs["cls"], costs["mask"], costs["dice"]), want):
        torch.testing.assert_close(got[0], w, atol=1e-6, rtol=1e-6)
    bce, dice = m2f_loss.point_mask_losses(mp[0], gp[0, :1].expand(Q, -1))
    ce_w, dice_w = upstream_mask_losses(mp[0], gp[0, :1].expand(Q, -1), 1.0)
    torch.testing.assert_close(bce.sum(), ce_w, atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(dice.sum(), dice_w, atol=1e-5, rtol=1e-6)


def test_oracle_layer_loss():
    """m2f_layer_loss against the whole criterion re-derived: upstream's
    costs on grid_sample'd points (border padding, the ground truth resized
    first: the named departures), scipy's assignment, F.cross_entropy with
    the no-object weight 0.1, and upstream's mask losses on the port's
    uncertainty points, all weighted 2, 5, 5."""
    cls, masks, gm, gl = _loss_inputs(14, L=1)
    cls, masks = t(cls[0]), t(masks[0])
    draws = m2f_loss.loss_draws(torch.Generator().manual_seed(15), 1, 2, NC)
    got = m2f_loss.m2f_layer_loss(cls, masks, gm, gl, draws)
    small = m2f_loss.resize_nearest_half(gm, (14, 14))
    ce_sum = ce_w = bce_sum = dice_sum = n_masks = 0.0
    for b in range(2):
        valid = [g for g in range(NC) if gl[b, g] >= 0]
        pts = draws["match"][0, b][None]
        mp = upstream_point_sample(masks[b], pts.expand(Q, -1, -1), "border")
        gp = upstream_point_sample(small[b], pts.expand(NC, -1, -1), "border")
        cc, cm, cd = upstream_costs(cls[b], gl[b].clamp(min=0), mp, gp)
        cost = (2 * cc + 5 * cm + 5 * cd)[:, valid].numpy()
        rows, cols = linear_sum_assignment(cost)
        target = torch.full((Q,), NC)
        for r, c in zip(rows, cols):
            target[r] = gl[b, valid[c]]
        w = torch.ones(NC + 1)
        w[NC] = 0.1
        ce_sum += float(F.cross_entropy(cls[b], target, weight=w, reduction="sum"))
        ce_w += float(w[target].sum())
        for r, c in zip(rows, cols):
            g = valid[c]
            k = b * NC + g
            upts = mask2former.uncertainty_sample_points(
                masks[b, r][None], 256, draws["over"][0, k][None], draws["rand"][0, k][None])
            mpts = upstream_point_sample(masks[b, r][None], upts, "border")
            gpts = upstream_point_sample(small[b, g][None], upts, "border")
            ce_m, d_m = upstream_mask_losses(mpts, gpts, 1.0)
            bce_sum, dice_sum, n_masks = bce_sum + float(ce_m), dice_sum + float(d_m), n_masks + 1
    want = {"loss_cls": 2 * ce_sum / ce_w, "loss_mask": 5 * bce_sum / n_masks,
            "loss_dice": 5 * dice_sum / n_masks}
    for part, v in want.items():
        assert abs(float(got[part]) - v) <= 1e-5 * max(1.0, abs(v)), (part, float(got[part]), v)
