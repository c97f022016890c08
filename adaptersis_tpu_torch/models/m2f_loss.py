"""The Mask2Former training criterion (counterpart of the JAX package's
`models/m2f_loss.py`). Per prediction (decoder layer): Hungarian-match the
queries to the ground-truth segments on class, point-sampled mask BCE and
point-sampled dice costs, then

  * cross-entropy over the classes, the no-object class weighted 0.1;
  * sigmoid BCE and naive dice of the matched masks on uncertainty-sampled
    points.

Ground truth: (B, G, H, W) binary masks and (B, G) labels, label −1 for a
padded slot. The ground truth goes to the mask logits' size by nearest
resampling at half-pixel centres (`resize_nearest_half`, the rule of
`jax.image.resize(..., "nearest")`; F.interpolate's "nearest" samples
elsewhere and disagrees at 518 → 130).

The random points are drawn apart from the arithmetic (`loss_draws`, from
a `torch.Generator`) and passed in, so a test can feed the JAX package's
draws. `m2f_total_loss` computes every prediction's costs at once, solves
all their assignments in one batched LAPJV (`ops/hungarian.py`) and their
losses in one pass: the step's matching is a fixed sequence of small
device ops, with no host round trip.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.hungarian import lapjv
from .mask2former import IMPORTANCE, point_sample, uncertainty_sample_points

Draws = Dict[str, torch.Tensor]


def naive_dice(pred: torch.Tensor, target: torch.Tensor, eps: float = 1.0) -> torch.Tensor:
    """Naive dice loss on point sets: (..., P) sigmoid probabilities against
    0/1 targets."""
    num = 2 * (pred * target).sum(-1)
    den = pred.sum(-1) + target.sum(-1) + eps
    return 1 - (num + eps) / den


def resize_nearest_half(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of the last two axes, sampling source pixel
    floor((i + 0.5)·in/out) in fp32, as `jax.image.resize(..., "nearest")`."""
    (h, w), (H, W) = size, x.shape[-2:]

    def src(out, n):
        i = torch.arange(out, dtype=torch.float32, device=x.device)
        return ((i + 0.5) * n / out).floor().long().clamp(max=n - 1)

    return x[..., src(h, H)[:, None], src(w, W)[None, :]]


# the criterion's constants: points per mask, the oversampling factor of
# the uncertainty sampling, the parts' weights, the no-object class weight
NUM_POINTS, OVERSAMPLE = 256, 3.0
CLASS_WEIGHT, MASK_WEIGHT, DICE_WEIGHT, NO_OBJECT_WEIGHT = 2.0, 5.0, 5.0, 0.1


def loss_draws(generator: torch.Generator, layers: int, batch: int, segments: int
               ) -> Draws:
    """Uniform points in [0, 1]² for `layers` predictions, on the
    generator's device: the matching's shared points per image ("match"
    (L, B, P, 2)), and per matched mask the oversampled candidates ("over"
    (L, B·G, int(P·OVERSAMPLE), 2)) and the random fill ("rand" (L, B·G, P
    − int(P·IMPORTANCE), 2))."""
    P = NUM_POINTS
    shapes = {"match": (layers, batch, P, 2),
              "over": (layers, batch * segments, int(P * OVERSAMPLE), 2),
              "rand": (layers, batch * segments, P - int(P * IMPORTANCE), 2)}
    return {k: torch.rand(s, generator=generator, device=generator.device)
            for k, s in shapes.items()}


def match_costs(cls_logits: torch.Tensor, labels: torch.Tensor, mp: torch.Tensor,
                gp: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The matcher's costs (N, Q, G), unweighted: "cls" −softmax(cls)[label],
    "mask" the mean over the P points of the BCE of each query's logits mp
    (N, Q, P) against each segment's values gp (N, G, P), "dice" 1 − (2·Σ
    σ(mp)·gp + 1)/(Σ σ(mp) + Σ gp + 1)."""
    N, Q, _ = cls_logits.shape
    G, P = gp.shape[1], gp.shape[2]
    cls_prob = torch.softmax(cls_logits, dim=-1)
    cost_cls = -cls_prob.gather(2, labels[:, None, :].expand(N, Q, G))
    cost_mask = (torch.einsum("nqp,ngp->nqg", -F.logsigmoid(mp), gp)
                 + torch.einsum("nqp,ngp->nqg", -F.logsigmoid(-mp), 1 - gp)) / P
    mprob = torch.sigmoid(mp)
    num = 2 * torch.einsum("nqp,ngp->nqg", mprob, gp)
    den = mprob.sum(-1)[:, :, None] + gp.sum(-1)[:, None, :] + 1.0
    return {"cls": cost_cls, "mask": cost_mask, "dice": 1 - (num + 1.0) / den}


def point_mask_losses(mpts: torch.Tensor, gpts: torch.Tensor):
    """Per matched mask (..., P): the mean sigmoid BCE of the logits mpts
    against gpts (in the stable form max(x, 0) − x·t + log1p(e^−|x|)) and
    the naive dice loss of σ(mpts)."""
    bce = (mpts.clamp(min=0) - mpts * gpts + torch.log1p(torch.exp(-mpts.abs()))).mean(-1)
    return bce, naive_dice(torch.sigmoid(mpts), gpts)


def _losses(cls_logits: torch.Tensor, mask_logits: torch.Tensor, gt_masks: torch.Tensor,
            gt_labels: torch.Tensor, draws: Draws) -> Dict[str, torch.Tensor]:
    """The criterion for L predictions at once: cls_logits (L, B, Q, C+1),
    mask_logits (L, B, Q, h, w). Returns each part as an (L,) tensor."""
    L, B, Q, C1 = cls_logits.shape
    G, P = gt_masks.shape[1], NUM_POINTS
    nc = C1 - 1
    h, w = mask_logits.shape[-2:]
    N = L * B
    valid_gt = (gt_labels >= 0).repeat(L, 1)                              # (N, G)
    gt_small = resize_nearest_half(gt_masks, (h, w)).to(mask_logits.dtype)   # (B, G, h, w)
    gt_rep = gt_small.repeat(L, 1, 1, 1)                                  # (N, G, h, w)
    cls_logits = cls_logits.reshape(N, Q, C1)
    masks = mask_logits.reshape(N, Q, h, w)
    safe_labels = gt_labels.clamp(0, nc - 1).repeat(L, 1)                 # (N, G)

    # ---- matching costs on a shared random point set per image
    with torch.no_grad():
        pts = draws["match"].reshape(N, 1, P, 2).to(masks.dtype)
        mp = point_sample(masks.flatten(0, 1), pts.expand(N, Q, P, 2).flatten(0, 1)).view(N, Q, -1)
        gp = point_sample(gt_rep.flatten(0, 1), pts.expand(N, G, P, 2).flatten(0, 1)).view(N, G, -1)
        costs = match_costs(cls_logits, safe_labels, mp, gp)
        cost = (CLASS_WEIGHT * costs["cls"] + MASK_WEIGHT * costs["mask"]
                + DICE_WEIGHT * costs["dice"])
        cost = torch.where(valid_gt[:, None, :], cost, torch.full_like(cost, 1e6))
        assign = lapjv(cost)                                              # (N, 2, G)
    q_idx, g_idx = assign[:, 0], assign[:, 1]                             # (N, G)

    # ---- classification: matched queries take their gt class, the rest no-object
    matched_labels = safe_labels.gather(1, g_idx)
    matched_valid = valid_gt.gather(1, g_idx)
    target = torch.full((N, Q), nc, dtype=torch.long, device=cls_logits.device)
    target = target.scatter(1, q_idx, torch.where(matched_valid, matched_labels,
                                                  torch.full_like(matched_labels, nc)))
    wvec = torch.ones(C1, dtype=cls_logits.dtype, device=cls_logits.device)
    wvec[nc] = NO_OBJECT_WEIGHT
    ce = -torch.log_softmax(cls_logits, dim=-1).gather(2, target[..., None])[..., 0]
    wts = wvec[target]
    loss_cls = (ce * wts).view(L, -1).sum(1) / wts.view(L, -1).sum(1).clamp(min=1.0)

    # ---- mask losses of the matched pairs on uncertainty-sampled points
    m_matched = masks.gather(1, q_idx[:, :, None, None].expand(N, G, h, w))
    g_matched = gt_rep.gather(1, g_idx[:, :, None, None].expand(N, G, h, w))
    flat_m, flat_g = m_matched.reshape(N * G, h, w), g_matched.reshape(N * G, h, w)
    with torch.no_grad():
        upts = uncertainty_sample_points(
            flat_m.detach(), P, draws["over"].reshape(N * G, -1, 2).to(flat_m.dtype),
            draws["rand"].reshape(N * G, -1, 2))
    mpts = point_sample(flat_m, upts)                                     # (N·G, P)
    gpts = point_sample(flat_g, upts)
    vm = matched_valid.reshape(L, -1).to(mpts.dtype)
    n_valid = vm.sum(1).clamp(min=1.0)
    bce, dl = point_mask_losses(mpts, gpts)
    loss_mask = (bce.view(L, -1) * vm).sum(1) / n_valid
    loss_dice = (dl.view(L, -1) * vm).sum(1) / n_valid
    return {"loss_cls": CLASS_WEIGHT * loss_cls, "loss_mask": MASK_WEIGHT * loss_mask,
            "loss_dice": DICE_WEIGHT * loss_dice}


def m2f_layer_loss(cls_logits: torch.Tensor, mask_logits: torch.Tensor,
                   gt_masks: torch.Tensor, gt_labels: torch.Tensor, draws: Draws
                   ) -> Dict[str, torch.Tensor]:
    """One prediction's parts: cls_logits (B, Q, C+1), mask_logits (B, Q, h,
    w), gt_masks (B, G, H, W) 0/1, gt_labels (B, G) (−1 = pad), `draws` of
    one layer (`loss_draws(..., layers=1)` or with its layer axis dropped)."""
    d = {k: v if v.dim() == 4 else v[None] for k, v in draws.items()}
    parts = _losses(cls_logits[None], mask_logits[None], gt_masks, gt_labels, d)
    return {k: v[0] for k, v in parts.items()}


def m2f_total_loss(cls_all: Sequence[torch.Tensor], mask_all: Sequence[torch.Tensor],
                   gt_masks: torch.Tensor, gt_labels: torch.Tensor, draws: Draws
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The sum of every prediction's parts (per-layer auxiliary supervision),
    and the last prediction's parts for the log; `draws` from `loss_draws`
    with one layer per prediction."""
    parts = _losses(torch.stack(list(cls_all)), torch.stack(list(mask_all)), gt_masks,
                    gt_labels, draws)
    total = sum(v.sum() for v in parts.values())
    return total, {k: v[-1] for k, v in parts.items()}


def semantic_to_instances(mask: torch.Tensor, num_classes: int, max_segments: int):
    """A batch of semantic maps (B, H, W) → per-class binary masks (B, G, H, W)
    fp32 and labels (B, G), class c in slot c − 1, −1 where a class is absent
    and in the padding up to `max_segments`."""
    B, H, W = mask.shape
    labels = torch.arange(1, num_classes, device=mask.device)
    masks = (mask[:, None] == labels[None, :, None, None]).float()
    present = masks.flatten(2).sum(-1) > 0
    labels = torch.where(present, labels[None], torch.full_like(labels[None], -1))
    pad = max_segments - (num_classes - 1)
    if pad > 0:
        masks = torch.cat([masks, masks.new_zeros((B, pad, H, W))], 1)
        labels = torch.cat([labels, labels.new_full((B, pad), -1)], 1)
    return masks[:, :max_segments], labels[:, :max_segments]


def slide_inference(fwd, image: torch.Tensor, window: int, stride: int,
                    num_classes: int) -> torch.Tensor:
    """Sliding-window inference of NHWC `image`: `fwd` maps a (B, window,
    window, 3) crop to (B, window, window, num_classes) logits, and the
    overlapping windows are averaged."""
    B, H, W, _ = image.shape
    out = image.new_zeros((B, H, W, num_classes))
    cnt = image.new_zeros((B, H, W, 1))
    ys = list(range(0, max(H - window, 0) + 1, stride)) or [0]
    xs = list(range(0, max(W - window, 0) + 1, stride)) or [0]
    if ys[-1] != H - window:
        ys.append(H - window)
    if xs[-1] != W - window:
        xs.append(W - window)
    for y0 in ys:
        for x0 in xs:
            out[:, y0:y0 + window, x0:x0 + window] += fwd(
                image[:, y0:y0 + window, x0:x0 + window])
            cnt[:, y0:y0 + window, x0:x0 + window] += 1.0
    return out / cnt.clamp(min=1.0)
