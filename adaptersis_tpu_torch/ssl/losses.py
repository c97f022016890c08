"""The SSL losses and centres (counterpart of the JAX package's
`ssl/losses.py`), in fp32:
  * `softmax_center_teacher`, `update_center`: the teacher targets
    softmax((t − c)/τ) and the EMA of the batch mean;
  * `dino_loss`: Σ over (student crop, teacher crop) pairs of
    −⟨t, log_softmax(s/τ)⟩, each pair's mean over the batch;
  * `ibot_patch_loss` (full-tensor form) and `ibot_patch_loss_masked` (on
    gathered masked rows), with weights 1/n_masked per sample and the crop
    count as denominator; `update_center_masked`, the iBOT centre over the
    masked rows only;
  * `sinkhorn_knopp`: the 3-iteration optimal-transport teacher targets;
  * `koleo_loss`: −log of the distance to the nearest neighbour.
With several ranks the batch quantities are the global batch's, as under
the JAX package's mesh: the centres all-reduce their sums and counts,
`sinkhorn_knopp` its sums and its count (upstream's `dist.all_reduce`);
`koleo_loss` is called on rows gathered from every rank
(`ssl/meta_arch.py`). A single process computes what it always did."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..parallel.dist import all_reduce_sum, get_world_size


def softmax_center_teacher(teacher_output: torch.Tensor, center: torch.Tensor,
                           teacher_temp: float) -> torch.Tensor:
    return torch.softmax((teacher_output - center) / teacher_temp, dim=-1)


def update_center(center: torch.Tensor, teacher_output: torch.Tensor,
                  momentum: float = 0.9) -> torch.Tensor:
    flat = teacher_output.reshape(-1, teacher_output.shape[-1])
    if get_world_size() == 1:
        batch_center = flat.mean(dim=0, keepdim=True)
    else:
        sums = all_reduce_sum(torch.cat([flat.float().sum(dim=0),
                                         flat.new_full((1,), float(flat.shape[0]))]))
        batch_center = (sums[:-1] / sums[-1])[None]
    return center * momentum + batch_center * (1 - momentum)


@torch.no_grad()
def sinkhorn_knopp(teacher_output: torch.Tensor, teacher_temp: float,
                   n_iterations: int = 3) -> torch.Tensor:
    """Sinkhorn-Knopp teacher targets (B, K) of (B, K) logits: Q = exp(t/τ)ᵀ
    normalised to sum 1, then rows to 1/K and columns to 1/B in turn; Σ Q,
    the row sums and B are the global batch's."""
    Q = torch.exp(teacher_output.float() / teacher_temp).t()         # (K, B)
    K = Q.shape[0]
    B = all_reduce_sum(Q.new_full((1,), float(Q.shape[1])))
    Q = Q / all_reduce_sum(Q.sum().reshape(1))
    for _ in range(n_iterations):
        Q = Q / all_reduce_sum(Q.sum(dim=1, keepdim=True))
        Q = Q / K
        Q = Q / Q.sum(dim=0, keepdim=True)
        Q = Q / B
    return (Q * B).t()


def dino_loss(student_output_list: Sequence[torch.Tensor],
              teacher_out_softmaxed_centered_list: Sequence[torch.Tensor],
              student_temp: float = 0.1) -> torch.Tensor:
    total = 0.0
    for s in student_output_list:
        lsm = F.log_softmax(s.float() / student_temp, dim=-1)
        for t in teacher_out_softmaxed_centered_list:
            total = total - (t * lsm).sum(dim=-1).mean()
    return total


def ibot_patch_loss(student_patch_tokens: torch.Tensor, teacher_softmaxed: torch.Tensor,
                    mask: torch.Tensor, student_temp: float = 0.1) -> torch.Tensor:
    """(B, N, K) logits and targets, (B, N) bool masked positions."""
    lsm = F.log_softmax(student_patch_tokens.float() / student_temp, dim=-1)
    per_token = -(teacher_softmaxed * lsm).sum(dim=-1)
    m = mask.float()
    per_sample_w = 1.0 / m.sum(dim=1, keepdim=True).clamp(min=1.0)
    return (per_token * m * per_sample_w).sum() / mask.shape[0]


def ibot_patch_loss_masked(student_masked: torch.Tensor, teacher_softmaxed: torch.Tensor,
                           weights: torch.Tensor, n_crops: int,
                           student_temp: float = 0.1) -> torch.Tensor:
    """(U, K) gathered logits and targets, (U,) weights 1/n_masked of the
    row's sample (0 on padding rows)."""
    lsm = F.log_softmax(student_masked.float() / student_temp, dim=-1)
    per_token = -(teacher_softmaxed * lsm).sum(dim=-1)
    return (per_token * weights).sum() / n_crops


def update_center_masked(center: torch.Tensor, teacher_masked: torch.Tensor,
                         weights: torch.Tensor, n_masked: torch.Tensor,
                         momentum: float = 0.9) -> torch.Tensor:
    valid = (weights > 0).float()[:, None]
    bc = (teacher_masked.float() * valid).sum(dim=0, keepdim=True)
    count = torch.as_tensor(n_masked, dtype=torch.float32, device=bc.device).reshape(1)
    if get_world_size() > 1:
        sums = all_reduce_sum(torch.cat([bc[0], count]))
        bc, count = sums[None, :-1], sums[-1:]
    bc = bc / count.clamp(min=1.0)
    return center * momentum + bc * (1 - momentum)


def update_center_bool(center: torch.Tensor, teacher_patch: torch.Tensor, mask: torch.Tensor,
                       momentum: float = 0.9) -> torch.Tensor:
    """The iBOT centre of the bool-mask step: the mean of the (B, N, K)
    teacher outputs over the masked positions of (B, N) `mask`, global."""
    m = mask.float()[..., None]
    bc = (teacher_patch.float() * m).sum(dim=(0, 1))
    count = m.sum().reshape(1)
    if get_world_size() > 1:
        sums = all_reduce_sum(torch.cat([bc, count]))
        bc, count = sums[:-1], sums[-1:]
    return center * momentum + (bc / count.clamp(min=1.0))[None] * (1 - momentum)


def koleo_loss(student_output: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    x = student_output.float()
    x = x / x.norm(dim=-1, keepdim=True).clamp(min=eps)
    n = x.shape[0]
    # exclude each row itself (the reference fills the diagonal with −1)
    dots = x @ x.t() - 2.0 * torch.eye(n, device=x.device)
    nn_idx = dots.argmax(dim=1)
    d = (x - x[nn_idx]).norm(dim=-1)
    return -torch.log(d + eps).mean()
