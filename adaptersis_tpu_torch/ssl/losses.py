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
  * `koleo_loss`: −log of the distance to the nearest neighbour.
`sinkhorn_knopp` is not ported: no entry point of the JAX package calls it."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def softmax_center_teacher(teacher_output: torch.Tensor, center: torch.Tensor,
                           teacher_temp: float) -> torch.Tensor:
    return torch.softmax((teacher_output - center) / teacher_temp, dim=-1)


def update_center(center: torch.Tensor, teacher_output: torch.Tensor,
                  momentum: float = 0.9) -> torch.Tensor:
    batch_center = teacher_output.reshape(-1, teacher_output.shape[-1]).mean(dim=0, keepdim=True)
    return center * momentum + batch_center * (1 - momentum)


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
    bc = bc / torch.as_tensor(n_masked, dtype=torch.float32, device=bc.device).clamp(min=1.0)
    return center * momentum + bc * (1 - momentum)


def koleo_loss(student_output: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    x = student_output.float()
    x = x / x.norm(dim=-1, keepdim=True).clamp(min=eps)
    n = x.shape[0]
    # exclude each row itself (the reference fills the diagonal with −1)
    dots = x @ x.t() - 2.0 * torch.eye(n, device=x.device)
    nn_idx = dots.argmax(dim=1)
    d = (x - x[nn_idx]).norm(dim=-1)
    return -torch.log(d + eps).mean()
