"""The DINOv2 SSL meta-architecture (counterpart of the JAX package's
`ssl/meta_arch.py`): a student and an EMA teacher, each a backbone and a
DINO head, trained with the DINO, iBOT and KoLeo losses and AdamW.

One `train_step`, in the JAX step's order:
  1. the teacher's forward over the global crops, under no_grad;
  2. the centred, sharpened teacher targets (DINO on the cls token, iBOT on
     the gathered masked patch tokens);
  3. the student's forward: the global crops (with the iBOT mask tokens)
     and the local crops packed into one attention call per block;
  4. the losses: DINO cross-view between the global crops plus each local
     crop against both teacher globals, iBOT on the masked rows, KoLeo on
     each half of the student's global cls tokens;
  5. the backward;
  6. the update: Adam's moments (β 0.9/0.999, eps 1e-8, optax's
     scale_by_adam), then p ← p − lr·m·u − lr·m·wd·p with the scheduled lr,
     weight decay and last-layer lr, the layerwise lr-decay multiplier m and
     the weight-decay mask;
  7. the teacher's EMA toward the NEW student;
  8. the DINO centre from the teacher's raw head output;
  9. the iBOT centre over the masked rows.

Precision: parameters, Adam's moments, the heads and the losses are fp32;
with `bf16` the backbones run under `torch.autocast(bf16)`, as the JAX
package's SSL benchmark runs a bf16 backbone with fp32 parameters and heads.
The gradients stay in the student's `.grad` until the next step. The step
takes the gathered-mask form (`MaskInfo`, as the JAX package's entry points
run it) or the bool-mask form (a (2B, N) bool tensor: the iBOT head on
every patch token, `gathered=False` of the JAX step); the crops packed
(`packed_crops`), the iBOT loss on the DINO head (`ibot_separate_head`
off).

Data parallelism (`shard`): every rank starts from rank 0's weights. With
an "fsdp" axis of more than one rank, the student's and the teacher's
backbones and heads go through FSDP2 on the ("data", "fsdp") mesh, which
averages the student's gradients; Adam and the EMA run on each rank's
shards (student and teacher are sharded alike). At `--fsdp 1` (the (W, 1)
mesh, which replicates) the modules stay whole and the student's
gradients are averaged by one flat all-reduce, as the segmentation
trainer's: FSDP2 over shard groups of one rank would copy every block's
parameters at every forward for nothing. Each rank's loss is the mean over
its own rows, so the mean of the ranks' gradients is the global batch's;
KoLeo runs on the student cls tokens of every rank, gathered with their
gradient; the centres and the iBOT masked count are global sums
(`ssl/losses.py`). The returned losses are the ranks' mean.
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..models.vit import DinoVisionTransformer
from ..parallel.dist import (all_gather_with_grad, all_reduce_mean, average_gradients,
                             get_world_size)
from ..parallel.mesh import (TRAINED_METHODS, broadcast_module, fsdp_shard, full_tree,
                             gather_like, local, local_like, reshard, shard_like)
from .heads import DINOHead
from .losses import (dino_loss, ibot_patch_loss, ibot_patch_loss_masked, koleo_loss,
                     softmax_center_teacher, update_center, update_center_bool,
                     update_center_masked)
from .masking import MaskInfo


@dataclass
class SSLConfig:
    dino_out_dim: int = 65536
    ibot_out_dim: int = 65536
    head_hidden_dim: int = 2048
    head_bottleneck_dim: int = 256
    student_temp: float = 0.1
    center_momentum: float = 0.9
    dino_loss_weight: float = 1.0
    ibot_loss_weight: float = 1.0
    koleo_loss_weight: float = 0.1
    n_local_crops: int = 8
    adamw_beta1: float = 0.9
    adamw_beta2: float = 0.999
    layerwise_decay: float = 0.9
    patch_embed_lr_mult: float = 0.2


ADAM_EPS = 1e-8


class DeviceMasks(NamedTuple):
    """`MaskInfo` as tensors on the step's device."""

    masks: torch.Tensor     # (B2, N) bool
    indices: torch.Tensor   # (U,) int64
    weights: torch.Tensor   # (U,) fp32
    n_masked: torch.Tensor  # () int32


def masks_to(info: MaskInfo, device: torch.device) -> DeviceMasks:
    def put(a, dtype):
        t = torch.as_tensor(np.asarray(a)).to(dtype)
        return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t

    return DeviceMasks(put(info.masks, torch.bool), put(info.indices, torch.int64),
                       put(info.weights, torch.float32), put(info.n_masked, torch.int32))


def lr_multiplier(name: str, depth: int, decay: float, patch_embed_lr_mult: float) -> float:
    """Layerwise lr decay of a student parameter (names relative to the
    student): block i → decay^(depth − i); the patch embedding and the
    tokens → decay^(depth + 1), the patch embedding × patch_embed_lr_mult;
    everything else (the final norm, the heads) → 1."""
    if not name.startswith("backbone."):
        return 1.0
    if any(t in name for t in ("patch_embed", "cls_token", "pos_embed", "mask_token")):
        return decay ** (depth + 1) * (patch_embed_lr_mult if "patch_embed" in name else 1.0)
    for i in range(depth):
        if f"blocks.{i}." in name:
            return decay ** (depth - i)
    return 1.0


def decays(name: str, p: torch.Tensor) -> bool:
    """Weight decay applies to matrices and kernels, not to biases, norms,
    LayerScale, the tokens, the positional embedding or the weight norm's g."""
    banned = ("bias", "norm", "gamma", "cls_token", "pos_embed", "mask_token", "last_layer_g")
    return p.dim() > 1 and not any(t in name for t in banned)


class SSLMetaArch(nn.Module):
    def __init__(self, backbone: DinoVisionTransformer, cfg: SSLConfig = SSLConfig(),
                 bf16: bool = False):
        super().__init__()
        self.cfg, self.bf16 = cfg, bf16
        E = backbone.embed_dim
        self.student = nn.ModuleDict({
            "backbone": backbone,
            "dino_head": DINOHead(E, cfg.dino_out_dim, cfg.head_hidden_dim,
                                  cfg.head_bottleneck_dim)})
        self.teacher = copy.deepcopy(self.student).requires_grad_(False)
        self.register_buffer("dino_center", torch.zeros(1, cfg.dino_out_dim))
        self.register_buffer("ibot_center", torch.zeros(1, 1, cfg.ibot_out_dim))
        self.replicated = False             # whole modules over several ranks (`shard`)
        self.step = 0                       # Adam's count
        self.mu: List[torch.Tensor] = []    # Adam's moments, made at the first step
        self.nu: List[torch.Tensor] = []

    # ---- data parallelism ----

    def shard(self, mesh) -> "SSLMetaArch":
        """Rank 0's weights on every rank, then, when `mesh`'s "fsdp" axis has
        more than one rank, FSDP2 over it for both branches' backbones and
        heads; a no-op without a mesh."""
        if mesh is None:
            return self
        broadcast_module(self)
        self.replicated = mesh["fsdp"].size() == 1
        if not self.replicated:
            for branch in (self.student, self.teacher):
                fsdp_shard(branch["backbone"], mesh, TRAINED_METHODS)
                fsdp_shard(branch["dino_head"], mesh, methods=())
        return self

    def _student_params(self) -> List[torch.Tensor]:
        return [p for _, p in self.student.named_parameters()]

    # ---- checkpoints ----

    def checkpoint_state(self) -> dict:
        """Everything a resumed run reads: the student, the teacher, both
        centres, Adam's moments and count, as whole tensors (a collective:
        every rank calls it), so the file does not depend on the world
        size."""
        params = self._student_params()
        return {"model": full_tree(self.state_dict()), "step": self.step,
                "mu": [gather_like(m, p) for m, p in zip(self.mu, params)],
                "nu": [gather_like(v, p) for v, p in zip(self.nu, params)]}

    def load_checkpoint_state(self, state: dict) -> None:
        live = self.state_dict()
        self.load_state_dict({k: shard_like(v, live[k]) for k, v in state["model"].items()})
        self.step = int(state["step"])
        params = self._student_params()
        self.mu = [local_like(m, p) for m, p in zip(state["mu"], params)]
        self.nu = [local_like(v, p) for v, p in zip(state["nu"], params)]

    # ---- parameter plumbing ----

    def lr_multipliers(self) -> Dict[str, float]:
        cfg, depth = self.cfg, self.student["backbone"].depth
        return {n: lr_multiplier(n, depth, cfg.layerwise_decay, cfg.patch_embed_lr_mult)
                for n, _ in self.student.named_parameters()}

    def autocast(self, device: torch.device):
        if not self.bf16:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=torch.bfloat16)

    # ---- forward pieces ----

    @staticmethod
    def _head(branch: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
        """The DINO head (DINO and iBOT share it) in fp32, outside autocast."""
        with torch.autocast(x.device.type, enabled=False):
            return branch["dino_head"](x.float())

    @staticmethod
    def _gather(patch_tokens: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        return patch_tokens.reshape(-1, patch_tokens.shape[-1]).index_select(0, indices)

    # ---- the train step ----

    def train_step(self, global_crops: torch.Tensor, local_crops: torch.Tensor,
                   masks: Union[DeviceMasks, torch.Tensor], lr: float, wd: float,
                   momentum: float, teacher_temp: float,
                   last_layer_lr: float) -> Dict[str, torch.Tensor]:
        """global_crops (2B, S, S, 3), local_crops (n·B, s, s, 3), masks on
        the same device: `DeviceMasks` (the gathered form) or a (2B, N) bool
        tensor (the bool-mask form). Returns the total loss and its parts
        as device tensors; nothing in the step waits for the device."""
        cfg, dev = self.cfg, global_crops.device
        B2 = global_crops.shape[0]
        gathered = isinstance(masks, DeviceMasks)
        masks_bool = masks.masks if gathered else masks
        self.train()
        # before the forward: under FSDP2 a root module's parameters stay
        # whole after it, so a module-wise zero_grad then would miss the
        # shards' gradients, which the next backward adds to
        self.student.zero_grad(set_to_none=True)

        def ibot_tokens(patch_tokens):
            return self._gather(patch_tokens, masks.indices) if gathered else patch_tokens

        with torch.no_grad():
            with self.autocast(dev):
                t_out = self.teacher["backbone"].forward_with_masks(global_crops)
            t_dino = self._head(self.teacher, t_out["x_norm_clstoken"])
            t_dino_sm = softmax_center_teacher(t_dino, self.dino_center, teacher_temp)
            t_ibot = self._head(self.teacher, ibot_tokens(t_out["x_norm_patchtokens"]))
            t_ibot_sm = softmax_center_teacher(
                t_ibot, self.ibot_center[0] if gathered else self.ibot_center, teacher_temp)
        if get_world_size() > 1 and not self.replicated:
            reshard(self.teacher)

        n_loc = local_crops.shape[0]
        if not n_loc or n_loc % B2:
            raise ValueError(f"{n_loc} local crops do not pack onto {B2} global crops")
        with self.autocast(dev):
            s_out, l_out = self.student["backbone"].forward_packed_crops(
                global_crops, local_crops, masks=masks_bool)
        s_cls = s_out["x_norm_clstoken"]
        s_dino_g = self._head(self.student, s_cls)
        s_dino_l = self._head(self.student, l_out["x_norm_clstoken"])
        g1, g2 = s_dino_g.chunk(2)
        t1, t2 = t_dino_sm.chunk(2)
        n_local = max(cfg.n_local_crops, 1)
        # the global crops cross-view only; each local crop against both
        loss_dino = (dino_loss([g1], [t2], cfg.student_temp)
                     + dino_loss([g2], [t1], cfg.student_temp)) / 2.0
        loss_dino = loss_dino + dino_loss(list(s_dino_l.chunk(n_local)), [t1, t2],
                                          cfg.student_temp) / (2 * n_local)
        s_ibot = self._head(self.student, ibot_tokens(s_out["x_norm_patchtokens"]))
        if gathered:
            loss_ibot = ibot_patch_loss_masked(s_ibot, t_ibot_sm, masks.weights, B2,
                                               cfg.student_temp)
        else:
            loss_ibot = ibot_patch_loss(s_ibot, t_ibot_sm, masks_bool, cfg.student_temp)
        loss_koleo = sum(koleo_loss(c) for c in global_cls_per_crop(s_cls))
        total = (cfg.dino_loss_weight * loss_dino + cfg.ibot_loss_weight * loss_ibot
                 + cfg.koleo_loss_weight * loss_koleo)

        total.backward()
        with torch.no_grad():
            if self.replicated:
                average_gradients(self._student_params())
            elif get_world_size() > 1:
                reshard(self.student)
            self.optimizer_step(lr, wd, last_layer_lr)
            self.update_teacher(momentum)
            self.dino_center.copy_(update_center(self.dino_center, t_dino, cfg.center_momentum))
            if gathered:
                self.ibot_center.copy_(update_center_masked(
                    self.ibot_center[0], t_ibot, masks.weights, masks.n_masked,
                    cfg.center_momentum)[None])
            else:
                self.ibot_center.copy_(update_center_bool(
                    self.ibot_center[0], t_ibot, masks_bool, cfg.center_momentum)[None])
        losses = torch.stack([total.detach(), loss_dino.detach(), loss_ibot.detach(),
                              loss_koleo.detach()])
        if get_world_size() > 1:
            losses = all_reduce_mean(losses)
        return dict(zip(("total_loss", "dino", "ibot", "koleo"), losses.unbind()))

    @torch.no_grad()
    def optimizer_step(self, lr: float, wd: float, last_layer_lr: float) -> None:
        """Adam's moments from the student's `.grad` (a parameter without one
        takes a zero gradient, as in optax), then the decoupled update, in
        fp32 with the optax chain's order of operations, on this rank's
        shards."""
        cfg = self.cfg
        named = list(self.student.named_parameters())
        params = [local(p) for _, p in named]
        grads = [local(p.grad) if p.grad is not None else torch.zeros_like(q)
                 for (_, p), q in zip(named, params)]
        if not self.mu:
            self.mu = [torch.zeros_like(p) for p in params]
            self.nu = [torch.zeros_like(p) for p in params]
        mus, nus = self.mu, self.nu
        b1, b2 = cfg.adamw_beta1, cfg.adamw_beta2
        self.step += 1
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(self.step))
        bc2 = float(f32(1) - f32(b2) ** f32(self.step))
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        u = torch._foreach_div(torch._foreach_div(mus, bc1), denom)
        mults = self.lr_multipliers()
        step_lr, decay = [], []
        for name, p in named:
            eff = f32(last_layer_lr if "last_layer" in name else lr) * f32(mults[name])
            step_lr.append(float(eff))
            decay.append(float(eff * f32(wd)) if decays(name, p) else 0.0)
        shrink = torch._foreach_mul(params, decay)
        torch._foreach_sub_(params, torch._foreach_mul(u, step_lr))
        torch._foreach_sub_(params, shrink)

    @torch.no_grad()
    def update_teacher(self, momentum: float) -> None:
        """t ← t·m + s·(1 − m), from the current (updated) student, shard by
        shard."""
        m = np.float32(momentum)
        t = [local(p) for _, p in self.teacher.named_parameters()]
        s = [local(p) for _, p in self.student.named_parameters()]
        torch._foreach_mul_(t, float(m))
        torch._foreach_add_(t, torch._foreach_mul(s, float(np.float32(1) - m)))


def global_cls_per_crop(s_cls: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The student's global-crop cls tokens (2B, E), [crop 0 of the rank's B
    images; crop 1 of them], as the two crops of the whole batch: every
    rank's rows gathered with their gradient and put in the order of the
    JAX package's global stack (image i of rank r is image i·W + r), then
    split by crop. KoLeo is invariant to the order of the rows within a
    crop, not across crops. One process: `s_cls.chunk(2)`."""
    W = get_world_size()
    if W == 1:
        return s_cls.chunk(2)
    stack = all_gather_with_grad(s_cls)                       # (W, 2B, E)
    B = s_cls.shape[0] // 2
    crops = stack.reshape(W, 2, B, -1).permute(1, 2, 0, 3)    # (2, B, W, E)
    return tuple(crops.reshape(2, B * W, -1).unbind())


def schedule_values(schedules: Dict[str, Sequence[float]], it: int) -> Dict[str, float]:
    """The five scheduled values of iteration `it`."""
    return {k: float(schedules[k][it])
            for k in ("lr", "wd", "momentum", "teacher_temp", "last_layer_lr")}
