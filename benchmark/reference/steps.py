"""The reference's train steps and its serving forward, and the numbers
that compare the program with it.

Train: AdapterSIS's step, plainly: augment → forward with BatchNorm in
training mode → DC loss of softmax(logits) (the DC loss softmaxes again:
AdapterSIS's train.py feeds it probabilities) → backward → torch's SGD
(momentum 0.99, weight decay 3e-5, lr of the cosine schedule's first
epoch) on everything but the frozen backbone, a trainable that reaches no
output stepping on a zero gradient.

The numbers compared, each a relative gap (of the parameters' and statistics'
norms leaf by leaf, never the norm of their difference):
  * `loss_gap`: the largest |L_program − L_ref| / |L_ref| over the steps;
  * `grad1_gap`: the first gradient as the optimizer gets it, worked out
    from its state after one step (momentum buffer − weight decay · p0),
    compared by norm, leaf by leaf: the largest
    |‖g_program‖ − ‖g_ref‖| / max(‖g_ref‖, the median leaf's ‖g_ref‖);
  * `delta3_gap`: the same of each leaf's change after the steps, p − p0;
  * `bnstat3_gap`: the same of each BatchNorm running statistic's change
    after the steps (a training-mode forward never reads them; evaluation
    and serving of the trained model do);
  * `walk1_gap`: the frozen clean walk of the first step, its last block's
    output, as ‖program − reference‖ / ‖reference‖. The reference runs its
    patch embedding in TF32, as the configuration states its convolutions
    (`conv_precision`), so what is left is the walk's products: this is the
    number that TF32 products in the walk fail.
Leaves whose reference gradient is nought to rounding (under a thousandth
of the median leaf's, as a conv bias before a training-mode BatchNorm
is) move by round-off alone, and are left out of `grad1_gap` and
`delta3_gap` by that rule.

Serve: `margin_gap`, the widest reference margin (its best logit less the
logit of the class served) over the served pixels, in units of the
root-mean-square margin between the reference's best two logits.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from .augment import apply_train_augment
from .model import Segmentor
from .precision import FP32, precision_flags

TRAINED_OUT = "backbone."
IGNORE_BELOW = 1e-3
STATS = ("running_mean", "running_var")


def bn_stats(named_buffers) -> Dict[str, torch.Tensor]:
    """The BatchNorm running statistics among a module's buffers."""
    return {n: b for n, b in named_buffers if n.rsplit(".", 1)[-1] in STATS}


def dc_loss(probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """nnU-Net's DC loss as AdapterSIS trains with it: softmax over the
    classes, per-(image, class) dice over the pixels, 1 − the mean."""
    p = torch.softmax(probs, dim=-1)
    y = torch.nn.functional.one_hot(target.long(), p.shape[-1]).to(p.dtype)
    inter = (p * y).sum(dim=(1, 2))
    dice = 2 * inter / (p.sum(dim=(1, 2)) + y.sum(dim=(1, 2)) + 10e-20)
    return 1.0 - dice.mean()


def load(cfg: dict, weights: Dict[str, torch.Tensor], device) -> Segmentor:
    with torch.device(device):
        model = Segmentor(cfg)
    model.load_state_dict(weights, strict=True)
    return model


def train_steps(cfg: dict, weights: Dict[str, torch.Tensor],
                batches: Iterable[Tuple[torch.Tensor, torch.Tensor, dict]],
                prec=FP32(), rows: slice = slice(None), update: bool = True) -> dict:
    """Run the steps on (uint8 images, masks, draws) batches, the rows
    `rows` of each (all of them, unless a fault leaves some out), and with
    `update` False a step that leaves its state unchanged (a fault). Returns
    the losses, per trained leaf the norm of the first gradient and of the
    change after the last step, the same change of each BatchNorm running
    statistic, and the first step's clean walk."""
    device = weights["level_embed"].device
    model = load(cfg, weights, device)
    model.backbone.requires_grad_(False)
    named = [(n, p) for n, p in model.named_parameters() if not n.startswith(TRAINED_OUT)]
    opt = torch.optim.SGD([p for _, p in named], lr=cfg["lr"], momentum=cfg["momentum"],
                          weight_decay=cfg["weight_decay"])
    losses: List[float] = []
    grad1: Dict[str, float] = {}
    with precision_flags(prec):
        for i, (images, masks, draws) in enumerate(batches):
            d = {k: v[rows] for k, v in draws.items()}
            x, m = apply_train_augment(images[rows], masks[rows], d)
            if i == 0:
                walk1 = model.clean_walk(x, prec, cfg["conv_precision"] == "tf32")
            logits = model(x, prec, training=True)
            loss = dc_loss(torch.softmax(logits, dim=-1), m)
            opt.zero_grad(set_to_none=True)
            if update:
                loss.backward()
                for _, p in named:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                opt.step()
            losses.append(float(loss.detach()))
            del logits, loss, x, m
            if i == 0:
                wd = cfg["weight_decay"]
                grad1 = {n: float((opt.state.get(p, {}).get("momentum_buffer", torch.zeros_like(p))
                                   - wd * weights[n]).norm()) for n, p in named}
    delta = {n: float((p.detach() - weights[n]).norm()) for n, p in named}
    stats = {n: float((b - weights[n]).norm()) for n, b in bn_stats(model.named_buffers()).items()}
    return {"losses": losses, "grad1": grad1, "delta": delta, "stats": stats, "walk1": walk1}


def leaf_gaps(program: Dict[str, float], ref: Dict[str, float],
              kept: Sequence[str]) -> List[Tuple[float, str]]:
    """The gap of norms of each kept leaf, against the larger of its own
    reference norm and the median leaf's, largest first."""
    med = statistics.median(ref[n] for n in kept)
    return sorted(((abs(program[n] - ref[n]) / max(ref[n], med), n) for n in kept),
                  reverse=True)


def leaf_gap(program: Dict[str, float], ref: Dict[str, float], kept: Sequence[str]) -> float:
    return leaf_gaps(program, ref, kept)[0][0]


def kept_leaves(ref_grad1: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad1.values())
    return [n for n, g in ref_grad1.items() if g >= IGNORE_BELOW * med]


def train_numbers(program: dict, ref: dict) -> Dict[str, float]:
    kept = kept_leaves(ref["grad1"])
    gaps = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
            for a, b in zip(program["losses"], ref["losses"])]
    return {"loss_gap": max(gaps),
            "grad1_gap": leaf_gap(program["grad1"], ref["grad1"], kept),
            "delta3_gap": leaf_gap(program["delta"], ref["delta"], kept),
            "bnstat3_gap": leaf_gap(program["stats"], ref["stats"], list(ref["stats"])),
            "walk1_gap": walk_gap(program["walk1"], ref["walk1"])}


def walk_gap(program: torch.Tensor, ref: torch.Tensor) -> float:
    """‖program − reference‖ / ‖reference‖ of a walk's output; a walk of
    another shape (rows left out) is as far off as can be."""
    if program.shape != ref.shape:
        return math.inf
    ref = ref.float()
    return float((program.to(ref.device).float() - ref).norm() / ref.norm())


def train_look(program: dict, ref: dict) -> dict:
    """What lies under the train numbers: the median leaf's gaps and the
    three worst leaves of each (for `calibrate.py`, not compared)."""
    kept = kept_leaves(ref["grad1"])
    out = {"losses": [abs(a - b) / abs(b) for a, b in zip(program["losses"], ref["losses"])]}
    for key in ("grad1", "delta", "stats"):
        gaps = leaf_gaps(program[key], ref[key], kept if key != "stats" else list(ref[key]))
        out[f"{key}_median_gap"] = statistics.median(g for g, _ in gaps)
        out[f"{key}_worst"] = [[n, g] for g, n in gaps[:3]]
    return out


@torch.no_grad()
def serve_logits(model: Segmentor, frames_u8: torch.Tensor, prec=FP32(),
                 block: int = 4) -> torch.Tensor:
    """fp32 logits (N, S, S, C) of uint8 frames, `block` frames at a time
    (eval mode: every frame on its own)."""
    with precision_flags(prec):
        return torch.cat([model(frames_u8[i:i + block].float() / 255.0, prec, training=False)
                          for i in range(0, frames_u8.shape[0], block)])


def margin_gap(served: torch.Tensor, ref_logits: torch.Tensor) -> float:
    """served (N, S, S) class ids; ref_logits (N, S, S, C)."""
    top2 = ref_logits.topk(2, dim=-1).values
    scale = float((top2[..., 0] - top2[..., 1]).square().mean().sqrt())
    chosen = ref_logits.gather(-1, served.long()[..., None])[..., 0]
    return float((top2[..., 0] - chosen).max()) / scale
