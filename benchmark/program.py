"""The system under test, `adaptersis_tpu_torch`, as a configuration file
describes it: the only module of the benchmark, with the drivers and
probes, that imports the program, and it imports it inside functions.

The model is built on the card and loaded strictly with the benchmark's
seeded weights; training runs through the program's `Trainer` (SGD,
on-device augmentation, bf16 autocast where the configuration says so),
serving through its `cast_for_inference` model.
"""

from __future__ import annotations

from typing import Dict

import torch


def build_model(cfg: dict, weights: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    from adaptersis_tpu_torch.models.segmentor import AdapterSegmentor
    from adaptersis_tpu_torch.models.vit import build_backbone

    with torch.device(device):
        backbone = build_backbone(cfg["arch"], img_size=cfg["pos_embed_img_size"],
                                  patch_size=cfg["patch_size"], gelu_approx=cfg["gelu"] == "tanh")
        got = (backbone.embed_dim, backbone.depth, backbone.blocks[0].attn.num_heads)
        want = (cfg["embed_dim"], cfg["depth"], cfg["num_heads"])
        if got != want:
            raise ValueError(f"arch {cfg['arch']!r} has (width, depth, heads) {got}, "
                             f"the configuration {want}")
        model = AdapterSegmentor(backbone, num_classes=cfg["num_classes"],
                                 n_last_blocks=cfg["n_last_blocks"],
                                 adapter_num_heads=cfg["adapter_num_heads"],
                                 adapter_n_points=cfg["adapter_n_points"],
                                 encoder_inplanes=cfg["encoder_inplanes"],
                                 decoder_features=cfg["decoder_features"])
    model.load_state_dict(weights, strict=True)
    return model


def trainer(cfg: dict, model: torch.nn.Module):
    from adaptersis_tpu_torch.train.trainer import MOMENTUM, WEIGHT_DECAY, Trainer

    if (MOMENTUM, WEIGHT_DECAY) != (cfg["momentum"], cfg["weight_decay"]):
        raise ValueError(f"the program's SGD has momentum {MOMENTUM} and weight decay "
                         f"{WEIGHT_DECAY}, the configuration {cfg['momentum']} and "
                         f"{cfg['weight_decay']}")
    return Trainer(model, lr=cfg["lr"], epochs=cfg["epochs"], bf16=cfg["precision"] == "bf16",
                   loss=cfg["loss"], softmax=True)


def serving_model(cfg: dict, model: torch.nn.Module) -> torch.nn.Module:
    from adaptersis_tpu_torch.train.trainer import cast_for_inference

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[cfg["precision"]]
    return cast_for_inference(model, dtype).eval()


def trainer_module():
    """The module whose `apply_train_augment` the trainer calls."""
    from adaptersis_tpu_torch.train import trainer as mod
    return mod


def load_kernels(device) -> None:
    """Build (the first time in a checkout) and load the program's kernel
    library, which its first kernel call would do: set-up, timed apart."""
    if torch.device(device).type == "cuda":
        from adaptersis_tpu_torch.ops import _build
        _build.library()
