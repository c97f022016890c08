"""The reference eval scripts' models as entry points of their own, each
`train_seg` with `--model` set and the script's defaults:

    python -m adaptersis_tpu_torch.eval.eval_dinov2_setr ...
    python -m adaptersis_tpu_torch.eval.eval_dinov2_unet ...
    python -m adaptersis_tpu_torch.eval.eval_dinov2_or_unet_fuse ...
    python -m adaptersis_tpu_torch.eval.eval_dinov2_masktrans ...        (--imsize 392)
    python -m adaptersis_tpu_torch.eval.eval_dinov2_masktrans_inov ...   (588, the dice loss, /255 inputs)
    python -m adaptersis_tpu_torch.eval.eval_dinov2_setr_cross_ete ...   (trains the backbone)
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .. import train_seg


def parse_args(model: str, defaults: Optional[Dict[str, object]] = None,
               fixed: Optional[Dict[str, object]] = None, argv: Optional[List[str]] = None):
    """`train_seg`'s flags with `--model` set to `model`, each of `defaults`
    taken where its flag is left at train_seg's default, and `fixed` set as
    it is (`keep_loss`, `input_norm`: what `train_seg.run` reads besides the
    flags)."""
    parser = train_seg.get_args_parser()
    args = parser.parse_args(argv)
    args.model = model
    for k, v in (defaults or {}).items():
        if getattr(args, k) == parser.get_default(k):
            setattr(args, k, v)
    for k, v in (fixed or {}).items():
        setattr(args, k, v)
    return args


def run(model: str, defaults: Optional[Dict[str, object]] = None,
        fixed: Optional[Dict[str, object]] = None,
        argv: Optional[List[str]] = None) -> List[dict]:
    return train_seg.run(parse_args(model, defaults, fixed, argv))[1]
