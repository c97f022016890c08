"""`python -m adaptersis_tpu_torch.eval.eval_dinov2_masktrans_inov`: `train_seg` with
`--model tap_masktrans`, the mask transformer at 588 px trained
with the dice loss alone on /255 inputs, as the reference's
eval_dinov2_masktrans_inov.py does (its Normalize is commented out). The
JAX package's wrapper of the same name passes "dc", which its train.py then
replaces by the mask transformer's loss, and normalises the inputs: the
port follows the reference script."""

from typing import List, Optional

from . import run

MODEL = "tap_masktrans"
DEFAULTS = {"imsize": 588, "loss": "dc"}
FIXED = {"keep_loss": True, "input_norm": "none"}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    return run(MODEL, DEFAULTS, FIXED, argv)


if __name__ == "__main__":
    main()
