"""`python -m adaptersis_tpu_torch.eval.eval_dinov2_masktrans`: `train_seg` with
`--model tap_masktrans`, the mask transformer
(Segmenter) head at 392 px, weighted CE + argmax dice, ImageNet-normalised
inputs."""

from typing import List, Optional

from . import run

MODEL = "tap_masktrans"
DEFAULTS = {"imsize": 392}
FIXED = {}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    return run(MODEL, DEFAULTS, FIXED, argv)


if __name__ == "__main__":
    main()
