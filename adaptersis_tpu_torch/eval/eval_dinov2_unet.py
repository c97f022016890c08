"""`python -m adaptersis_tpu_torch.eval.eval_dinov2_unet`: `train_seg` with
`--model tap_unet`, the truncated feature-space UNet on the
last block's tokens, CE + DC."""

from typing import List, Optional

from . import run

MODEL = "tap_unet"
DEFAULTS = {}
FIXED = {}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    return run(MODEL, DEFAULTS, FIXED, argv)


if __name__ == "__main__":
    main()
