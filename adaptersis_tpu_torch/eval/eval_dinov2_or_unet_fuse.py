"""`python -m adaptersis_tpu_torch.eval.eval_dinov2_or_unet_fuse`: `train_seg` with
`--model tap_unet_fuse`, a full-image UNet fed the last
block's tap of three backbone walks (scales 1.0, 1.5, 0.5), CE + DC."""

from typing import List, Optional

from . import run

MODEL = "tap_unet_fuse"
DEFAULTS = {}
FIXED = {}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    return run(MODEL, DEFAULTS, FIXED, argv)


if __name__ == "__main__":
    main()
