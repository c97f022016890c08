"""`python -m adaptersis_tpu_torch.eval.eval_dinov2_setr`: `train_seg` with
`--model tap_setr`, SETR: the last 4 blocks' patch tokens
concatenated, a progressive up-sampling decoder, CE + DC."""

from typing import List, Optional

from . import run

MODEL = "tap_setr"
DEFAULTS = {}
FIXED = {}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    return run(MODEL, DEFAULTS, FIXED, argv)


if __name__ == "__main__":
    main()
