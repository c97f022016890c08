"""`python -m adaptersis_tpu_torch.eval.eval_dinov2_setr_cross_ete`: `train_seg` with
`--model tap_setr_ete`, the backbone trained end to
end under a small SETR decoder (256, 128, 64), CE + DC; --cross_test_path
adds a second validation set."""

from typing import List, Optional

from . import run

MODEL = "tap_setr_ete"
DEFAULTS = {}
FIXED = {}


def main(argv: Optional[List[str]] = None) -> List[dict]:
    return run(MODEL, DEFAULTS, FIXED, argv)


if __name__ == "__main__":
    main()
