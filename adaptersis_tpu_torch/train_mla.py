"""Train the adapter model with the MLA decoder: the port's counterpart of
`train_mla.py`, `train_seg`'s flags with `--decoder mla` forced.

    python -m adaptersis_tpu_torch.train_mla --arch vit_large --patch_size 14 \\
        --imsize 588 --bf16 --gelu_approx --synthetic --output_dir out

`--mla_last_block_bug` reproduces the reference's copy-paste fault (its
last adapter round re-runs block depth − 2, not depth − 1); the reference's
decoder-only optimiser is `--parity_frozen_head`."""

from __future__ import annotations

from typing import List, Optional

from . import train_seg


def get_args_parser():
    p = train_seg.get_args_parser()
    p.add_argument("--mla_last_block_bug", action="store_true",
                   help="the reference's fault: the last adapter round re-runs block depth − 2")
    return p


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = get_args_parser().parse_args(argv)
    args.decoder = "mla"
    return train_seg.run(args)[1]


if __name__ == "__main__":
    main()
