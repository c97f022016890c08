"""Train the 8-class instrument segmentation of EndoVis 2017: the port's
counterpart of `train_multi_class.py`, `train_seg`'s flags with its
defaults: `--num_classes 8` (unless `--num_labels` is given), `--loss
iou_multi` in place of "dc", `--dataset endovis2017` in place of
"robomis". Validation reports `ch_iou` and `isi_iou`.

    python -m adaptersis_tpu_torch.train_multi_class --arch vit_large \\
        --patch_size 14 --imsize 588 --bf16 --data_path /data/endovis2017"""

from __future__ import annotations

from typing import List, Optional

from . import train_seg


def parse_args(argv: Optional[List[str]] = None):
    args = train_seg.get_args_parser().parse_args(argv)
    if args.num_labels == 1000:          # left at its default: the multi-class recipe
        args.num_classes = 8
    if args.loss == "dc":
        args.loss = "iou_multi"
    if args.dataset == "robomis":
        args.dataset = "endovis2017"
    return args


def main(argv: Optional[List[str]] = None) -> List[dict]:
    return train_seg.run(parse_args(argv))[1]


if __name__ == "__main__":
    main()
