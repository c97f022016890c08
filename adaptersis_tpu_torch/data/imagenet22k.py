"""ImageNet-22k as one tarball per class, read through mmap (a numpy + PIL
copy of the JAX package's `data/imagenet22k.py`, item for item; DINOv2's
`data/datasets/image_net_22k.py`).

  * The corpus: `<class_id>.tar` (GNU tar) per class and
    `blocks/<class_id>.log`, each member's 512-byte block offset as
    `block N: filename`, ended by a `** Block of NULs **` line.
  * `build_cache` parses the logs once into a structured entries array
    (class_index, class_id, start_offset, end_offset, filename) and the
    class ids, saved under `extra` and reopened with mmap; the known-corrupt
    member n06470073_47249.JPEG is left out.
  * An item is read by slicing the class tarball's mmap (an LRU of open
    maps) past its 512-byte header; members gzipped in place are unpacked.
Items are (image uint8 (H, W, 3), class index, index).
"""

from __future__ import annotations

import gzip
import io
import os
from functools import lru_cache
from mmap import ACCESS_READ, mmap
from typing import List, Optional, Tuple

import numpy as np

from .imagenet import _image

_BLOCK = 512
_NULS = "** Block of NULs **"
_BAD_MEMBERS = {"n06470073_47249.JPEG"}
_ENTRIES_FILE = "entries.npy"
_CLASS_IDS_FILE = "class-ids.npy"


def _parse_blocks_log(path: str) -> List[Tuple[int, Optional[str]]]:
    """[(block offset, member name, or None for the trailing NULs)]."""
    out: List[Tuple[int, Optional[str]]] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            head, _, name = line.partition(":")
            name = name[1:] if name.startswith(" ") else name
            out.append((int(head.split()[1]), None if name == _NULS else name))
    if not out or out[-1][1] is not None:
        raise RuntimeError(f"blocks log {path!r} does not end with a NULs line")
    return out


def build_cache(root: str, extra: str) -> Tuple[np.ndarray, np.ndarray]:
    """Scan `<root>/*.tar` and `<root>/blocks/*.log` into the entries and
    class-ids caches under `extra`."""
    class_ids = sorted(os.path.splitext(e.name)[0] for e in os.scandir(root)
                       if e.name.endswith(".tar"))
    rows = []
    for class_index, class_id in enumerate(class_ids):
        blocks = _parse_blocks_log(os.path.join(root, "blocks", f"{class_id}.log"))
        for (off0, name), (off1, _) in zip(blocks, blocks[1:]):
            if name is None or name in _BAD_MEMBERS:
                continue
            rows.append((class_index, class_id, off0 * _BLOCK, off1 * _BLOCK, name))
    cid_len = max((len(c) for c in class_ids), default=1)
    name_len = max((len(r[4]) for r in rows), default=1)
    dtype = np.dtype([("class_index", "<u4"), ("class_id", f"U{cid_len}"),
                      ("start_offset", "<u8"), ("end_offset", "<u8"),
                      ("filename", f"U{name_len}")])
    entries = np.array(rows, dtype=dtype)
    ids = np.array(class_ids, dtype=f"U{cid_len}")
    os.makedirs(extra, exist_ok=True)
    np.save(os.path.join(extra, _ENTRIES_FILE), entries)
    np.save(os.path.join(extra, _CLASS_IDS_FILE), ids)
    return entries, ids


class ImageNet22k:
    """`root`: the per-class tarballs and `blocks/`; `extra`: the cache
    directory (`<root>/extra` by default), built on first use."""

    def __init__(self, root: str, extra: Optional[str] = None,
                 imsize: Optional[int] = None, mmap_cache_size: int = 16):
        self.root = root
        self.extra = extra or os.path.join(root, "extra")
        self.imsize = imsize
        entries_path = os.path.join(self.extra, _ENTRIES_FILE)
        if not os.path.exists(entries_path):
            build_cache(root, self.extra)
        self._entries = np.load(entries_path, mmap_mode="r")
        self._class_ids = np.load(os.path.join(self.extra, _CLASS_IDS_FILE), mmap_mode="r")

        @lru_cache(maxsize=mmap_cache_size)
        def _open(class_id: str) -> mmap:
            with open(os.path.join(root, f"{class_id}.tar")) as f:
                return mmap(fileno=f.fileno(), length=0, access=ACCESS_READ)

        self._mmap_tarball = _open

    def __len__(self) -> int:
        return len(self._entries)

    def get_targets(self) -> np.ndarray:
        return np.asarray(self._entries["class_index"])

    def get_target(self, index: int) -> int:
        return int(self._entries[index]["class_index"])

    def find_class_id(self, class_index: int) -> str:
        return str(self._class_ids[class_index])

    def get_image_data(self, index: int) -> bytes:
        e = self._entries[index]
        m = self._mmap_tarball(str(e["class_id"]))
        raw = m[int(e["start_offset"]) + _BLOCK:int(e["end_offset"])]
        if raw[:2] == b"\x1f\x8b":          # gzipped in place
            with gzip.GzipFile(fileobj=io.BytesIO(raw)) as g:
                raw = g.read()
        return raw

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int, int]:
        return (_image(io.BytesIO(self.get_image_data(index)), self.imsize),
                self.get_target(index), index)
