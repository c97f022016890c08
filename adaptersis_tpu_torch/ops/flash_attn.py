"""Flash attention with segment ids, forward and backward (K7): the
counterpart of the library Pallas TPU flash attention that the JAX package
calls from `models/layers.py` (`_sdpa_flash`, `_flash_bhnd`) with
attn_impl="flash", the DINOv2 SSL step's attention.

A query attends only to keys of its own segment: the SSL student packs a
global crop and 4 local crops into one row of 457 tokens (the reference's
block-diagonal mask), the teacher walks its global crops as one segment.
`flash_attn` is differentiable: on a CUDA tensor its forward launches
`csrc/flash_attn_fwd.cu`, which also writes the row logsumexp, and its
backward `csrc/flash_attn_bwd.cu` (a dK/dV kernel and a dQ kernel); on a
CPU tensor both run the plain versions here. The port runs the true lengths:
no padding to 128, the ragged tail is masked in the kernels. A head width of
64 runs on the tensor cores, bf16 in one pass and fp32 in three TF32 passes
that keep fp32 accuracy (`ops/tf32.py`), and those kernels walk only the
tile pairs whose segments can meet (`live_tiles`); Dh 16 and 32 run on the
CUDA cores over every pair. Each launcher reports the kernel it ran
(`KERNELS`).

The plain versions follow the library kernel's rounding points:
  s  = (q·kᵀ in fp32) × scale, the scale applied after the product, plus
       −0.7·f32max where the segments differ (not −inf);
  o  = (softmax(s) rounded to v's dtype) · v in fp32, rounded to q's dtype;
  di = Σ o·do in fp32; dv = pᵀ·do, dk = dsᵀ·q, dq = ds·k, with p and
       ds = p·(dp − di)·scale rounded to the input dtype before the product.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

# The kernels the launchers report, in the order of their AttnKernel codes
# (csrc/flash_attn.cuh): "wgmma" (bf16, Dh 64), "tf32x3" (fp32, Dh 64),
# "cuda_cores" (Dh 16, 32).
KERNELS = ("wgmma", "tf32x3", "cuda_cores")

# Kernel launches since the last reset, in all and by the kernel the
# launcher reports; chip_smoke.py reads and zeroes them. A backward call
# launches two kernels (dK/dV, then dQ) and counts once.
launches = 0
bwd_launches = 0
path_launches = dict.fromkeys(KERNELS, 0)
bwd_path_launches = dict.fromkeys(KERNELS, 0)

# The tile pairs of the Dh-64 kernels (query rows × key columns): the
# forward's and the backward's (own rows × walked rows), by dtype.
FWD_TILES = {torch.bfloat16: (64, 128), torch.float32: (128, 64)}
BWD_TILES = {torch.bfloat16: (64, 64), torch.float32: (64, 32)}

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


def live_tiles(segment_ids: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The tile pairs the kernels walk: (B, ⌈N/rows⌉, ⌈N/cols⌉) bool, True
    where the segment ids of query tile i (`rows` tokens) and key tile j
    (`cols` tokens) can meet, i.e. where their ranges [min, max] overlap.
    The last tile of each side holds the tokens up to N.

    Skipping the other pairs is exact, for any ids: disjoint ranges share no
    id, so every pair of a skipped tile is masked. In the forward such a
    tile would add exp(mask − m) = 0 to every row (every query meets at
    least its own key, so m is a real score once the row's walk is over; a
    masked tile walked first is rescaled by exp(mask − m) = 0 later); in
    the backward its p = exp(s + mask − lse) is exactly 0, and so is its
    ds. Interleaved ids give overlapping ranges almost everywhere and
    simply skip nothing. The kernels (`csrc/flash_attn.cuh` `next_live`)
    reduce the same ranges from the ids."""
    B, N = segment_ids.shape

    def ranges(size):
        n = -(-N // size)
        info = torch.iinfo(segment_ids.dtype)

        def padded(value):   # the last tile's missing tokens take no part
            pad = segment_ids.new_full((B, n * size - N), value)
            return torch.cat([segment_ids, pad], 1).view(B, n, size)

        return padded(info.max).amin(-1), padded(info.min).amax(-1)

    (qlo, qhi), (klo, khi) = ranges(rows), ranges(cols)
    return (qlo[:, :, None] <= khi[:, None, :]) & (klo[:, None, :] <= qhi[:, :, None])


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float,
            segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if segment_ids is None:
        return s
    same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
    return s + torch.where(same, 0.0, MASK_VALUE)


@_build.plain
def flash_attn_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                         segment_ids: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the output in q's dtype and the fp32 row logsumexp."""
    s = _scores(q, k, scale, segment_ids)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul((p / l).to(v.dtype).float(), v.float())
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


@_build.plain
def flash_attn_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                         lse: torch.Tensor, do: torch.Tensor, scale: float,
                         segment_ids: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the input dtype, from the forward's o and lse."""
    dt = q.dtype
    di = (o.float() * do.float()).sum(dim=-1, keepdim=True)
    p = torch.exp(_scores(q, k, scale, segment_ids) - lse.unsqueeze(-1))
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = ((dp - di) * p * scale).to(dt).float()
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dq = torch.matmul(ds, k.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           segment_ids: Optional[torch.Tensor]) -> None:
    """What the kernels take: CUDA tensors (B, H, N, Dh) with Dh in (16, 32,
    64), bf16 or fp32, contiguous and 16-byte aligned; (B, N) int32 ids."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 4 or q.shape[-1] not in (16, 32, 64):
        raise ValueError(f"{name}: expected (B, H, N, Dh) with Dh 16, 32 or 64, "
                         f"got {tuple(q.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: dtype must be bf16 or fp32, got {q.dtype}")
    for label, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {label} {tuple(t.shape)} {t.dtype} {t.device} "
                             f"does not match q {tuple(q.shape)} {q.dtype} {q.device}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must be contiguous and 16-byte aligned")
    if segment_ids is not None and (
            tuple(segment_ids.shape) != (q.shape[0], q.shape[2])
            or segment_ids.dtype != torch.int32 or segment_ids.device != q.device
            or not segment_ids.is_contiguous()):
        raise ValueError(f"{name}: segment_ids must be contiguous (B, N) int32 on {q.device}, "
                         f"got {tuple(segment_ids.shape)} {segment_ids.dtype} "
                         f"{segment_ids.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _walked(name: str, walked: Optional[torch.Tensor], n: int, device) -> None:
    if walked is not None and (walked.dtype != torch.int32 or walked.shape != (n,)
                               or walked.device != device or not walked.is_contiguous()):
        raise ValueError(f"{name}: walked must be a contiguous ({n},) int32 tensor on {device}, "
                         f"got {tuple(walked.shape)} {walked.dtype} {walked.device}")


def flash_attn_fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                          segment_ids: Optional[torch.Tensor] = None,
                          walked: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA tensors: (o, lse) as `flash_attn_fwd_plain`.
    `walked`, a (1,) int32 tensor, takes the number of tile pairs a Dh-64
    kernel walked (`FWD_TILES` of the dtype), to hold against `live_tiles`;
    the CUDA-core paths (Dh 16, 32) walk every pair and leave it as it is."""
    _check("flash_attn", q, k, v, segment_ids)
    _walked("flash_attn", walked, 1, q.device)
    B, H, N, Dh = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    lib = _build.library()
    kernel = ctypes.c_int(-1)
    err = _build.launch(q, lib.asis_flash_attn_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        _ptr(segment_ids), o.data_ptr(), lse.data_ptr(), _ptr(walked), B, H, N, Dh,
                        float(scale), int(q.dtype == torch.bfloat16), ctypes.byref(kernel))
    _build.check(lib, err, "flash_attn forward")
    global launches
    launches += 1
    path_launches[KERNELS[kernel.value]] += 1
    return o, lse


def flash_attn_bwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                          lse: torch.Tensor, do: torch.Tensor, scale: float,
                          segment_ids: Optional[torch.Tensor] = None,
                          walked: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels on CUDA tensors: (dq, dk, dv) as
    `flash_attn_bwd_plain`. di = Σ o·do is a plain fp32 reduction, as the
    library computes it outside its kernels. `walked`, a (2,) int32 tensor,
    takes the number of tile pairs the Dh-64 dK/dV and dQ kernels walked
    (`BWD_TILES` of the dtype), as `flash_attn_fwd_kernel`'s."""
    _check("flash_attn backward", q, k, v, segment_ids)
    _walked("flash_attn backward", walked, 2, q.device)
    B, H, N, Dh = q.shape
    do = do.to(q.dtype).contiguous()
    if do.data_ptr() % 16:   # the kernels read do in 16-byte vectors, as q, k and v
        do = do.clone()
    if do.shape != q.shape or lse.shape != (B, H, N) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attn backward: do {tuple(do.shape)}, lse {tuple(lse.shape)} "
                         f"{lse.dtype} do not match q {tuple(q.shape)}")
    # the exact fp32 products of the values, as the plain version's: a new
    # fp32 copy of o (never o itself, which autograd saved and the caller
    # holds) times do, one pass less than casting both
    di = o.to(torch.float32, copy=True).mul_(do).sum(dim=-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.library()
    kernel = ctypes.c_int(-1)
    err = _build.launch(q, lib.asis_flash_attn_bwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.contiguous().data_ptr(), di.data_ptr(),
                        _ptr(segment_ids), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        _ptr(walked), B, H, N, Dh, float(scale), int(q.dtype == torch.bfloat16),
                        ctypes.byref(kernel))
    _build.check(lib, err, "flash_attn backward")
    global bwd_launches
    bwd_launches += 1
    bwd_path_launches[KERNELS[kernel.value]] += 1
    return dq, dk, dv


class _FlashAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, segment_ids, kernel):
        fwd = flash_attn_fwd_kernel if kernel else flash_attn_fwd_plain
        o, lse = fwd(q, k, v, scale, segment_ids)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.segment_ids, ctx.kernel = scale, segment_ids, kernel
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attn_bwd_kernel if ctx.kernel else flash_attn_bwd_plain
        dq, dk, dv = bwd(q, k, v, o, lse, do, ctx.scale, ctx.segment_ids)
        return dq, dk, dv, None, None, None


def flash_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                     segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version on any device, differentiable through
    `flash_attn_bwd_plain` (the library's backward rounding points, which
    autograd of the forward formula would not keep)."""
    return _FlashAttn.apply(q, k, v, scale, segment_ids, False)


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
               segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v: (B, H, N, Dh), bf16 or fp32; segment_ids: (B, N) int32 or
    None (one segment). Returns (B, H, N, Dh) in q's dtype. A CPU tensor
    takes the plain version; a CUDA tensor the kernels, or the call raises."""
    if q.device.type == "cpu":
        return flash_attn_plain(q, k, v, scale, segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn: unsupported device {q.device}")
    return _FlashAttn.apply(q, k, v, scale, segment_ids, True)
