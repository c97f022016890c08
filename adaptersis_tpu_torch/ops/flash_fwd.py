"""Forward-only attention for the frozen ViT walks: softmax(q·kᵀ·scale)·v.

`flash_fwd` launches the hand-written CUDA kernel (`csrc/flash_fwd.cu`) on a
CUDA tensor and runs `flash_fwd_plain` on a CPU tensor. Every key is real:
the port runs each walk at its true length (1765 tokens with cls, 1764
without), so there is no padding and no validity mask.

It has no backward, like the JAX kernel: the frozen walks run under
`torch.no_grad()`. A call that would need a gradient raises on either device
rather than cut the gradient silently.
"""

from __future__ import annotations

import torch

from . import _build

# Kernel launches since the last reset; chip_smoke.py reads it.
launches = 0


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Plain attention as the JAX package's `_reference_sdpa`: scores in the
    input dtype, softmax in fp32, probabilities cast back for p·v."""
    s = torch.matmul(q * scale, k.transpose(-1, -2))
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    return torch.matmul(p, v)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """q, k, v: (B, H, N, Dh) with Dh in (16, 32, 64), bf16 or fp32.
    Returns (B, H, N, Dh) in q's dtype."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_fwd has no backward: call it under torch.no_grad() "
                           "(the backbone walks are frozen) or on tensors that need no grad")
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    B, H, N, Dh = q.shape
    if Dh not in (16, 32, 64):
        raise ValueError(f"flash_fwd: head width must be 16, 32 or 64, got {Dh}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_fwd: dtype must be bf16 or fp32, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_fwd: {name} {tuple(t.shape)} {t.dtype} {t.device} "
                             f"does not match q {tuple(q.shape)} {q.dtype} {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd: q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_fwd: q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.asis_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 B * H, N, Dh, float(scale), int(q.dtype == torch.bfloat16),
                                 torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "flash_fwd")
    global launches
    launches += 1
    return out
