"""The arithmetic of the reference's products, one object per precision.

Every matrix product and convolution of the reference goes through one of
these, so the same model code runs as the fp32 reference and as a control
in a lower precision:

  * `FP32`: fp32 operands, fp32 products (TF32 off, set by `precision_flags`);
  * `TF32`: the control of an fp32 configuration: every operand of a
    product or convolution rounded to TF32 (10 mantissa bits, to nearest,
    ties away, as the tensor cores' conversion does), computed in fp32 on
    the rounded values, so it reads the same on any device, the CPU too;
  * `FP8`: the control of a bf16 configuration: every operand of a product
    or convolution rounded to float8 e4m3 with a scale per tensor (its
    largest magnitude to 448), computed in fp32 on the rounded values.
The controls' backward sees the rounding as the identity (straight-through).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F


class FP32:
    name = "fp32"

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def linear(self, x, w, b=None):
        return F.linear(self.operand(x), self.operand(w), b)

    def matmul(self, a, b):
        return torch.matmul(self.operand(a), self.operand(b))

    def conv2d(self, x, w, b=None, stride=1, padding=0, groups=1):
        return F.conv2d(self.operand(x), self.operand(w), b, stride, padding, 1, groups)


class TF32(FP32):
    name = "tf32"

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        bits = t.detach().float().contiguous().view(torch.int32)
        q = ((bits + 0x1000) & -0x2000).view(torch.float32)
        return t + (q - t.detach())


class FP8(FP32):
    name = "fp8_e4m3"
    E4M3_MAX = 448.0

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        scale = t.detach().abs().amax().clamp(min=1e-30) / self.E4M3_MAX
        q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (q - t.detach())


PRECISIONS = {p.name: p for p in (FP32(), TF32(), FP8())}


@contextlib.contextmanager
def precision_flags(policy) -> Iterator[None]:
    """TF32 off for the reference and its controls (a control rounds its
    operands itself), restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
