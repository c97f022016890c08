"""The DINO projection head (counterpart of the JAX package's
`ssl/heads.py:DINOHead`): a 3-layer MLP with exact GELU (in → hidden →
hidden → bottleneck), L2 normalisation (eps 1e-12), then the weight-normed
last layer w = g·v/‖v‖ per output column, no bias. Parameter names follow
the flax module (`mlp_0` .. `mlp_2`, `last_layer_v` (bottleneck, out),
`last_layer_g` (out,)) so its variables load through `train/convert.py`.
The head runs in fp32; the (bottleneck × out) product is a plain matmul,
as the JAX package leaves it to XLA."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class DINOHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int = 2048,
                 bottleneck_dim: int = 256, nlayers: int = 3, mlp_bias: bool = True):
        super().__init__()
        nlayers = max(nlayers, 1)
        dims = [hidden_dim] * (nlayers - 1) + [bottleneck_dim]
        self.n_mlp = len(dims)
        for i, (a, b) in enumerate(zip([in_dim] + dims[:-1], dims)):
            lin = nn.Linear(a, b, bias=mlp_bias)
            nn.init.trunc_normal_(lin.weight, std=0.02, a=-0.04, b=0.04)
            if mlp_bias:
                nn.init.zeros_(lin.bias)
            setattr(self, f"mlp_{i}", lin)
        self.last_layer_v = nn.Parameter(torch.empty(bottleneck_dim, out_dim))
        nn.init.trunc_normal_(self.last_layer_v, std=0.02, a=-0.04, b=0.04)
        self.last_layer_g = nn.Parameter(torch.ones(out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_mlp):
            x = getattr(self, f"mlp_{i}")(x)
            if i < self.n_mlp - 1:
                x = F.gelu(x)
        x = x.float()
        x = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        v = self.last_layer_v
        w = v / v.norm(dim=0, keepdim=True).clamp_min(1e-12) * self.last_layer_g
        return x @ w
