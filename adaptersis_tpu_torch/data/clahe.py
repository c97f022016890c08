"""CLAHE on the device (counterpart of the JAX package's `data/clahe.py`):
albumentations' A.CLAHE(tile_grid_size=(8, 8)) on colour images, i.e. RGB →
Lab, OpenCV's CLAHE on the 8-bit L channel, Lab → RGB.

OpenCV's CLAHE, batched over all images and tiles at once:
  * the L channel padded to a tile multiple with BORDER_REFLECT_101 (when
    either side is not a multiple, both sides get `tiles − side % tiles`);
  * a 256-bin histogram per tile (`scatter_add_`);
  * clip at max(floor(clip·area/256), 1), the excess spread as
    floor(excess/256) over every bin plus a residual dripped at stride
    max(256 // residual, 1);
  * LUT = round(cdf · 255/area);
  * each pixel blends the LUTs of its four neighbouring tiles bilinearly.
Plain torch ops: the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# D65 sRGB ↔ XYZ (OpenCV's constants; the inverse taken in fp32, as the JAX
# package takes it). Python floats: the colour transforms multiply by
# scalars, so no constant tensor is copied to the device.
_RGB2XYZ_F32 = np.asarray([[0.412453, 0.357580, 0.180423],
                           [0.212671, 0.715160, 0.072169],
                           [0.019334, 0.119193, 0.950227]], np.float32)
_RGB2XYZ = _RGB2XYZ_F32.tolist()
_XYZ2RGB = np.linalg.inv(_RGB2XYZ_F32).astype(np.float32).tolist()
_WHITE = (0.950456, 1.0, 1.088754)


def _mat3(m, x: torch.Tensor) -> torch.Tensor:
    """x (..., 3) → (..., 3): out[..., k] = Σ_c m[k][c]·x[..., c]."""
    return torch.stack([x[..., 0] * r[0] + x[..., 1] * r[1] + x[..., 2] * r[2] for r in m],
                       dim=-1)


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    return torch.sign(t) * t.abs().pow(1.0 / 3.0)


def _f_lab(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > 0.008856, _cbrt(t), 7.787 * t + 16.0 / 116.0)


def _srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.04045, x / 12.92, torch.pow((x + 0.055) / 1.055, 2.4))


def _linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    x = x.clamp(min=0.0)
    return torch.where(x <= 0.0031308, x * 12.92, 1.055 * torch.pow(x, 1.0 / 2.4) - 0.055)


def rgb_to_lab(rgb01: torch.Tensor) -> torch.Tensor:
    """float RGB in [0, 1] → (L in [0, 100], a, b), after OpenCV's sRGB
    linearisation."""
    lin = _srgb_to_linear(rgb01)
    xyz = _mat3(_RGB2XYZ, lin)
    fx, fy, fz = (_f_lab(xyz[..., k] / _WHITE[k]) for k in range(3))
    y = xyz[..., 1] / _WHITE[1]
    L = torch.where(y > 0.008856, 116.0 * _cbrt(y) - 16.0, 903.3 * y)
    return torch.stack([L, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def inv_f(f):
        t3 = f ** 3
        return torch.where(t3 > 0.008856, t3, (f - 16.0 / 116.0) / 7.787)

    y = torch.where(L > 903.3 * 0.008856, fy ** 3, L / 903.3)
    xyz = torch.stack([inv_f(fx) * _WHITE[0], y * _WHITE[1], inv_f(fz) * _WHITE[2]], dim=-1)
    rgb = _mat3(_XYZ2RGB, xyz)
    return _linear_to_srgb(rgb).clamp(0.0, 1.0)


def clahe_channel(img: torch.Tensor, clip_limit: torch.Tensor, tiles: int = 8) -> torch.Tensor:
    """CLAHE of uint8 channels (B, H, W) → uint8, with a clip limit per image
    (B,) fp32."""
    B, H, W = img.shape
    if H % tiles == 0 and W % tiles == 0:
        pad_h = pad_w = 0
    else:
        # OpenCV pads BOTH sides when either is not a tile multiple (a whole
        # extra tile row or column on a side that was)
        pad_h, pad_w = tiles - H % tiles, tiles - W % tiles
    x = img.float()
    if pad_h or pad_w:
        x = F.pad(x[:, None], (0, pad_w, 0, pad_h), mode="reflect")[:, 0]
    Hp, Wp = x.shape[1:]
    th, tw = Hp // tiles, Wp // tiles
    area, T = th * tw, tiles * tiles
    v = x.long()                                                   # (B, Hp, Wp)

    tiled = v.reshape(B, tiles, th, tiles, tw).permute(0, 1, 3, 2, 4).reshape(B, T, area)
    hist = torch.zeros((B, T, 256), dtype=torch.float32, device=img.device)
    hist.scatter_add_(2, tiled, torch.ones_like(tiled, dtype=torch.float32))

    # clip and redistribute: OpenCV's integer arithmetic, in floats
    clip = torch.floor(clip_limit.float() * area / 256.0).clamp(min=1.0)[:, None, None]
    clipped = torch.minimum(hist, clip)
    excess = (hist - clipped).sum(dim=2, keepdim=True)            # (B, T, 1)
    redist = torch.floor(excess / 256.0)
    residual = excess - redist * 256.0
    step = torch.floor(256.0 / residual.clamp(min=1.0)).clamp(min=1.0)
    i = torch.arange(256, dtype=torch.float32, device=img.device)
    drip = ((torch.remainder(i, step) == 0) & (i / step < residual)).float()
    clipped = clipped + redist + drip

    lut = torch.round(torch.cumsum(clipped, dim=2) * (255.0 / area)).clamp(0, 255)
    lut = lut.reshape(B, T * 256)

    # blend the four neighbouring tiles' LUTs
    dev = img.device
    ty = torch.arange(Hp, dtype=torch.float32, device=dev) / th - 0.5
    tx = torch.arange(Wp, dtype=torch.float32, device=dev) / tw - 0.5
    ty0, tx0 = torch.floor(ty), torch.floor(tx)
    ay, ax = (ty - ty0)[:, None], (tx - tx0)[None, :]
    y0 = ty0.clamp(0, tiles - 1).long()[:, None]
    y1 = (ty0 + 1).clamp(0, tiles - 1).long()[:, None]
    x0 = tx0.clamp(0, tiles - 1).long()[None, :]
    x1 = (tx0 + 1).clamp(0, tiles - 1).long()[None, :]
    tile_idx = torch.stack([y0 * tiles + x0, y0 * tiles + x1,
                            y1 * tiles + x0, y1 * tiles + x1])    # (4, Hp, Wp)
    flat = (tile_idx[:, None] * 256 + v[None]).reshape(4, B, Hp * Wp)
    vals = torch.gather(lut[None].expand(4, -1, -1), 2, flat).reshape(4, B, Hp, Wp)
    w4 = torch.stack([(1 - ay) * (1 - ax), (1 - ay) * ax, ay * (1 - ax), ay * ax])
    out = (vals * w4[:, None]).sum(0)
    return torch.round(out).to(torch.uint8)[:, :H, :W]


def clahe_rgb(images: torch.Tensor, clip_limit, tiles: int = 8) -> torch.Tensor:
    """uint8 RGB (B, H, W, 3) → CLAHE on Lab L, uint8 RGB. `clip_limit` is a
    number or a (B,) tensor: albumentations draws it from U(1, clip_limit)
    per image."""
    B = images.shape[0]
    clip = torch.as_tensor(clip_limit, dtype=torch.float32, device=images.device)
    clip = clip.expand(B) if clip.dim() == 0 else clip
    lab = rgb_to_lab(images.float() / 255.0)
    L8 = torch.round((lab[..., 0] * 255.0 / 100.0).clamp(0, 255)).to(torch.uint8)
    L_new = clahe_channel(L8, clip, tiles).float() * 100.0 / 255.0
    rgb = lab_to_rgb(torch.stack([L_new, lab[..., 1], lab[..., 2]], dim=-1))
    return torch.round(rgb * 255.0).to(torch.uint8)
