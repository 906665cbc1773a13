"""Image-space operators: depth->normal, bilateral smoothing, finite
differences, SSIM (port of `activegs_tpu/core/image_ops.py`)."""

from __future__ import annotations

import torch

from .quaternions import cross


def _pad_replicate(x: torch.Tensor, r: int, dims=(0, 1)) -> torch.Tensor:
    """Edge-replicate padding by r along `dims` (any layout). Built from
    expanded edge slices, whose adjoint is a plain sum, so gradients through
    it are the same on every run (an index_select would scatter them back
    with atomics on the card)."""
    for d in dims:
        shape = list(x.shape)
        shape[d] = r
        first = x.narrow(d, 0, 1).expand(shape)
        last = x.narrow(d, x.shape[d] - 1, 1).expand(shape)
        x = torch.cat([first, x, last], dim=d)
    return x


def depth_to_normal(depth: torch.Tensor, mask: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Camera-space normals (h, w, 3) from a z-depth map (h, w): back-project,
    masked differences to the 4 neighbours, average of the 4 adjacent cross
    products, normalize, zero where `mask` is False. Differentiable in depth."""
    h, w = depth.shape
    fx = intrinsics[0, 0] * w
    fy = intrinsics[1, 1] * h
    cx = intrinsics[0, 2] * w
    cy = intrinsics[1, 2] * h
    us = torch.arange(w, dtype=depth.dtype, device=depth.device) + 0.5
    vs = torch.arange(h, dtype=depth.dtype, device=depth.device) + 0.5
    gv, gu = torch.meshgrid(vs, us, indexing="ij")
    x = (gu - cx) / fx * depth
    y = (gv - cy) / fy * depth
    p = torch.stack([x, y, depth], dim=-1)

    m = mask.to(depth.dtype)[..., None]
    pp = _pad_replicate(p, 1)
    mp = _pad_replicate(m, 1)

    p_c = pp[1:-1, 1:-1] * mp[1:-1, 1:-1]
    p_u = (pp[:-2, 1:-1] - p_c) * mp[:-2, 1:-1]
    p_l = (pp[1:-1, :-2] - p_c) * mp[1:-1, :-2]
    p_b = (pp[2:, 1:-1] - p_c) * mp[2:, 1:-1]
    p_r = (pp[1:-1, 2:] - p_c) * mp[1:-1, 2:]

    n = cross(p_u, p_l) + cross(p_r, p_u) + cross(p_b, p_r) + cross(p_l, p_b)
    # rsqrt(max(.)) normalization: NaN-free gradient where n == 0
    n2 = torch.sum(n * n, dim=-1, keepdim=True)
    n = n * torch.rsqrt(torch.clamp(n2, min=1e-24))
    return n * m


def bilateral_filter(
    depth: torch.Tensor,
    radius: int = 7,
    sigma_value: float = 0.5,
    sigma_space: float = 20.0,
) -> torch.Tensor:
    """Edge-preserving depth smoothing (cv2.bilateralFilter equivalent);
    invalid (< 0) depths get zero weight and are restored afterwards."""
    invalid = depth < 0.0
    d = torch.where(invalid, 0.0, depth)
    valid = (~invalid).to(depth.dtype)
    k = 2 * radius + 1
    dp = _pad_replicate(d, radius)
    vp = _pad_replicate(valid, radius)
    h, w = depth.shape
    off = torch.arange(k, device=depth.device) - radius
    r2 = (off[:, None] ** 2 + off[None, :] ** 2).to(torch.float32)
    space_w = torch.exp(-r2 / (2.0 * sigma_space**2))  # (k, k)
    num = torch.zeros_like(d)
    den = torch.zeros_like(d)
    for dy in range(k):
        for dx in range(k):
            nb = dp[dy : dy + h, dx : dx + w]
            nv = vp[dy : dy + h, dx : dx + w]
            wgt = torch.exp(-((nb - d) ** 2) / (2.0 * sigma_value**2)) * nv * space_w[dy, dx]
            num = num + wgt * nb
            den = den + wgt
    out = torch.where(den > 1e-12, num / torch.clamp(den, min=1e-12), d)
    return torch.where(invalid, -1.0, out)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM between (..., c, h, w) images, data range 1.0: a Gaussian
    window (sigma 1.5), C1 = 0.01^2, C2 = 0.03^2, 'same' zero padding (at
    stride 1 a symmetric pad of window_size // 2)."""
    xs = torch.arange(window_size, dtype=torch.float32, device=img1.device) - window_size // 2
    g = torch.exp(-(xs**2) / (2.0 * 1.5**2))
    g = g / torch.sum(g)
    win = torch.outer(g, g)[None, None]

    def blur(x):
        b = x.reshape((-1, 1) + x.shape[-2:])
        return torch.nn.functional.conv2d(b, win, padding=window_size // 2).reshape(x.shape)

    mu1 = blur(img1)
    mu2 = blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(img1 * img1) - mu1_sq
    s2 = blur(img2 * img2) - mu2_sq
    s12 = blur(img1 * img2) - mu12
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return torch.mean(ssim_map)


def central_diff_sq(x: torch.Tensor) -> torch.Tensor:
    """Squared-norm forward/backward differences, (v, c, h, w) -> (v, 4, h, w):
    left/right/up/down shifted differences, zero on the vacated edge,
    summed over channels."""
    zl = torch.zeros_like(x[..., :, :1])
    zr = torch.zeros_like(x[..., :1, :])
    left = torch.cat([x[..., :, :-1] - x[..., :, 1:], zl], dim=-1)
    right = torch.cat([zl, x[..., :, 1:] - x[..., :, :-1]], dim=-1)
    up = torch.cat([x[..., :-1, :] - x[..., 1:, :], zr], dim=-2)
    down = torch.cat([zr, x[..., 1:, :] - x[..., :-1, :]], dim=-2)
    diffs = torch.stack([left, right, up, down], dim=-3)
    return torch.sum(diffs**2, dim=-4)
