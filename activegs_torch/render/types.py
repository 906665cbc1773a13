"""Shared datatypes for the surfel rasterizer (port of
`activegs_tpu/render/types.py`).

The pipeline per view: preprocess -> binning (sorts into K-aligned,
depth-ordered per-tile entry segments) -> tile composite; preprocess and
the compositor are hand-written CUDA kernels with hand-written backwards
on the card, and plain torch on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

# ---- entry parameter layout (rows of the (PARAM_DIM, E) entry array) ----
P_MEAN_X = 0
P_MEAN_Y = 1
P_CONIC_A = 2
P_CONIC_B = 3
P_CONIC_C = 4
P_OPACITY = 5
P_COLOR_R = 6
P_COLOR_G = 7
P_COLOR_B = 8
P_NRM_X = 9
P_NRM_Y = 10
P_NRM_Z = 11
P_PLANE_A = 12  # depth plane: t(u, v) = D / (A*u + B*v + C), u/v in pixels
P_PLANE_B = 13
P_PLANE_C = 14
P_PLANE_D = 15
P_CONF = 16
P_DEPTH_Z = 17  # camera-space center depth (sort key + fallback depth)
P_EXT_X = 18  # per-axis screen extents (binning only, carry no gradient)
P_EXT_Y = 19
PARAM_DIM = 24
USED_ROWS = 18  # rows the compositor reads (0..17)

# ---- output channel layout of the compositor (rows of (T, OUT_ROWS, P)) ----
O_R = 0
O_G = 1
O_B = 2
O_NX = 3
O_NY = 4
O_NZ = 5
O_DEPTH = 6
O_CONF = 7
O_TRANS = 8  # final transmittance (opacity = 1 - T)
O_STOP = 9  # chunks composited before the tile-wide early stop
OUT_DIM = 9
OUT_ROWS = 16
FEAT_DIM = 8


@dataclasses.dataclass(frozen=True)
class Camera:
    """A posed pinhole view. extrinsic: OpenCV camera-to-world (4, 4);
    intrinsic: normalized (3, 3)."""

    extrinsic: torch.Tensor
    intrinsic: torch.Tensor


@dataclasses.dataclass(frozen=True)
class GaussianAttrs:
    """Activated surfel attributes, leading dim N; `valid` masks live ones."""

    means: torch.Tensor  # (N, 3)
    scales: torch.Tensor  # (N, 3)
    rotations: torch.Tensor  # (N, 4) unit quaternions (wxyz)
    opacities: torch.Tensor  # (N,)
    colors: torch.Tensor  # (N, 3)
    confidences: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,) bool

    @property
    def num(self) -> int:
        return self.means.shape[0]


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Rasterizer configuration: every field changes outputs and keeps the
    reference's default (`activegs_tpu/render/types.py:96-178`)."""

    tile_h: int = 16
    tile_w: int = 32
    chunk: int = 128  # entries per compositing chunk (K)
    max_dup: int = 4  # tiles covered per gaussian (centred shrink beyond)
    entry_budget_mult: float = 2.0  # default entry budget as a multiple of N
    alpha_cut: float = 1.0 / 255.0
    alpha_max: float = 0.99
    term_eps: float = 1.0 / 255.0  # tile-wide early-stop transmittance
    lowpass: float = 0.3
    tan_clamp: float = 1.3
    near: float = 0.05
    sigma_extent: float = 3.0
    tile_cull: bool = True  # exact per-(gaussian, tile) ellipse cull
    depth_lo: float = 0.5  # plane-depth clamp, relative to center depth
    depth_hi: float = 2.0
    # bf16 pair math: the per-(entry, pixel) alpha terms and the in-chunk
    # transmittance in bfloat16; dx/dy are formed in float32 first, and the
    # depth-plane chain, the accumulators and every reduction stay float32
    # (the rounding contract: `render/composite.py`)
    bf16_pairs: bool = False

    @property
    def tile_pixels(self) -> int:
        return self.tile_h * self.tile_w


@dataclasses.dataclass(frozen=True)
class RenderOutput:
    rgb: torch.Tensor  # (3, h, w)
    depth: torch.Tensor  # (1, h, w)
    normal: torch.Tensor  # (3, h, w) camera-space, normalized + masked
    opacity: torch.Tensor  # (1, h, w)
    confidence: torch.Tensor  # (1, h, w)
