"""Plain reference of the surfel rasterizer: activation, projection, tile
binning and front-to-back compositing, differentiable by autograd.

The projection and the binning rules (the max_dup span cap with its
centred shrink, the exact ellipse/tile cull, the (tile, depth, index)
order) are a frozen copy of the method's plain math as the port had it
when this benchmark was written; the compositing is written here afresh:
each tile's depth-sorted entries against each of its pixels at once, the
transmittance as products over chunks of `chunk` entries with the method's
tile-wide early stop between chunks, and no hand-written backward (autograd
differentiates it). No entry budget: every entry that the span cap keeps
is rendered (the program picks its budgets to cover the measured maximum,
so a budget cut in the program shows as a difference).
"""

from __future__ import annotations

import dataclasses

import torch

# entry columns of the (N, NCOL) projected parameters
MX, MY, CA, CB, CC, OP, CR, CG, CBL, NX, NY, NZ, PA, PB, PC, PD, CONF, DZ, EXX, EXY = range(20)
NCOL = 20
POWER_FLOOR = -80.0


@dataclasses.dataclass(frozen=True)
class Raster:
    """The rasterizer settings the method states (the configuration file's
    `raster` and `constants.raster`)."""

    tile_h: int = 16
    tile_w: int = 32
    chunk: int = 128
    max_dup: int = 4
    alpha_cut: float = 1.0 / 255.0
    alpha_max: float = 0.99
    term_eps: float = 1.0 / 255.0
    lowpass: float = 0.3
    tan_clamp: float = 1.3
    near: float = 0.05
    sigma_extent: float = 3.0
    depth_lo: float = 0.5
    depth_hi: float = 2.0


def activate(raw: dict, scale_factor: float, scale_max: float, use_view_distribution: bool = True) -> dict:
    """Activated surfels from the raw map fields (means, scales_raw,
    rotations_raw, opacities_raw, colors, view_scores, view_supports,
    view_means) and the live count `raw["count"]`."""
    q = raw["rotations_raw"]
    q = q / torch.clamp(torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)), min=1e-12)
    if use_view_distribution:
        vm = raw["view_means"]
        var = torch.sqrt(torch.sum(vm * vm, dim=-1))
        var = torch.where(torch.isnan(var), 1.0, var)
        conf = torch.clamp(torch.exp(1.0 - var) * raw["view_scores"], 0.0, 1.0)
    else:
        conf = torch.clamp(1.0 - torch.exp(-raw["view_supports"]), 0.0, 1.0)
    n = raw["means"].shape[0]
    return {
        "means": raw["means"],
        "scales": torch.clamp(scale_factor * torch.exp(raw["scales_raw"]), 0.0, scale_max),
        "rotations": q,
        "opacities": torch.sigmoid(raw["opacities_raw"]),
        "colors": raw["colors"],
        "confidences": conf.detach(),
        "valid": torch.arange(n, device=raw["means"].device) < raw["count"],
    }


def invert_rigid(ext: torch.Tensor) -> torch.Tensor:
    r = ext[:3, :3]
    t = ext[:3, 3]
    rt = r.t()
    out = torch.eye(4, dtype=ext.dtype, device=ext.device)
    out[:3, :3] = rt
    out[:3, 3] = -(rt[:, 0] * t[0] + rt[:, 1] * t[1] + rt[:, 2] * t[2])
    return out


def project(a: dict, ext: torch.Tensor, intr: torch.Tensor, shape, rc: Raster, front_only: bool = False):
    """(params (N, NCOL), in_view (N,)): each surfel's screen mean, conic,
    opacity, colour, camera-space normal, depth plane, confidence, camera
    depth and screen extents; rows of surfels out of view are zero."""
    h, w = shape
    fx, fy = intr[0, 0] * w, intr[1, 1] * h
    cx, cy = intr[0, 2] * w, intr[1, 2] * h
    w2c = invert_rigid(ext)
    r = [[w2c[i, j] for j in range(3)] for i in range(3)]
    t0, t1, t2 = w2c[0, 3], w2c[1, 3], w2c[2, 3]
    mx, my, mz = a["means"][:, 0], a["means"][:, 1], a["means"][:, 2]
    px = r[0][0] * mx + r[0][1] * my + r[0][2] * mz + t0
    py = r[1][0] * mx + r[1][1] * my + r[1][2] * mz + t1
    pz = r[2][0] * mx + r[2][1] * my + r[2][2] * mz + t2
    in_front = pz > rc.near
    zs = torch.where(in_front, pz, 1.0)
    inv_z = 1.0 / zs
    mean_x = fx * px * inv_z + cx
    mean_y = fy * py * inv_z + cy

    qw, qx, qy, qz = a["rotations"].unbind(-1)
    R00 = 1 - 2 * (qy * qy + qz * qz)
    R01 = 2 * (qx * qy - qw * qz)
    R02 = 2 * (qx * qz + qw * qy)
    R10 = 2 * (qx * qy + qw * qz)
    R11 = 1 - 2 * (qx * qx + qz * qz)
    R12 = 2 * (qy * qz - qw * qx)
    R20 = 2 * (qx * qz - qw * qy)
    R21 = 2 * (qy * qz + qw * qx)
    R22 = 1 - 2 * (qx * qx + qy * qy)
    s0, s1, s2 = (a["scales"][:, i] ** 2 for i in range(3))
    c00 = s0 * R00 * R00 + s1 * R01 * R01 + s2 * R02 * R02
    c01 = s0 * R00 * R10 + s1 * R01 * R11 + s2 * R02 * R12
    c02 = s0 * R00 * R20 + s1 * R01 * R21 + s2 * R02 * R22
    c11 = s0 * R10 * R10 + s1 * R11 * R11 + s2 * R12 * R12
    c12 = s0 * R10 * R20 + s1 * R11 * R21 + s2 * R12 * R22
    c22 = s0 * R20 * R20 + s1 * R21 * R21 + s2 * R22 * R22

    lim_x = rc.tan_clamp * (0.5 * w / fx)
    lim_y = rc.tan_clamp * (0.5 * h / fy)
    tx = torch.clamp(px * inv_z, -lim_x, lim_x) * zs
    ty = torch.clamp(py * inv_z, -lim_y, lim_y) * zs
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z * inv_z
    a0, a1, a2 = (j00 * r[0][k] + j02 * r[2][k] for k in range(3))
    b0, b1, b2 = (j11 * r[1][k] + j12 * r[2][k] for k in range(3))
    ca0 = a0 * c00 + a1 * c01 + a2 * c02
    ca1 = a0 * c01 + a1 * c11 + a2 * c12
    ca2 = a0 * c02 + a1 * c12 + a2 * c22
    cov_a = ca0 * a0 + ca1 * a1 + ca2 * a2 + rc.lowpass
    cov_b = ca0 * b0 + ca1 * b1 + ca2 * b2
    cb0 = b0 * c00 + b1 * c01 + b2 * c02
    cb1 = b0 * c01 + b1 * c11 + b2 * c12
    cb2 = b0 * c02 + b1 * c12 + b2 * c22
    cov_c = cb0 * b0 + cb1 * b1 + cb2 * b2 + rc.lowpass
    det = cov_a * cov_c - cov_b * cov_b
    inv_det = 1.0 / torch.clamp(det, min=1e-12)
    with torch.no_grad():
        mid = 0.5 * (cov_a + cov_c)
        radius = torch.ceil(rc.sigma_extent * torch.sqrt(mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.0))))
        ext_x = torch.ceil(rc.sigma_extent * torch.sqrt(torch.clamp(cov_a, min=0.0)))
        ext_y = torch.ceil(rc.sigma_extent * torch.sqrt(torch.clamp(cov_c, min=0.0)))

    ncx = r[0][0] * R02 + r[0][1] * R12 + r[0][2] * R22
    ncy = r[1][0] * R02 + r[1][1] * R12 + r[1][2] * R22
    ncz = r[2][0] * R02 + r[2][1] * R12 + r[2][2] * R22
    plane_dot = ncx * px + ncy * py + ncz * pz
    pa = ncx / fx
    pb = ncy / fy
    pc = ncz - pa * cx - pb * cy
    in_view = (a["valid"] & in_front & (det > 1e-12) & (mean_x + radius > 0) & (mean_x - radius < w)
               & (mean_y + radius > 0) & (mean_y - radius < h))
    if front_only:
        in_view = in_view & (plane_dot < 0)
    cols = [mean_x, mean_y, cov_c * inv_det, -cov_b * inv_det, cov_a * inv_det, a["opacities"],
            a["colors"][:, 0], a["colors"][:, 1], a["colors"][:, 2], ncx, ncy, ncz, pa, pb, pc, plane_dot,
            a["confidences"], pz, ext_x, ext_y]
    p = torch.stack(cols, dim=1).to(torch.float32)
    return torch.where(in_view[:, None], p, 0.0), in_view


def tile_grid(shape, rc: Raster):
    """(tiles across, tiles down)."""
    h, w = shape
    return -(-w // rc.tile_w), -(-h // rc.tile_h)


@dataclasses.dataclass
class Bins:
    """One view's entries: `gid` (M,) in (tile, depth, index) order,
    `tile` (M,) and the per-tile counts `lens` (T,); `n_trunc` the entries
    the span cap left out."""

    gid: torch.Tensor
    tile: torch.Tensor
    lens: torch.Tensor
    n_trunc: int


@torch.no_grad()
def bin_view(p: torch.Tensor, in_view: torch.Tensor, shape, rc: Raster) -> Bins:
    """The tiles each surfel covers (its span, capped at max_dup tiles by a
    centred shrink, then culled exactly where the conic's minimum over the
    tile's pixel centres puts alpha under alpha_cut), ordered by tile, then
    camera depth, then surfel index."""
    ntx, nty = tile_grid(shape, rc)
    th, tw, md = rc.tile_h, rc.tile_w, rc.max_dup
    i32 = torch.int32
    mean_x, mean_y, ext_x, ext_y = p[:, MX], p[:, MY], p[:, EXX], p[:, EXY]
    tx0 = torch.clamp(torch.floor((mean_x - ext_x) / tw), 0, ntx - 1).to(i32)
    tx1 = torch.clamp(torch.floor((mean_x + ext_x) / tw), 0, ntx - 1).to(i32)
    ty0 = torch.clamp(torch.floor((mean_y - ext_y) / th), 0, nty - 1).to(i32)
    ty1 = torch.clamp(torch.floor((mean_y + ext_y) / th), 0, nty - 1).to(i32)
    sw, sh = tx1 - tx0 + 1, ty1 - ty0 + 1
    area = sw * sh
    shrink = torch.sqrt(md / torch.clamp(area, min=1).to(torch.float32))
    sw_c = torch.where(area > md, torch.floor(sw * shrink), sw.to(torch.float32)).to(i32)
    sw_c = torch.minimum(torch.clamp(sw_c, min=1), sw)
    sh_c = torch.minimum(md // sw_c, sh)
    ctx = torch.minimum(torch.maximum((mean_x / tw).to(i32), tx0), tx1)
    cty = torch.minimum(torch.maximum((mean_y / th).to(i32), ty0), ty1)
    tx0c = torch.minimum(torch.maximum(ctx - (sw_c - 1) // 2, tx0), tx1 - sw_c + 1)
    ty0c = torch.minimum(torch.maximum(cty - (sh_c - 1) // 2, ty0), ty1 - sh_c + 1)
    n_trunc = int(torch.sum(torch.where(in_view, sw * sh - sw_c * sh_c, 0)))

    j = torch.arange(md, dtype=i32, device=p.device)[None, :]
    sel = j < torch.where(in_view, sw_c * sh_c, 0)[:, None]
    cx = tx0c[:, None] + j % sw_c[:, None]
    cy = ty0c[:, None] + j // sw_c[:, None]
    ca, cb, cc = p[:, CA, None], p[:, CB, None], p[:, CC, None]
    x0 = cx.to(torch.float32) * float(tw) + 0.5 - mean_x[:, None]
    x1 = x0 + (float(tw) - 1.0)
    y0 = cy.to(torch.float32) * float(th) + 0.5 - mean_y[:, None]
    y1 = y0 + (float(th) - 1.0)

    def edge_x(xv):
        ys = torch.minimum(torch.maximum(-cb * xv / torch.clamp(cc, min=1e-12), y0), y1)
        return ca * xv * xv + 2.0 * cb * xv * ys + cc * ys * ys

    def edge_y(yv):
        xs = torch.minimum(torch.maximum(-cb * yv / torch.clamp(ca, min=1e-12), x0), x1)
        return ca * xs * xs + 2.0 * cb * xs * yv + cc * yv * yv

    q = torch.minimum(torch.minimum(edge_x(x0), edge_x(x1)), torch.minimum(edge_y(y0), edge_y(y1)))
    q = torch.where((x0 <= 0.0) & (x1 >= 0.0) & (y0 <= 0.0) & (y1 >= 0.0), 0.0, q)
    qstar = 2.0 * torch.log(torch.clamp(p[:, OP], min=rc.alpha_cut) * (1.0 / rc.alpha_cut))
    keep = sel & (q <= qstar[:, None] + 0.05)

    g, k = torch.nonzero(keep, as_tuple=True)  # surfel-major, tiles ascending
    tile = (cy * ntx + cx)[g, k].to(torch.int64)
    o1 = torch.sort(p[g, DZ], stable=True).indices
    o2 = torch.sort(tile[o1], stable=True).indices
    order = o1[o2]
    tile = tile[order]
    return Bins(gid=g[order], tile=tile, lens=torch.bincount(tile, minlength=ntx * nty), n_trunc=n_trunc)


def _tile_blocks(bins: Bins, k: int, budget: int):
    """Blocks of tiles of similar entry counts, each padded to a whole
    number of chunks: yields (tiles (B,), gid (B, n) with -1 pads)."""
    lens = bins.lens
    starts = torch.cumsum(lens, 0) - lens
    order = torch.argsort(lens, descending=True)
    lens_s = lens[order].tolist()
    i = 0
    while i < len(lens_s) and lens_s[i] > 0:
        n = -(-lens_s[i] // k) * k
        b = max(1, budget // n)
        tiles = order[i : i + b]
        tiles = tiles[lens[tiles] > 0]
        idx = starts[tiles, None] + torch.arange(n, device=lens.device)[None, :]
        real = torch.arange(n, device=lens.device)[None, :] < lens[tiles, None]
        gid = torch.where(real, bins.gid[torch.where(real, idx, 0)], -1)
        yield tiles, gid
        i += len(tiles) if len(tiles) else b


def pixel_centres(tiles: torch.Tensor, ntx: int, rc: Raster):
    """Pixel-centre coordinates (B, 1, P) of the tiles' pixels, row-major."""
    pix = torch.arange(rc.tile_h * rc.tile_w, device=tiles.device)[None, :]
    px = ((tiles[:, None] % ntx) * rc.tile_w + pix % rc.tile_w).to(torch.float32) + 0.5
    py = ((tiles[:, None] // ntx) * rc.tile_h + pix // rc.tile_w).to(torch.float32) + 0.5
    return px[:, None, :], py[:, None, :]


def alpha_depth(e: torch.Tensor, px, py, rc: Raster):
    """(alpha, depth) of each (entry, pixel) pair, (B, n, P): alpha =
    min(alpha_max, opacity * exp(min(0, power))) zeroed under alpha_cut;
    depth from the surfel plane, clamped to [depth_lo, depth_hi] times the
    camera depth, the camera depth where the plane is edge-on."""
    col = lambda c: e[..., c : c + 1]  # noqa: E731
    dx = px - col(MX)
    dy = py - col(MY)
    power = -0.5 * (col(CA) * dx * dx + col(CC) * dy * dy) - col(CB) * dx * dy
    alpha = torch.clamp(col(OP) * torch.exp(torch.clamp(power, min=POWER_FLOOR, max=0.0)), max=rc.alpha_max)
    alpha = torch.where(alpha >= rc.alpha_cut, alpha, 0.0)
    denom = col(PA) * px + col(PB) * py + col(PC)
    ok = torch.abs(denom) > 1e-8
    t = torch.where(ok, col(PD) * (1.0 / torch.where(ok, denom, 1.0)), col(DZ))
    t = torch.minimum(torch.maximum(t, rc.depth_lo * col(DZ)), rc.depth_hi * col(DZ))
    return alpha, t


def weights(alpha: torch.Tensor, real_chunks: torch.Tensor, rc: Raster):
    """(w (B, n, P), T_final (B, 1, P), chunks done (B,)): each pair's
    weight alpha * T before it, over the chunks each tile composites (it
    stops, for the whole tile, once every pixel's transmittance is at most
    term_eps after a chunk, and after its last real chunk)."""
    b, n, p = alpha.shape
    k = rc.chunk
    nch = n // k
    one_m = (1.0 - alpha).reshape(b, nch, k, p)
    cum = torch.cumprod(one_m, dim=2)
    excl = torch.cat([torch.ones_like(cum[:, :, :1]), cum[:, :, :-1]], dim=2)
    tot = cum[:, :, -1]  # (B, nch, P)
    t_after = torch.cumprod(tot, dim=1)
    t_before = torch.cat([torch.ones_like(t_after[:, :1]), t_after[:, :-1]], dim=1)
    with torch.no_grad():
        # a tile composites chunk c while c is one of its real chunks and
        # some pixel's transmittance before it is above term_eps; T only
        # falls, so the chunks composited are a prefix
        c_idx = torch.arange(nch, device=alpha.device)[None, :]
        live = (t_before.amax(dim=2) > rc.term_eps) & (c_idx < real_chunks[:, None])
        done = live.sum(dim=1)
        use = (c_idx < done[:, None]).to(alpha.dtype)  # (B, nch)
    w = (alpha.reshape(b, nch, k, p) * excl) * t_before[:, :, None, :] * use[:, :, None, None]
    t_all = torch.cat([torch.ones_like(t_after[:, :1]), t_after], dim=1)  # T after 0..nch chunks
    t_final = torch.gather(t_all, 1, done[:, None, None].expand(b, 1, p))
    return w.reshape(b, n, p), t_final, done


def composite(p: torch.Tensor, bins: Bins, shape, rc: Raster, block_pairs: int = 1 << 23) -> dict:
    """Front-to-back composite of one view from the projected surfels `p`
    (differentiable) and their bins: {"feat" (7, h, w): colour, camera
    normal, confidence; "depth" (1, h, w); "trans" (1, h, w)}."""
    h, w = shape
    ntx, nty = tile_grid(shape, rc)
    pt = rc.tile_h * rc.tile_w
    feat_t = p.new_zeros((ntx * nty, 7, pt))
    depth_t = p.new_zeros((ntx * nty, 1, pt))
    trans_t = p.new_ones((ntx * nty, 1, pt))
    parts = []
    for tiles, gid in _tile_blocks(bins, rc.chunk, max(1, block_pairs // pt)):
        e = torch.where((gid >= 0)[..., None], p[torch.clamp(gid, min=0)], 0.0)  # (B, n, NCOL)
        px, py = pixel_centres(tiles, ntx, rc)
        alpha, t = alpha_depth(e, px, py, rc)
        real = -(-torch.clamp((gid >= 0).sum(1), min=1) // rc.chunk)
        wgt, t_final, _ = weights(alpha, real, rc)
        f = torch.cat([e[..., CR : NZ + 1], e[..., CONF : CONF + 1]], dim=-1)  # (B, n, 7)
        parts.append((tiles, torch.einsum("bnp,bnf->bfp", wgt, f), torch.sum(wgt * t, dim=1, keepdim=True), t_final))
    if parts:
        tiles = torch.cat([x[0] for x in parts])
        feat_t = feat_t.index_put((tiles,), torch.cat([x[1] for x in parts]))
        depth_t = depth_t.index_put((tiles,), torch.cat([x[2] for x in parts]))
        trans_t = trans_t.index_put((tiles,), torch.cat([x[3] for x in parts]))

    def image(x):
        c = x.shape[1]
        img = x.reshape(nty, ntx, c, rc.tile_h, rc.tile_w).permute(2, 0, 3, 1, 4)
        return img.reshape(c, nty * rc.tile_h, ntx * rc.tile_w)[:, :h, :w]

    return {"feat": image(feat_t), "depth": image(depth_t), "trans": image(trans_t)}


def render(a: dict, ext, intr, shape, rc: Raster, bins: Bins | None = None, background=None):
    """One view's images as the method outputs them: rgb (3, h, w) blended
    over `background`, depth, confidence, opacity (1, h, w) and the
    camera-space normal (3, h, w), normalised where opacity > 0.01. `bins`:
    frozen bins (the first step's), else binned here. Returns (images,
    bins)."""
    p, in_view = project(a, ext, intr, shape, rc)
    if bins is None:
        bins = bin_view(p.detach(), in_view, shape, rc)
    out = composite(p, bins, shape, rc)
    trans = out["trans"]
    rgb = out["feat"][0:3]
    if background is not None:
        rgb = rgb + trans * background[:, None, None]
    opacity = 1.0 - trans
    normal = out["feat"][3:6]
    normal = normal * torch.rsqrt(torch.clamp(torch.sum(normal * normal, dim=0, keepdim=True), min=1e-24))
    normal = normal * (opacity.detach() > 1e-2)
    return {"rgb": rgb, "depth": out["depth"], "confidence": out["feat"][6:7], "opacity": opacity,
            "normal": normal}, bins


@torch.no_grad()
def view_stats(a: dict, ext, intr, shape, rc: Raster, mask: torch.Tensor, weight_thres: float,
               block_pairs: int = 1 << 23):
    """Per-surfel (importance (N,), count (N,)) of one view, front-facing
    surfels only: importance sums w * mask over the pixels each surfel
    reaches, count the pixels where w * mask >= weight_thres; w is the
    compositing weight alpha * T."""
    p, in_view = project(a, ext, intr, shape, rc, front_only=True)
    bins = bin_view(p, in_view, shape, rc)
    ntx, _ = tile_grid(shape, rc)
    h, w = shape
    pt = rc.tile_h * rc.tile_w
    n = p.shape[0]
    imp = torch.zeros(n, dtype=torch.float64, device=p.device)
    cnt = torch.zeros(n, dtype=torch.int64, device=p.device)
    for tiles, gid in _tile_blocks(bins, rc.chunk, max(1, block_pairs // pt)):
        e = torch.where((gid >= 0)[..., None], p[torch.clamp(gid, min=0)], 0.0)
        px, py = pixel_centres(tiles, ntx, rc)
        alpha, _ = alpha_depth(e, px, py, rc)
        real = -(-torch.clamp((gid >= 0).sum(1), min=1) // rc.chunk)
        wgt, _, _ = weights(alpha, real, rc)
        xi = px[:, 0, :].to(torch.int64)
        yi = py[:, 0, :].to(torch.int64)
        inside = (xi < w) & (yi < h)
        m = torch.where(inside, mask[torch.clamp(yi, max=h - 1), torch.clamp(xi, max=w - 1)], 0.0)[:, None, :]
        wm = wgt * m
        g = torch.clamp(gid, min=0).reshape(-1)
        real_e = (gid >= 0).reshape(-1)
        imp.index_add_(0, g[real_e], wm.sum(-1).reshape(-1)[real_e].double())
        cnt.index_add_(0, g[real_e], (wm >= weight_thres).sum(-1).reshape(-1)[real_e])
    return imp.to(torch.float32), cnt
