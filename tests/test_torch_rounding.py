"""Where the port and the reference round apart: XLA on the CPU contracts a
multiply and an add into one fused multiply-add (one rounding), while the
port, like the expression as written, rounds the product and the sum each.

Each test takes one expression the two packages write alike, evaluates it
on the reference's inputs two ways in numpy, the plain float32 way and as a
fused multiply-add (the product and sum in float64, rounded once to
float32), and shows which one the reference's own value matches:

- the camera z of `render/preprocess.py` (the depth-sort key);
- the cross products of the surfel frames (`core/quaternions.py`, and the
  normals of `core/image_ops.py::depth_to_normal`);
- the ray-cast hit point o + d t of `sim/synthetic.py::_raycast`, read
  through the 20 cm checker tint of the reference's rgb.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from activegs_torch.core import quaternions as tq
from activegs_torch.render import preprocess as tpp
from activegs_torch.render import types as tt
from activegs_tpu.core import geometry as jgeo
from activegs_tpu.render import preprocess as jpp
from activegs_tpu.render.types import Camera, GaussianAttrs, RasterConfig
from activegs_tpu.sim import synthetic as jsyn
from test_mapping import look_at_pose
from test_torch_core import t_attrs, t_cam

F32 = np.float32


def fma(a, b, c) -> np.ndarray:
    """a * b + c with one rounding to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(F32)


def room_points(n=20000, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 6, n), rng.uniform(0, 5, n), rng.uniform(0, 3, n)], 1).astype(F32)


def test_depth_key_is_a_contracted_multiply_add():
    """pz = r20*mx + r21*my + r22*mz + t2: the reference's value is
    fma(r22, mz, fma(r21, my, r20*mx)) + t2 at every point; the plain
    float32 chain, which the port computes bitwise, differs at a few % of
    them by an ulp, so equal-depth entries may sort apart."""
    means = room_points()
    n = len(means)
    ext = look_at_pose((3.0, 2.5, 1.5), (5.5, 2.5, 1.2))
    intr = np.asarray(jgeo.intrinsics_from_fov(60.0, 60.0))
    attrs = GaussianAttrs(
        means=jnp.asarray(means), scales=jnp.full((n, 3), 0.01), rotations=jnp.tile(jnp.array([1.0, 0, 0, 0]), (n, 1)),
        opacities=jnp.full((n,), 0.5), colors=jnp.zeros((n, 3)), confidences=jnp.zeros(n), valid=jnp.ones(n, bool),
    )
    cam = Camera(jnp.asarray(ext), jnp.asarray(intr))
    ref = np.asarray(jax.jit(lambda a, c: jpp.preprocess(a, c, (64, 64), RasterConfig()))(attrs, cam)[2])
    r = np.asarray(jax.jit(jgeo.invert_rigid)(jnp.asarray(ext)))[2]
    mx, my, mz = means.T
    plain = ((r[0] * mx + r[1] * my) + r[2] * mz) + r[3]
    fused = fma(r[2], mz, fma(r[1], my, r[0] * mx)) + r[3]
    print(f"\ndepth key: reference = fused at {np.mean(ref == fused):.4f}, = plain at {np.mean(ref == plain):.4f}")
    np.testing.assert_array_equal(ref, fused)
    assert np.mean(ref == plain) < 0.99
    _, _, port, _ = tpp.preprocess(t_attrs(attrs), t_cam(cam), (64, 64), tt.RasterConfig())
    np.testing.assert_array_equal(port.numpy(), plain)


def test_cross_product_is_a_contracted_multiply_add():
    """c0 = a1*b2 - a2*b1 (and its rotations): the reference's jitted
    cross product is fma(a1, b2, -(a2*b1)) everywhere; the plain float32
    form, the port's, differs in the last bit at about a quarter of the
    components, which the surfel frames carry into the spawn quaternions."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(20000, 3)).astype(F32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b = rng.normal(size=(20000, 3)).astype(F32)
    ref = np.asarray(jax.jit(jnp.cross)(jnp.asarray(a), jnp.asarray(b)))
    a0, a1, a2 = a.T
    b0, b1, b2 = b.T
    plain = np.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], 1)
    fused = np.stack([fma(a1, b2, -(a2 * b1)), fma(a2, b0, -(a0 * b2)), fma(a0, b1, -(a1 * b0))], 1)
    print(f"\ncross: reference = fused at {np.mean(ref == fused):.4f}, = plain at {np.mean(ref == plain):.4f}")
    np.testing.assert_array_equal(ref, fused)
    assert np.mean(ref == plain) < 0.9
    np.testing.assert_array_equal(tq.cross(torch.from_numpy(a), torch.from_numpy(b)).numpy(), plain)


def test_raycast_hit_point_is_a_contracted_multiply_add():
    """p = o + d t: the reference's rgb carries the 20 cm checker parity of
    its hit point. Recomputed from the fused p (one rounding), the rgb
    matches the reference at every pixel to rounding; from the plain p, the
    checker flips at the pixels where the two p's straddle a checker line
    (walls sit exactly on them). So the checker-line flips between the
    simulators are the reference's rounding of p and of t, whose dot
    products XLA contracts too."""
    sim = jsyn.BoxRoomSimulator(resolution=(64, 64), seed=11, depth_noise_co=0.0)
    for target in ((5.0, 4.0, 1.0), (0.2, 0.2, 0.2)):
        pose = look_at_pose((3.0, 2.5, 1.5), target)
        frame = sim.simulate(pose, require_gt=True)
        t = np.asarray(frame["depth"][0]).reshape(-1)
        coords = np.asarray(jgeo.pixel_grid(64, 64)).reshape(-1, 2)
        o, d = jax.jit(jgeo.get_world_rays)(jnp.asarray(coords), jnp.asarray(pose), jnp.asarray(sim.intrinsic))
        o, d = np.asarray(o)[0], np.asarray(d)
        plain = o[None] + (d * t[:, None]).astype(F32)
        fused = fma(d, t[:, None], np.broadcast_to(o[None], d.shape))
        rgb = np.asarray(frame["rgb"]).reshape(3, -1).T
        hit = t > 0

        def checker(p):
            return (np.floor(p[:, 0] / F32(0.2)) + np.floor(p[:, 1] / F32(0.2)) + np.floor(p[:, 2] / F32(0.2))) % 2

        def rgb_err(p):
            """Per pixel, the least error over the 5 materials of the rgb
            this hit point gives."""
            tint = F32(0.85) + F32(0.15) * checker(p).astype(F32)
            wave = F32(0.08) * np.sin(F32(7.0) * p[:, 0]) * np.cos(F32(5.0) * p[:, 1] + F32(3.0) * p[:, 2])
            c = np.clip(jsyn._BASE_COLORS[None] * tint[:, None, None] + wave[:, None, None], 0, 1)
            return np.abs(c - rgb[:, None, :]).max(-1).min(-1)

        apart = hit & (checker(plain) != checker(fused))
        e_fused, e_plain = rgb_err(fused), rgb_err(plain)
        print(f"\nhit point, target {target}: {apart.sum()} pixels straddle a checker line; "
              f"rgb err fused {e_fused[hit].max():.2g}, plain {e_plain[apart].min():.2g} there")
        assert apart.sum() > 0
        assert e_fused[hit].max() < 1e-5
        assert e_plain[apart].min() > 0.05
