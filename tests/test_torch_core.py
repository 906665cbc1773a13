"""Parity of the PyTorch port's core math with the JAX reference.

Geometry, quaternions, image operators and the mapping losses: the same
numpy inputs go through the `activegs_tpu` function and its `activegs_torch`
counterpart (on the CPU), values to float32 rounding (rtol 1e-5, atol 1e-6
unless a case says otherwise) and gradients against `jax.vjp`.

The helpers at the top (`to_t`, `t_attrs`, ...) are shared by the other
`test_torch_*.py` files.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activegs_torch.core import geometry as tgeo
from activegs_torch.core import image_ops as timg
from activegs_torch.core import quaternions as tquat
from activegs_torch.mapping import losses as tloss
from activegs_torch.render import types as ttypes
from activegs_tpu.core import geometry as jgeo
from activegs_tpu.core import image_ops as jimg
from activegs_tpu.core import quaternions as jquat
from activegs_tpu.mapping import losses as jloss

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# shared helpers: reference objects -> port objects on the CPU
# ---------------------------------------------------------------------------


def to_t(a) -> torch.Tensor:
    """Any array (numpy or JAX) -> a CPU tensor with the same values."""
    return torch.from_numpy(np.array(a))


def t_attrs(a) -> ttypes.GaussianAttrs:
    return ttypes.GaussianAttrs(**{f.name: to_t(getattr(a, f.name)) for f in dataclasses.fields(ttypes.GaussianAttrs)})


def t_cam(c) -> ttypes.Camera:
    return ttypes.Camera(extrinsic=to_t(c.extrinsic), intrinsic=to_t(c.intrinsic))


def t_like(cls, ref_cfg):
    """The port's config dataclass `cls` with every field copied from the
    reference config `ref_cfg`."""
    return cls(**{f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(cls)})


def assert_close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def assert_scaled(got, want, atol=3e-4, msg=""):
    """Gradient contract: agreement to `atol` after scaling both by max|want|."""
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-8
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g / scale, want / scale, atol=atol, err_msg=msg)


def random_rigid(rng) -> np.ndarray:
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    e = np.eye(4, dtype=np.float32)
    e[:3, :3] = np.asarray(jquat.quaternion_to_matrix(jnp.asarray(q, jnp.float32)))
    e[:3, 3] = rng.uniform(-2, 2, 3)
    return e


def smooth_depth(rng, h=24, w=20) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = 2.0 + 0.03 * xx + 0.02 * yy + 0.05 * np.sin(xx / 3.0) + rng.normal(0, 0.01, (h, w))
    return d.astype(np.float32)


K = np.asarray(jgeo.intrinsics_from_fov(55.0, 65.0))


# ---------------------------------------------------------------------------
# geometry and quaternions: (reference fn, port fn, numpy args) per case
# ---------------------------------------------------------------------------


def _cases():
    rng = np.random.default_rng(0)
    e = random_rigid(rng)
    coords = rng.uniform(0, 1, (50, 2)).astype(np.float32)
    z = rng.uniform(0.5, 4, 50).astype(np.float32)
    pts = rng.uniform(-3, 3, (50, 3)).astype(np.float32)
    rot = np.asarray(jquat.quaternion_to_matrix(jnp.asarray(rng.normal(size=(8, 4)), jnp.float32)))
    rot = rot / np.linalg.norm(rot, axis=-2, keepdims=True)
    quats = rng.normal(size=(40, 4)).astype(np.float32)
    normals = rng.normal(size=(40, 3)).astype(np.float32)
    normals[0] = (0.0, 0.0, 1.0)  # collinear with the reference axis
    normals[1] = (0.999, 0.0, 0.02)
    mats = np.asarray(jquat.quaternion_to_matrix(jquat.normalize(jnp.asarray(quats))))
    dirs = rng.normal(size=(40, 3)).astype(np.float32)
    dirs[0] = (0.0, 0.0, -1.0)  # straight down: the collinear branch
    depth = smooth_depth(rng)
    fov = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    ts = np.linspace(0, 1, 7, dtype=np.float32)
    v1 = rng.normal(size=3).astype(np.float32)
    v2 = rng.normal(size=3).astype(np.float32)
    return {
        "apply_rotation": (jgeo.apply_rotation, tgeo.apply_rotation, (rot, rng.normal(size=(8, 3)).astype(np.float32))),
        "fov_to_focal": (jgeo.fov_to_focal, tgeo.fov_to_focal, (fov, 64)),
        "focal_to_fov": (lambda f, p: jgeo.focal_to_fov(f, p), tgeo.focal_to_fov, (fov * 50, 64)),
        "fov_from_intrinsics": (jgeo.fov_from_intrinsics, tgeo.fov_from_intrinsics, (K,)),
        "pixel_grid": (lambda: jgeo.pixel_grid(7, 5), lambda: tgeo.pixel_grid(7, 5, device="cpu"), ()),
        "invert_rigid": (jgeo.invert_rigid, tgeo.invert_rigid, (e,)),
        "unproject": (jgeo.unproject, tgeo.unproject, (coords, z, K)),
        "get_world_rays": (jgeo.get_world_rays, tgeo.get_world_rays, (coords, e, K)),
        "project_points": (jgeo.project_points, tgeo.project_points, (pts, e, K)),
        "backproject_depth": (jgeo.backproject_depth, tgeo.backproject_depth, (depth, e, K)),
        "normalize": (jquat.normalize, tquat.normalize, (quats,)),
        "quaternion_to_matrix": (jquat.quaternion_to_matrix, tquat.quaternion_to_matrix, (quats / np.linalg.norm(quats, axis=1, keepdims=True),)),
        "matrix_to_quaternion": (jquat.matrix_to_quaternion, tquat.matrix_to_quaternion, (mats,)),
        "normal_to_quaternion": (jquat.normal_to_quaternion, tquat.normal_to_quaternion, (normals,)),
        "rotation_from_z": (jquat.rotation_from_z, tquat.rotation_from_z, (dirs,)),
        "slerp_vec": (jquat.slerp_vec, tquat.slerp_vec, (v1, v2, ts)),
        # parallel vectors: the fallback branch
        "slerp_vec_parallel": (jquat.slerp_vec, tquat.slerp_vec, (v1, 2 * v1, ts)),
    }


CASES = _cases()


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name", list(CASES))
def test_core_function_matches_reference(name):
    jfn, tfn, args = CASES[name]
    want = _flat(jfn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    got = _flat(tfn(*[to_t(a) if isinstance(a, np.ndarray) else a for a in args]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert_close(g, w, atol=2e-6, msg=name)


def test_intrinsics_from_fov():
    # bitwise at the simulator's 60 degrees; elsewhere numpy's and XLA's tan
    # may round one ulp apart
    np.testing.assert_array_equal(
        tgeo.intrinsics_from_fov(60.0, 60.0, device="cpu").numpy(), np.asarray(jgeo.intrinsics_from_fov(60.0, 60.0))
    )
    assert_close(tgeo.intrinsics_from_fov(55.0, 72.5, device="cpu"), jgeo.intrinsics_from_fov(55.0, 72.5), rtol=3e-7, atol=0)


def test_look_at_matches_reference_pose():
    from test_mapping import look_at_pose

    for pos, target in (((3.0, 2.5, 1.5), (5.5, 2.5, 1.2)), ((3.2, 2.3, 1.5), (1.0, 4.0, 0.5))):
        assert_close(tgeo.look_at(pos, target, device="cpu"), look_at_pose(pos, target), atol=1e-6)


def test_entry_points_default_to_cuda():
    # no silent drop to the CPU: a CUDA-default call raises without a card
    if torch.cuda.is_available():
        assert tgeo.pixel_grid(2, 2).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tgeo.pixel_grid(2, 2)


# ---------------------------------------------------------------------------
# image operators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_holes", [False, True], ids=["full", "holes"])
def test_depth_to_normal_value_and_grad(with_holes):
    rng = np.random.default_rng(1)
    depth = smooth_depth(rng)
    mask = np.ones(depth.shape, bool)
    if with_holes:
        mask = rng.uniform(size=depth.shape) > 0.2
    cot = rng.normal(size=depth.shape + (3,)).astype(np.float32)
    want, vjp = jax.vjp(lambda d: jimg.depth_to_normal(d, jnp.asarray(mask), jnp.asarray(K)), jnp.asarray(depth))
    (want_g,) = vjp(jnp.asarray(cot))
    d_t = to_t(depth).requires_grad_(True)
    got = timg.depth_to_normal(d_t, to_t(mask), to_t(K))
    (got_g,) = torch.autograd.grad(got, d_t, to_t(cot))
    assert_close(got, want, atol=2e-6)
    assert_scaled(got_g, want_g)


@pytest.mark.parametrize("radius", [2, 7])
def test_bilateral_filter(radius):
    rng = np.random.default_rng(2)
    depth = smooth_depth(rng)
    depth[5:9, 3:6] += 1.5  # an edge the filter must keep
    depth[rng.uniform(size=depth.shape) < 0.1] = -1.0  # sentinels stay
    depth[0, :4] = -2.0
    want = jimg.bilateral_filter(jnp.asarray(depth), radius=radius)
    got = timg.bilateral_filter(to_t(depth), radius=radius)
    assert_close(got, want, atol=1e-5)
    np.testing.assert_array_equal(got.numpy() < 0, np.asarray(want) < 0)


def test_central_diff_sq():
    x = np.random.default_rng(3).normal(size=(2, 3, 9, 11)).astype(np.float32)
    assert_close(timg.central_diff_sq(to_t(x)), jimg.central_diff_sq(jnp.asarray(x)))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _loss_inputs():
    rng = np.random.default_rng(4)
    v, h, w = 2, 9, 11
    normals = rng.normal(size=(v, 3, h, w)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    depths = rng.uniform(1, 2, (v, 1, h, w)).astype(np.float32)
    depths[:, :, 2:6, 3:8] = 1.5  # flat patches pass the depth gate
    mask = (rng.uniform(size=(v, 1, h, w)) > 0.3).astype(np.float32)
    other = rng.normal(size=(v, 3, h, w)).astype(np.float32)
    return normals, depths, mask, other


def test_l1_and_consistency_loss():
    normals, depths, mask, other = _loss_inputs()
    assert_close(
        tloss.l1_masked(to_t(normals), to_t(other), to_t(mask) > 0),
        jloss.l1_masked(jnp.asarray(normals), jnp.asarray(other), jnp.asarray(mask) > 0),
    )
    assert_close(
        tloss.consistency_loss(to_t(normals), to_t(other)),
        jloss.consistency_loss(jnp.asarray(normals), jnp.asarray(other)),
    )


def test_normal_tv_loss_value_and_grad():
    normals, depths, mask, _ = _loss_inputs()
    want, vjp = jax.vjp(lambda n: jloss.normal_tv_loss(n, jnp.asarray(depths), jnp.asarray(mask)), jnp.asarray(normals))
    (want_g,) = vjp(jnp.float32(1.0))
    n_t = to_t(normals).requires_grad_(True)
    got = tloss.normal_tv_loss(n_t, to_t(depths), to_t(mask))
    (got_g,) = torch.autograd.grad(got, n_t)
    assert_close(got, want)
    assert_scaled(got_g, want_g)


def test_total_from_view_terms():
    terms = [np.random.default_rng(5 + i).uniform(size=3).astype(np.float32) for i in range(4)]
    assert_close(
        tloss.total_from_view_terms(*map(to_t, terms)), jloss.total_from_view_terms(*map(jnp.asarray, terms))
    )
    assert (tloss.W_DEPTH, tloss.W_CONS, tloss.W_TV) == (jloss.W_DEPTH, jloss.W_CONS, jloss.W_TV)
