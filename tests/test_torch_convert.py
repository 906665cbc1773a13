"""Checkpoints of the original ActiveGS system: the port's
`io/convert_reference.py` against the reference's.

The `.th` file is built here, as the reference's test builds it
(`tests/test_apps.py:277-330`): a flat dict of raw tensors and scalars
saved with `torch.save`.
"""

import os

import numpy as np
import pytest
import torch

from activegs_torch.io import checkpoint as tckpt
from activegs_torch.io import convert_reference as tconv
from activegs_torch.mapping import gaussians as tgm
from activegs_tpu.io import checkpoint as jckpt
from activegs_tpu.io import convert_reference as jconv

N = 100


@pytest.fixture
def th_file(tmp_path):
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    ref = {
        "means": f(N, 3),
        "scales": f(N, 3),
        "harmonics": torch.from_numpy(rng.uniform(0, 1, (N, 1, 3)).astype(np.float32)),
        "opacities": f(N, 1),
        "rotations": f(N, 4),
        "view_scores": torch.from_numpy(rng.uniform(0, 2, N).astype(np.float32)),
        "view_supports": torch.ones(N),
        "view_means": f(N, 3),
        "near": 0.0,
        "far": 5.0,
        "use_view_direction": True,
        "background_color": [0.0, 0.0, 0.0],
        "scale_factor": 0.01,
    }
    path = str(tmp_path / "map_final.th")
    torch.save(ref, path)
    return path, ref


def npz_arrays(path):
    with np.load(path, allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


def test_convert_writes_the_references_npz(th_file, tmp_path):
    """The two packages' `convert` write npz files with the same keys and
    every array, the metadata string too, bitwise equal."""
    src, ref = th_file
    got, want = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    assert tconv.convert(src, got) == N == jconv.convert(src, want)
    a, b = npz_arrays(got), npz_arrays(want)
    assert set(a) == set(b) == {*tgm.FIELDS, "meta"}
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(a["colors"], ref["harmonics"].numpy()[:, 0])
    np.testing.assert_array_equal(a["opacities_raw"], ref["opacities"].numpy()[:, 0])


def test_reference_to_state_matches_reference(th_file):
    """`reference_to_state`: the same live fields, capacity and map config
    as the reference's."""
    src, _ = th_file
    st, cfg = tconv.reference_to_state(tconv.load_reference_map(src), device="cpu")
    jst, jcfg = jconv.reference_to_state(jconv.load_reference_map(src))
    assert st.count == int(jst.count) == N and st.capacity == jst.capacity == cfg.capacity == jcfg.capacity
    assert (cfg.scale_factor, cfg.background) == (jcfg.scale_factor, jcfg.background)
    for k in tgm.FIELDS:
        np.testing.assert_array_equal(getattr(st, k).numpy(), np.asarray(getattr(jst, k)), err_msg=k)
    with pytest.raises(ValueError, match="capacity"):
        tconv.reference_to_state(tconv.load_reference_map(src), capacity=64, device="cpu")


def test_state_to_reference_matches_reference_and_round_trips(th_file, tmp_path):
    """`state_to_reference` writes the reference's keys, values and tensor
    shapes; `.th` -> npz -> `load_gaussian_map` -> `.th` -> npz gives the
    map back bitwise."""
    src, _ = th_file
    st, cfg = tconv.reference_to_state(tconv.load_reference_map(src), device="cpu")
    jst, jcfg = jconv.reference_to_state(jconv.load_reference_map(src))
    got, want = str(tmp_path / "port.th"), str(tmp_path / "ref.th")
    tconv.state_to_reference(st, cfg, got)
    jconv.state_to_reference(jst, jcfg, want)
    a, b = (torch.load(p, map_location="cpu", weights_only=False) for p in (got, want))
    assert list(a) == list(b)
    for k in a:
        if isinstance(b[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k

    npz = str(tmp_path / "round.npz")
    tconv.convert(got, npz)
    back, _ = tckpt.load_gaussian_map(npz, device="cpu")
    assert back.count == N
    for k in tgm.FIELDS:
        assert torch.equal(getattr(back, k)[:N], getattr(st, k)[:N]), k
    # the reference reads the port's npz bitwise too
    jback, _ = jckpt.load_gaussian_map(npz)
    for k in tgm.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jback, k))[:N], getattr(st, k)[:N].numpy(), err_msg=k)


def test_command_line(th_file, tmp_path, capsys):
    src, _ = th_file
    dst = str(tmp_path / "cli.npz")
    assert tconv.main([src, dst]) == 0
    assert f"converted {N} gaussians" in capsys.readouterr().out
    assert os.path.exists(dst)
    assert tconv.main([src]) == 1
    assert "usage" in capsys.readouterr().out
