"""`MapConfig.resample_per_step`: the port's per-step redraw and re-bin
against the reference's (`activegs_tpu/mapping/trainer.py:502-522`).

The two packages draw from different random streams (`jax.random` against
`torch.Generator`), so the port is given the reference's own draws through
`train_keyframe`'s `draw` hook: the key-split sequence of the reference's
loop, each draw made by the reference's sampler on the performance as it
stands in the port's buffer at that step. At 64x64 on the CPU, with the
reference's Pallas kernels in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from activegs_torch.config import build_components, load_config
from activegs_torch.mapping import gaussians as tgm
from activegs_torch.mapping import trainer as ttr
from activegs_torch.mapping.mapper import mapping_step
from activegs_tpu.config import build_components as j_build_components
from activegs_tpu.config import load_config as j_load_config
from activegs_tpu.mapping import gaussians as jgm
from activegs_tpu.mapping import keyframes as jkf
from activegs_tpu.mapping import trainer as jtr
from activegs_tpu.sim import synthetic as jsyn
from test_mapping import look_at_pose
from test_torch_core import t_like
from test_torch_mapping import MAPCFG, POSES, RASTER, RES, T_RASTER, t_buffer, t_frame, t_state

torch.set_num_threads(2)

# 5 keyframes, 2 of them active: each step's batch of 4 takes the 2 latest
# and 2 of the 3 older frames by their performance, so the draws matter
CFG = dataclasses.replace(MAPCFG, batch_size=4, active_size=2, resample_per_step=True)
T_CFG = t_like(tgm.MapConfig, CFG)
STEPS = 3


@pytest.fixture(scope="module")
def setup():
    """The reference's state after spawning two frames, a buffer of five
    frames, and its resampled keyframe of STEPS steps from key 5."""
    sim = jsyn.BoxRoomSimulator(resolution=(RES, RES), seed=3, depth_noise_co=0.0)
    poses = [*POSES, look_at_pose((3.1, 2.6, 1.4), (5.5, 3.5, 1.1))]
    frames = [sim.simulate(p) for p in poses]
    state = jgm.init_state(CFG)
    buf = jkf.init_buffer(8, RES, RES)
    for i, f in enumerate(frames):
        if i < 2:
            state, _, _ = jgm.spawn(state, f, CFG, RASTER)
        buf = jkf.add_frame(buf, f)
    key = jax.random.PRNGKey(5)
    want = jtr.train_keyframe(state, buf, key, CFG, RASTER, steps=STEPS)
    return frames, state, buf, key, want


class ReferenceDraws:
    """The reference loop's draws, for the port's `draw` hook: split the
    key, then sample with the reference's weighted sampler on the
    performance that the port's buffer holds now."""

    def __init__(self, key, jbuf):
        self.key, self.jbuf, self.drawn = key, jbuf, []

    def __call__(self, tbuf):
        self.key, k1 = jax.random.split(self.key)
        jb = dataclasses.replace(self.jbuf, performance=jnp.asarray(tbuf.performance.numpy()))
        ids = np.asarray(jkf.sample_weighted(jb, k1, CFG.batch_size, CFG.active_size))
        self.drawn.append(ids)
        return ttr.batch_views(torch.from_numpy(ids.copy()).long())


def test_resampled_keyframe_matches_reference(setup):
    """Performance within 1e-5, the last loss at relative 1e-4, aux -1 (no
    truncation telemetry) and parameters within 1e-4 scaled, with the
    reference's draws; the batches differ from step to step.

    Adam's update is about lr * sign(g) (eps = 1e-15), so an element whose
    gradient is within rounding of zero can move the other way in the
    other package. Here that leaves within 1e-4 scaled 99.94% of `means`,
    99.89% of `rotations_raw`, 97.58% of `opacities_raw` and all of the
    other fields (the frozen keyframe on the same data and draws: 99.91%,
    99.55%, 92.55%). So each field is held at 1e-4 scaled at >= 97% of its
    elements, and every element within 2 * lr * steps, the most such
    flips can move it."""
    _, state, buf, key, (s_j, b_j, l_j, aux_j) = setup
    draws = ReferenceDraws(key, buf)
    s_t, b_t, l_t, aux_t = ttr.train_keyframe(t_state(state), t_buffer(buf), None, T_CFG, T_RASTER, steps=STEPS,
                                              draw=draws)
    assert len(draws.drawn) == STEPS
    assert len({tuple(sorted(set(d.tolist()))) for d in draws.drawn}) > 1, draws.drawn
    assert aux_t == {"num_dropped": -1, "num_entries": -1}
    assert int(aux_j["num_dropped"]) == -1 and int(aux_j["num_entries"]) == -1
    assert float(l_t) == pytest.approx(float(l_j), rel=1e-4)
    np.testing.assert_allclose(b_t.performance.numpy(), np.asarray(b_j.performance), atol=1e-5, rtol=0)
    n = state.count
    for f in ttr.PARAM_FIELDS:
        want = np.asarray(getattr(s_j, f))[:n]
        diff = np.abs(getattr(s_t, f)[:n].numpy() - want)
        assert np.mean(diff <= 1e-4 * np.abs(want).max()) >= 0.97, (f, np.mean(diff <= 1e-4 * np.abs(want).max()))
        assert diff.max() <= 2 * getattr(T_CFG, ttr._LR[f]) * STEPS * 1.001, (f, diff.max())
    moved = (s_t.means - t_state(state).means).abs().max()
    assert float(moved) > 0


def test_resampling_draws_from_the_generator(setup):
    """Without a `draw` hook every step draws `draw_batch` from the
    generator; the frozen path's arguments (`views`, buckets) are not
    read."""
    _, state, buf, _, _ = setup
    got = ttr.train_keyframe(t_state(state), t_buffer(buf), None, T_CFG, T_RASTER, steps=2,
                             generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    drawn = []

    def draw(b):
        drawn.append(ttr.draw_batch(b, T_CFG, g))
        return drawn[-1]

    want = ttr.train_keyframe(t_state(state), t_buffer(buf), (torch.tensor([0]), torch.tensor([1])), T_CFG, T_RASTER,
                              steps=2, subset_bucket=64, entry_budget=16, draw=draw)
    assert len(drawn) == 2
    for f in tgm.FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    assert torch.equal(got[1].performance, want[1].performance) and torch.equal(got[2], want[2])


def test_mapping_step_with_resampling(setup):
    """`mapping_step` under the flag: no view stats or buckets, telemetry
    -1, a finite loss, and every draw from the mapper's generator."""
    frames, state, buf, _, _ = setup
    gen = torch.Generator().manual_seed(0)
    t_buf = t_buffer(buf)
    t_buf.count = 4  # the fifth frame comes with the step
    st, b, stats = mapping_step(t_state(state), t_buf, t_frame(frames[4]), dataclasses.replace(T_CFG,
                                optimization_steps=2), T_RASTER, gen)
    assert b.count == 5 and np.isfinite(stats["loss"]) and stats["n_gaussians"] == st.count > state.count
    assert (stats["num_dropped"], stats["num_entries"], stats["dropped_frac"]) == (-1, -1, -1.0)
    assert stats["subset_bucket"] is None and stats["entry_budget"] is None
    # two steps, one draw of `capacity` uniforms each
    g2 = torch.Generator().manual_seed(0)
    torch.rand(2 * b.capacity, generator=g2)
    assert torch.equal(gen.get_state(), g2.get_state())


@pytest.mark.parametrize("overrides, want", [([], False), (["mapper.gaussian_map.resample_per_step=true"], True)])
def test_build_components_passes_resample_per_step(overrides, want):
    """The port's loader reads the key (the reference's never does, so its
    flag stays at the default, False)."""
    assert build_components(load_config("main", overrides))["map_cfg"].resample_per_step is want
    assert j_build_components(j_load_config("main", overrides))["map_cfg"].resample_per_step is False
