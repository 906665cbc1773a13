"""The port's mapping step as a whole.

- The port alone reruns the reference's quality-gate recipe
  (`tests/test_quality_gate.py`: seed 11, 3 keyframes x 15 steps, capacity
  8192, noise-free 64 x 64 boxroom) and must clear the same bars.
- One whole keyframe (spawn -> train_keyframe -> post_process) runs through
  both packages from the same carried-over state with the reference's drawn
  batch injected: equal spawn counts, held-out PSNR within 0.1 dB.
- The port and `chip_smoke.py` import no JAX.
"""

import math
import pathlib
import subprocess
import sys

import jax
import numpy as np
import torch

from activegs_torch.core import geometry as tgeo
from activegs_torch.mapping import gaussians as tgm
from activegs_torch.mapping import keyframes as tkf
from activegs_torch.mapping import trainer as ttr
from activegs_torch.render import types as tt
from activegs_torch.render.renderer import render_view as t_render_view
from activegs_torch.sim.synthetic import BoxRoomSimulator as TSim
from activegs_tpu.eval import metrics
from activegs_tpu.mapping import gaussians as jgm
from activegs_tpu.mapping import keyframes as jkf
from activegs_tpu.mapping import trainer as jtr
from activegs_tpu.render.renderer import render_view as j_render_view
from activegs_tpu.render.types import Camera
from activegs_tpu.sim.synthetic import BoxRoomSimulator as JSim
from test_quality_gate import MAPCFG, PINNED_DEPTH_MSE, PINNED_PSNR, RASTER, RES
from test_torch_core import t_like, to_t
from test_torch_mapping import ref_batch_ids, t_buffer, t_frame, t_state

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
T_RASTER = t_like(tt.RasterConfig, RASTER)
T_MAPCFG = t_like(tgm.MapConfig, MAPCFG)
TRAIN_TARGETS = [((3.0, 2.5, 1.5), (5.5, 2.5, 1.2)), ((3.0, 2.5, 1.5), (5.0, 4.0, 1.0)), ((3.2, 2.3, 1.5), (5.5, 2.0, 1.5))]
TEST_TARGET = ((3.1, 2.6, 1.4), (5.4, 3.0, 1.2))


def psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    return -10.0 * math.log10(float(np.mean((pred - gt) ** 2)) + 1e-8)


def t_psnr_depth(state, frame):
    out, _ = t_render_view(
        tgm.attrs_of(state, T_MAPCFG), tt.Camera(frame["extrinsic"], frame["intrinsic"]), (RES, RES), T_RASTER
    )
    d, d_gt = out.depth[0].numpy(), frame["depth"][0].numpy()
    mask = d_gt > 0
    return psnr(out.rgb.numpy(), frame["rgb"].numpy()), float(np.mean((d - d_gt)[mask] ** 2))


def test_port_quality_gate():
    """`test_quality_gate.test_mission_quality_pinned`, the port alone: its
    simulator, its sampler (a torch.Generator seeded 11), its trainer."""
    sim = TSim(resolution=(RES, RES), seed=11, depth_noise_co=0.0, device="cpu")
    state = tgm.init_state(T_MAPCFG, device="cpu")
    buf = tkf.init_buffer(8, RES, RES, device="cpu")
    gen = torch.Generator().manual_seed(11)
    for pos, target in TRAIN_TARGETS:
        f = sim.simulate(tgeo.look_at(pos, target, device="cpu"), require_gt=True)
        state, _, _ = tgm.spawn(
            state, f, T_MAPCFG, T_RASTER, render_bucket=tgm.bucket_capacity(state.count, T_MAPCFG.capacity, min_cap=1024)
        )
        buf = tkf.add_frame(buf, f)
        views = ttr.draw_batch(buf, T_MAPCFG, gen)
        state, buf, loss, _ = ttr.train_keyframe(state, buf, views, T_MAPCFG, T_RASTER, steps=15)
        assert math.isfinite(float(loss))
    gt = sim.simulate(tgeo.look_at(*TEST_TARGET, device="cpu"), require_gt=True)
    p, depth_mse = t_psnr_depth(state, gt)
    print(f"\nport quality gate: psnr={p:.3f} dB, depth_mse={depth_mse:.5f}")
    assert p > PINNED_PSNR - 0.5, f"PSNR regressed: {p:.2f} dB"
    assert depth_mse < PINNED_DEPTH_MSE * 1.5, f"depth MSE regressed: {depth_mse:.5f}"


def _mapping_step_ref(state, buf, frame, key):
    """The mapping half of the reference's `_step_inner` (mapper.py:139-219)."""
    cap = MAPCFG.capacity
    state, n_new, _ = jgm.spawn(state, frame, MAPCFG, RASTER, render_bucket=jgm.bucket_capacity(int(state.count), cap, min_cap=1024))
    buf = jkf.add_frame(buf, frame)
    max_iv, max_e = (int(x) for x in jtr.keyframe_view_stats(state, buf, key, MAPCFG, RASTER))
    state, buf, loss, _ = jtr.train_keyframe(
        state, buf, key, MAPCFG, RASTER,
        subset_bucket=jtr.pick_subset_bucket(max_iv, cap), entry_budget=jtr.pick_entry_bucket(max_e),
    )
    iv, ents = (int(x) for x in jtr.stats_view_budgets(state, buf, MAPCFG, RASTER, require_prune=True))
    state, n_pruned = jtr.post_process(
        state, buf, frame["depth_range"][1], MAPCFG, RASTER, require_prune=True,
        stats_bucket=jtr.pick_subset_bucket(iv, cap), stats_entry_budget=jtr.pick_entry_bucket(ents),
    )
    return state, int(n_new), int(n_pruned), float(loss)


def _mapping_step_port(state, buf, frame, ids):
    """The port's mapping step with the reference's batch `ids` injected."""
    cap = T_MAPCFG.capacity
    state, n_new, _ = tgm.spawn(state, frame, T_MAPCFG, T_RASTER, render_bucket=tgm.bucket_capacity(state.count, cap, min_cap=1024))
    buf = tkf.add_frame(buf, frame)
    max_iv, max_e = ttr.keyframe_view_stats(state, buf, ids, T_MAPCFG, T_RASTER)
    state, buf, loss, _ = ttr.train_keyframe(
        state, buf, ttr.batch_views(ids), T_MAPCFG, T_RASTER,
        subset_bucket=ttr.pick_subset_bucket(max_iv, cap), entry_budget=ttr.pick_entry_bucket(max_e),
    )
    iv, ents = ttr.stats_view_budgets(state, buf, T_MAPCFG, T_RASTER, True)
    state, n_pruned = ttr.post_process(
        state, buf, frame["depth_range"][1], T_MAPCFG, T_RASTER, True,
        stats_bucket=ttr.pick_subset_bucket(iv, cap), stats_entry_budget=ttr.pick_entry_bucket(ents),
    )
    return state, n_new, n_pruned, float(loss)


def test_one_keyframe_through_both_packages():
    """Keyframe 3 of the gate's poses from the reference's state after
    spawning keyframes 1-2: the same spawn, the same held-out quality. (The
    post_process here prunes over all keyframes.)"""
    from test_mapping import look_at_pose

    sim = JSim(resolution=(RES, RES), seed=11, depth_noise_co=0.0)
    frames = [sim.simulate(look_at_pose(*pt), require_gt=True) for pt in TRAIN_TARGETS]
    state, buf = jgm.init_state(MAPCFG), jkf.init_buffer(8, RES, RES)
    for f in frames[:2]:
        state, _, _ = jgm.spawn(state, f, MAPCFG, RASTER)
        buf = jkf.add_frame(buf, f)
    key = jax.random.PRNGKey(3)
    ids = ref_batch_ids(jkf.add_frame(buf, frames[2]), key)
    t_out = _mapping_step_port(t_state(state), t_buffer(buf), t_frame(frames[2]), to_t(ids).long())
    j_out = _mapping_step_ref(state, buf, frames[2], key)
    assert t_out[1] == j_out[1] > 0  # spawn count
    assert abs(t_out[3] - j_out[3]) <= 1e-3 * j_out[3]  # last step's loss
    assert t_out[0].count > 0 and int(j_out[0].count) > 0

    gt = sim.simulate(look_at_pose(*TEST_TARGET), require_gt=True)
    out_j, _ = j_render_view(jgm.attrs_of(j_out[0], MAPCFG), Camera(gt["extrinsic"], gt["intrinsic"]), (RES, RES), RASTER)
    p_ref = float(metrics.cal_psnr(np.asarray(out_j.rgb), np.asarray(gt["rgb"])))
    p_port, _ = t_psnr_depth(t_out[0], t_frame(gt))
    print(f"\nheld-out PSNR: port {p_port:.4f} dB, reference {p_ref:.4f} dB; pruned {t_out[2]} / {j_out[2]}")
    assert abs(p_port - p_ref) <= 0.1


def test_port_imports_no_jax():
    """`activegs_torch` and the imports of `chip_smoke.py` work with JAX and
    the reference package unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['activegs_tpu'] = None\n"
        "import activegs_torch\n"
        "for m in pkgutil.walk_packages(activegs_torch.__path__, 'activegs_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "chip_smoke.poses('cpu')\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    for path in [*sorted((REPO / "activegs_torch").rglob("*.py")), REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not words[1].split(".")[0] in ("jax", "jaxlib", "activegs_tpu"), f"{path}: {line}"

