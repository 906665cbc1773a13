"""The elementwise-rate probes' plain versions against the reference's
Pallas `kernel`s (`scripts/microbench_vpu.py`, `scripts/microbench_bf16.py`).

The reference kernels run through `pl.pallas_call(..., interpret=True)` at a
small grid (2 blocks of (8, 128), the bf16 script's 512 rounds for both, the
scripts' module constants patched), on the same inputs as the port's
`chain_plain`. The scripts are loaded with `activegs_tpu.runtime.setup_cache`
patched to a no-op, so that importing them leaves this worker's JAX compile
cache alone.

Tolerance: every op is held bitwise, except the f32 multiply-add as the
port's kernels compile it. XLA contracts the reference's v * c1 + c0 into
one fused multiply-add, which the port's `fma_fused` matches bitwise; the
port's `fma` rounds the product too, as the compositor does, and each
round may then move its value by up to 1.5 ulps from the fused chain
(the product's rounding, the sum's, and the fused sum's), so the two
chains stay within 1.5 x ROUNDS ulps of the larger end of the chain.
"""

import functools
import importlib.util
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from activegs_torch.scripts import microbench_bf16 as tbf
from activegs_torch.scripts import microbench_vpu as tvpu

REPO = pathlib.Path(__file__).resolve().parents[1]
GRID, SUB, LANE, ROUNDS = 2, 8, 128, 512


def vpu_input() -> np.ndarray:
    """Distinct values: 0.25 to 2.0 in block 0, and around 0 in block 1,
    where the add moves every value by many ulps."""
    x = np.empty((GRID, SUB, LANE), np.float32)
    x[0] = np.linspace(0.25, 2.0, SUB * LANE, dtype=np.float32).reshape(SUB, LANE)
    x[1] = np.linspace(-1e-4, 1e-4, SUB * LANE, dtype=np.float32).reshape(SUB, LANE)
    return x


def chain_gap_ulps(x: np.ndarray, fused: np.ndarray) -> np.ndarray:
    """1.5 x ROUNDS ulps of the larger end of each element's multiply-add
    chain: the most that rounding each product can move it from the fused
    chain (both chains only rise from values above -0.1)."""
    return 1.5 * ROUNDS * np.spacing(np.maximum(np.abs(x), np.abs(fused)))


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    with mock.patch("activegs_tpu.runtime.setup_cache", lambda *a, **k: None):
        spec.loader.exec_module(mod)
    mod.ROUNDS = ROUNDS  # read by the kernels when they trace
    return mod


@pytest.fixture(scope="module")
def ref_vpu():
    return load_script("microbench_vpu")


@pytest.fixture(scope="module")
def ref_bf16():
    return load_script("microbench_bf16")


def run_ref(kernel, x: np.ndarray) -> np.ndarray:
    spec = pl.BlockSpec((1, SUB, LANE), lambda t: (t, 0, 0))
    f = pl.pallas_call(
        kernel, grid=(GRID,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32), interpret=True,
    )
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


def test_setup_cache_left_alone():
    """Loading a script through `load_script` does not point JAX's compile
    cache anywhere."""
    before = jax.config.jax_compilation_cache_dir
    load_script("microbench_vpu")
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("op", ["fma", "mul", "add", "cmpsel", "exp", "div"])
def test_vpu_plain_matches_reference_kernel(ref_vpu, op):
    x = vpu_input()
    want = run_ref(functools.partial(ref_vpu.kernel, op=op), x)
    got = tvpu.chain_plain(torch.from_numpy(x), op, ROUNDS).numpy()
    assert np.mean(want != x) > 0.7  # the chain moved the values
    if op == "fma":
        assert np.all(np.abs(got - want) <= chain_gap_ulps(x, want))
        assert not np.array_equal(got, want)  # one rounding more per round shows
    else:
        np.testing.assert_array_equal(got, want)
    assert tvpu.OPS_PER_ROUND[op] == ref_vpu.OPS_PER_ROUND[op]


def test_vpu_fused_variant_matches_reference_fma(ref_vpu):
    """`fma_fused` (one rounding per round) is the reference's fma op as XLA
    compiles it, bit for bit."""
    x = vpu_input()
    want = run_ref(functools.partial(ref_vpu.kernel, op="fma"), x)
    got = tvpu.chain_plain(torch.from_numpy(x), "fma_fused", ROUNDS).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_plain_matches_reference_kernel(ref_bf16, dtype):
    """On values of `MOVING_BAND` every round moves every bf16 value, so a
    chain short of rounds, or of elements, would not match."""
    assert ROUNDS == tbf.ROUNDS  # the band is chosen for this many rounds
    x = np.random.default_rng(0).uniform(*tbf.MOVING_BAND, (GRID, SUB, LANE)).astype(np.float32)
    want = run_ref(functools.partial(ref_bf16.kernel, dtype=getattr(jnp, dtype)), x)
    got = tbf.chain_plain(torch.from_numpy(x), dtype, ROUNDS).numpy()
    start = torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()
    short = tbf.chain_plain(torch.from_numpy(x), dtype, ROUNDS - tbf.UNROLL).numpy()
    assert np.all(want != start) and np.all(want != short)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        # XLA fuses the f32 multiply-add here too
        fused = tvpu.chain_plain(torch.from_numpy(x), "fma_fused", ROUNDS).numpy()
        np.testing.assert_array_equal(fused, want)
        assert np.all(np.abs(got - want) <= chain_gap_ulps(x, want))


def test_probe_wrappers_take_the_plain_version_on_the_cpu():
    x = torch.full((1, 4, 8), 0.5)
    assert torch.equal(tvpu.chain(x, "mul", 16), tvpu.chain_plain(x, "mul", 16))
    assert torch.equal(tbf.chain(x, "bfloat16", 16), tbf.chain_plain(x, "bfloat16", 16))
    assert tvpu.kernel.launches == 0 and tbf.kernel.launches == 0


def test_runs_print_the_reference_lines(capsys):
    res = tvpu.run("fma_fused", "cpu", grid=1, rounds=16)
    assert res["ms"] > 0 and "fma_fused" in capsys.readouterr().out
    res = tbf.run("bfloat16", "cpu", grid=1, rounds=16)
    assert res["ms"] > 0 and "bfloat16" in capsys.readouterr().out
