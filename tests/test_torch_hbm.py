"""The port's HBM adaptation against the reference's: ``tensor_stats``
exactly, for tensors made from one numpy seed in both frameworks (the
popcount and toggle kernels' plain versions here, the Pallas kernels in
interpret mode there), the byte view of ``_tensor_lines`` bit for bit,
and ``HbmEnergyModel`` / ``step_energy`` at rtol 1e-6."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hbm as rhbm
from repro.core import model_api as rma
from repro_torch.core import hbm as phbm
from repro_torch.core import model_api as pma
from repro_torch.kernels.popcount import popcount as p_pc
from repro_torch.kernels.toggle import toggle as p_tg

MODEL = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
         / "data" / "vampire_quickfit_v2.npz")


def _pair(dtype: str):
    """The same tensor in both frameworks, from one numpy seed (bf16 and
    f16 cast from the same float32 array; both round to nearest even)."""
    rng = np.random.default_rng(71)
    f = (rng.standard_normal((96, 160)) * 0.5).astype(np.float32)
    if dtype == "float32":
        return jnp.asarray(f), torch.from_numpy(f)
    if dtype in ("bfloat16", "float16"):
        return (jnp.asarray(f).astype(getattr(jnp, dtype)),
                torch.from_numpy(f).to(getattr(torch, dtype)))
    if dtype == "int32":
        a = rng.integers(0, 32000, size=(96, 160)).astype(np.int32)
    else:
        a = np.clip(np.round(f * 60), -128, 127).astype(dtype)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int32"])
def test_tensor_stats_equals_reference(dtype):
    r_x, p_x = _pair(dtype)
    before = (p_pc.line_ones.launches, p_tg.line_toggles.launches)
    got = phbm.tensor_stats(p_x)
    assert (p_pc.line_ones.launches, p_tg.line_toggles.launches) == before
    assert got == rhbm.tensor_stats(r_x)
    assert isinstance(got[0], float) and 0.0 < got[0] < 1.0


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16", "float16",
                                   "int8", "uint8"])
def test_tensor_lines_match_reference_bitcast(dtype):
    r_x, p_x = _pair(dtype)
    want = np.asarray(rhbm._tensor_lines(r_x))
    got = phbm._tensor_lines(p_x)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # a misaligned view is copied, not refused
    odd = phbm._tensor_lines(p_x.reshape(-1)[1:])
    assert odd.data_ptr() % 16 == 0


def test_tensor_stats_counts_in_int64():
    x = torch.full((2048,), -1, dtype=torch.int16).view(torch.bfloat16)
    assert phbm.tensor_stats(x) == (1.0, 0.0)
    with pytest.raises(ValueError, match="unsupported dtype"):
        phbm._tensor_lines(torch.zeros(32, dtype=torch.float64))


def test_hbm_energy_model_and_step_energy_match_reference():
    r_model = rma.load_estimator(str(MODEL))
    p_model = pma.load_estimator(str(MODEL), device="cpu")
    for v in range(len(p_model.vendors)):
        want = rhbm.HbmEnergyModel.from_vampire(r_model.params(
            r_model.vendors[v]))
        got = phbm.HbmEnergyModel.from_vampire(p_model.fleet.params.select(v))
        np.testing.assert_allclose(
            [float(x) for x in vars(got).values()],
            [float(x) for x in vars(want).values()], rtol=1e-6)
        kw = dict(read_bytes=3.5e9, write_bytes=1.25e9, step_seconds=0.02,
                  ones_frac=0.31, toggle_frac=0.19)
        a = phbm.step_energy(got, **kw)
        b = rhbm.step_energy(want, **kw)
        np.testing.assert_allclose(
            [a.read_pj, a.write_pj, a.static_pj, a.total_pj, a.total_j],
            [b.read_pj, b.write_pj, b.static_pj, b.total_pj, b.total_j],
            rtol=1e-6)
        np.testing.assert_allclose(
            float(got.read_energy_pj(64e6, 0.5)),
            float(want.read_energy_pj(64e6, 0.5)), rtol=1e-6)
    assert (phbm.HBM2E_PJ_PER_BIT_READ, phbm.HBM2E_PJ_PER_BIT_WRITE,
            phbm.HBM_STATIC_W) == (rhbm.HBM2E_PJ_PER_BIT_READ,
                                   rhbm.HBM2E_PJ_PER_BIT_WRITE,
                                   rhbm.HBM_STATIC_W)
