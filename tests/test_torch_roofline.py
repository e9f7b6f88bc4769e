"""The roofline of the port's dry run: ``model_flops_per_device`` equals
the reference's for every cell and device count; the terms, the dominant
one and the fraction follow from an artifact with the H100's constants;
``load_artifacts`` reads a directory of artifacts by mesh."""
import json

import pytest

from repro.configs import registry as jreg
from repro.launch import roofline as jroofline
from repro_torch.configs import registry
from repro_torch.launch import roofline


@pytest.mark.parametrize("arch,shape", registry.all_cells())
def test_model_flops_match_the_reference(arch, shape):
    for n in (1, 16, 256, 512):
        got = roofline.model_flops_per_device(
            registry.get_config(arch), registry.SHAPES[shape], n)
        want = jroofline.model_flops_per_device(
            jreg.get_config(arch), jreg.SHAPES[shape], n)
        assert got == pytest.approx(want, rel=1e-12)


def _artifact(mesh="16x16", flops=9.89e14, traffic=3.35e12 / 2,
              adjusted=3.35e12 / 4, coll=5e10 * 3, peak=2 ** 33):
    return {"arch": "qwen2.5-3b", "shape": "train_4k", "mesh": mesh,
            "n_devices": 256, "smoke": False,
            "flops_per_device": flops, "traffic_bytes_per_device": traffic,
            "kernel_adjusted_traffic_bytes_per_device": adjusted,
            "collective_total_bytes_per_device": coll,
            "memory": {"peak_bytes_est": peak}}


def test_terms_use_the_h100_constants():
    assert (roofline.PEAK_FLOPS_BF16, roofline.HBM_BW, roofline.LINK_BW) \
        == (989e12, 3.35e12, 50e9)
    assert roofline.terms(_artifact()) == pytest.approx((1.0, 0.5, 3.0))
    assert roofline.terms(_artifact(), kernel_adjusted=True)[1] \
        == pytest.approx(0.25)
    r = roofline.from_artifact(_artifact())
    assert (r.compute_s, r.memory_s, r.collective_s) == pytest.approx(
        (1.0, 0.5, 3.0))
    assert r.dominant == "collective" and r.bound_s == pytest.approx(3.0)
    assert r.peak_gib == pytest.approx(8.0)
    mf = roofline.model_flops_per_device(
        registry.get_config("qwen2.5-3b"), registry.SHAPES["train_4k"], 256)
    assert r.model_flops_per_device == pytest.approx(mf)
    assert r.roofline_fraction == pytest.approx(mf / 989e12 / 3.0)
    assert r.flops_ratio == pytest.approx(mf / 9.89e14)


def test_load_artifacts_filters_by_mesh(tmp_path):
    for i, mesh in enumerate(("16x16", "2x16x16", "16x16")):
        (tmp_path / f"c{i}.json").write_text(json.dumps(
            _artifact(mesh=mesh, flops=(i + 1) * 1e12)))
    rows = roofline.load_artifacts(str(tmp_path), "16x16")
    assert [r.flops_per_device for r in rows] == [1e12, 3e12]
    assert len(roofline.load_artifacts(str(tmp_path), None)) == 3
    table = roofline.table(rows)
    assert table.splitlines()[0].split()[:3] == ["arch", "shape", "compute"]
    assert len(table.splitlines()) == 4 and "qwen2.5-3b" in table
