"""The charge kernels' launch-geometry autotuner (``repro_torch.kernels.
autotune``) on the CPU: the reference's shape buckets, exactly today's
geometry when the tuner is off or has no row, a table honoured, the
sweep's choice, and the committed table's form.  The tuned geometry's
results on the card are checked in ``test_torch_cuda.py``."""
import json

import pytest

from repro.kernels import autotune as ref_autotune
from repro_torch.kernels import autotune, common

H100 = "NVIDIA H100 80GB HBM3"

# (T, N, V) of test_torch_kernels.GEOMETRY_CASES
GEOMETRY_CASES = [(64, 16384, 3), (92, 15237, 3), (8, 2053, 3), (1, 5, 3),
                  (2, 1000, 1), (1, 1 << 20, 3), (6, 2053, 40), (3, 7, 97),
                  (4096, 128, 3), (1, 0, 2)]


def todays_geometry(n_traces, n_cmds, n_vendors, n_sms):
    """``charge_geometry`` as it stood before the autotuner (2 blocks an
    SM, clusters of up to 8)."""
    n_groups = max(1, common.cdiv(n_vendors, 32))
    group = max(1, common.cdiv(n_vendors, n_groups))
    row_steps = max(1, common.cdiv(n_cmds, 4 * 256))
    want = max(1, min(8, common.cdiv(2 * n_sms,
                                     max(1, n_traces * n_groups))))
    cluster = common.cdiv(row_steps, common.cdiv(row_steps, want))
    return common.ChargeGeometry(cluster=cluster, group=group,
                                 n_groups=n_groups,
                                 tile=common.cdiv(row_steps, cluster) * 1024)


@pytest.fixture()
def table(tmp_path, monkeypatch):
    """An empty table in place of the committed one."""
    path = tmp_path / "autotune_table.json"
    path.write_text("{}\n")
    monkeypatch.setattr(autotune, "TABLE_PATH", path)
    autotune.reload_table()
    yield path
    autotune.reload_table()


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (64, 16384), (23, 6128),
                                   (120, 1030), (12, 1536), (348, 1030),
                                   (0, 0), (4096, 1 << 20), (65, 16385)])
def test_shape_bucket_equals_the_references(shape):
    assert autotune.shape_bucket(*shape) == ref_autotune.shape_bucket(*shape)


@pytest.mark.parametrize("n_sms", [132, 114, 16, 1])
@pytest.mark.parametrize("t,n,v", GEOMETRY_CASES)
def test_off_or_empty_table_gives_todays_geometry(t, n, v, n_sms, table,
                                                  monkeypatch):
    want = todays_geometry(t, n, v, n_sms)
    assert common.charge_geometry(t, n, v, n_sms) == want
    for family in autotune.FAMILIES:
        assert common.resolve_geometry(family, t, n, v, n_sms, H100) == want
        monkeypatch.setenv("REPRO_AUTOTUNE", "0")
        assert autotune.best_config(family, t, n) == autotune.DEFAULT_CONFIG
        assert common.resolve_geometry(family, t, n, v, n_sms, H100) == want
        monkeypatch.delenv("REPRO_AUTOTUNE")


def test_a_table_is_honoured(table, monkeypatch):
    table.write_text(json.dumps({H100: {"vampire_energy": {
        "t64n16384": {"blocks_per_sm": 1, "max_cluster": 2, "n_vendors": 3,
                      "us": 20.0, "default_us": 25.0}}}}))
    autotune.reload_table()
    assert autotune.best_config("vampire_energy", 64, 16384, H100) == \
        {"blocks_per_sm": 1, "max_cluster": 2}
    assert autotune.best_config("vampire_energy", 33, 9000, H100) == \
        {"blocks_per_sm": 1, "max_cluster": 2}         # same bucket
    assert autotune.best_config("baseline_energy", 64, 16384, H100) == \
        autotune.DEFAULT_CONFIG
    assert autotune.best_config("vampire_energy", 64, 16384, "other") == \
        autotune.DEFAULT_CONFIG
    geo = common.resolve_geometry("vampire_energy", 64, 16384, 3, 132, H100)
    assert geo == common.charge_geometry(64, 16384, 3, 132, 1, 2)
    assert geo.cluster == 2 and geo != todays_geometry(64, 16384, 3, 132)
    pinned = common.resolve_geometry("vampire_energy", 64, 16384, 3, 132,
                                     H100, dict(autotune.DEFAULT_CONFIG))
    assert pinned == todays_geometry(64, 16384, 3, 132)
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    assert autotune.best_config("vampire_energy", 64, 16384, H100) == \
        autotune.DEFAULT_CONFIG


def test_lookups_count_distinct_buckets(table):
    before = autotune.lookups()
    for shape in ((64, 16384), (60, 16000), (64, 16384), (8, 100)):
        autotune.best_config("vampire_energy", *shape, H100)
    assert autotune.lookups() == before + 2


def test_sweep_picks_the_minimum():
    times = {(2, 8): 30.0, (1, 4): 20.0, (4, 1): 25.0}
    calls = []

    def run_fn(t, n, v, cfg):
        calls.append((t, n, v, cfg["blocks_per_sm"], cfg["max_cluster"]))
        return cfg

    def timer(fn):
        cfg = fn()
        return times.get((cfg["blocks_per_sm"], cfg["max_cluster"]), 40.0)

    out = autotune.sweep("vampire_energy", run_fn, [(64, 16384, 3)],
                         timer=timer)
    row = out["t64n16384"]
    assert (row["blocks_per_sm"], row["max_cluster"]) == (1, 4)
    assert row["us"] == 20.0 and row["default_us"] == 30.0
    assert row["n_vendors"] == 3 and len(row["candidates_us"]) == 12
    assert len(calls) == 12 * (1 + 3)          # a warm call, 3 readings
    # a candidate within the margin of the default does not replace it
    times[(1, 4)] = times[(4, 1)] = 29.0
    row = autotune.sweep("vampire_energy", run_fn, [(64, 16384, 3)],
                         timer=timer)["t64n16384"]
    assert (row["blocks_per_sm"], row["max_cluster"]) == (2, 8)


def test_update_table_merges_rows(table):
    entry = {"blocks_per_sm": 4, "max_cluster": 1, "n_vendors": 50,
             "us": 10.0, "default_us": 12.0, "candidates_us": {}}
    autotune.update_table("vampire_energy", {"t16n2048": entry}, table,
                          device_key=H100)
    autotune.update_table("baseline_energy", {"t32n8192": entry}, table,
                          device_key=H100)
    rows = json.loads(table.read_text())[H100]
    assert rows["vampire_energy"]["t16n2048"] == {
        k: entry[k] for k in ("blocks_per_sm", "max_cluster", "n_vendors",
                              "us", "default_us")}
    assert set(rows) == {"vampire_energy", "baseline_energy"}
    assert autotune.best_config("vampire_energy", 12, 1536, H100) == \
        {"blocks_per_sm": 4, "max_cluster": 1}


def test_committed_table_holds_only_card_rows_of_the_main_path():
    table = json.loads(autotune.TABLE_PATH.read_text())
    buckets = {autotune.shape_bucket(t, n): v
               for t, n, v in autotune.MAIN_PATH_SHAPES.values()}
    for device_key, families in table.items():
        assert device_key.startswith("NVIDIA"), device_key
        for family, rows in families.items():
            assert family in autotune.FAMILIES
            for bucket, row in rows.items():
                assert buckets[bucket] == row["n_vendors"]
                assert row["blocks_per_sm"] in autotune.BLOCKS_PER_SM_CHOICES
                assert row["max_cluster"] in autotune.CLUSTER_CHOICES
                assert row["us"] > 0 and row["default_us"] > 0
                assert row["us"] <= row["default_us"]


def test_candidates_cover_the_knobs():
    cands = autotune.candidates()
    assert cands[0] == autotune.DEFAULT_CONFIG
    assert len({tuple(c.values()) for c in cands}) == 12
    assert autotune.DEFAULT_CONFIG == {"blocks_per_sm": common.BLOCKS_PER_SM,
                                       "max_cluster": common.MAX_CLUSTER}
