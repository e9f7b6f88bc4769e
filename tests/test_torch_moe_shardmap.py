"""The port's expert-parallel MoE (``layers.moe_apply_shardmap``) against
the reference's ``shard_map`` one, on a (data 2, model 2) mesh in
float32, FSDP off and on, for the two MoE smoke configs (qwen3-moe-30b-a3b
without shared experts, deepseek-v2-lite-16b with one).

The reference runs in a subprocess on four forced host devices
(``XLA_FLAGS``, as ``test_dryrun_integration.py`` runs its dry run); the
port runs over four ``gloo`` processes (``torch_gloo_moe.py``) on the same
weights and inputs, made from seeds and carried across as numpy arrays.
The capacity factor is lowered to 0.5, so that tokens drop on every data
shard and the spare buffer row takes them (ROADMAP R9): the test counts
the drops first.  The bar is 1e-5 of the largest |y|, for summation order
only.  The gloo run also differentiates ``sum(y * g)``: every gradient,
with the expert weights gathered under FSDP and the partial sums reduced
back, equals autograd's through each data shard's rows on plain tensors
at 1e-5 of the leaf's largest."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.models import layers as L

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b")
CF = 0.5
BATCH, SEQ = 4, 32

REFERENCE = textwrap.dedent("""\
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import registry
    from repro.launch.mesh import make_local_mesh
    from repro.models import layers as L
    from repro.models.meta import materialize

    archs, cf, b, s, out = json.loads(sys.argv[1])
    mesh = make_local_mesh(data=2, model=2)
    res = {}

    def flat(tree, prefix):
        for name, value in tree.items():
            if isinstance(value, dict):
                flat(value, f"{prefix}{name}/")
            else:
                res[prefix + name] = np.asarray(value)

    for i, arch in enumerate(archs):
        cfg = registry.get_config(arch, smoke=True)
        cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        params = materialize(L.moe_meta(cfg), jax.random.key(i),
                             dtype=jnp.float32)
        rng = np.random.default_rng(i)
        x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        flat(params, f"{arch}/p/")
        res[f"{arch}/x"] = x
        res[f"{arch}/g"] = rng.standard_normal(x.shape).astype(np.float32)
        res[f"{arch}/cf"] = np.float32(cf)
        for fsdp in (False, True):
            y = L.moe_apply_shardmap(params, jnp.asarray(x), cfg, mesh,
                                     dp_axes=("data",), fsdp=fsdp)
            res[f"{arch}/ref/{'fsdp' if fsdp else 'tp'}"] = np.asarray(y)
    np.savez(out, **res)
    """)


def _run(args, env=None, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env or {}))
    proc = subprocess.run([sys.executable, *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_shardmap")
    ref, port = d / "reference.npz", d / "port.npz"
    _run(["-c", REFERENCE, json.dumps([ARCHS, CF, BATCH, SEQ, str(ref)])],
         env={"JAX_PLATFORMS": "cpu"})
    _run(["tests/torch_gloo_moe.py", str(ref), str(port)])
    return dict(np.load(ref)), dict(np.load(port))


def _config(arch):
    cfg = registry.get_config(arch, smoke=True)
    return dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=CF))


def _drops(data, arch) -> int:
    """Assignments dropped over the data shards: each routes its own rows
    at the per-shard capacity."""
    cfg = _config(arch)
    params = {k.split("/")[-1]: torch.from_numpy(v) for k, v in data.items()
              if k in (f"{arch}/p/router", f"{arch}/p/norm")}
    e = cfg.moe
    dropped = 0
    for rows in torch.from_numpy(data[f"{arch}/x"]).chunk(2):
        t = rows.shape[0] * rows.shape[1]
        _, _, _, expert = L.moe_route(params, rows, cfg)
        cap = max(8, int(t * e.top_k / e.n_experts * e.capacity_factor))
        _, keep, _, _ = L.moe_dispatch(expert, cfg, cap=cap)
        dropped += int((~keep).sum())
    return dropped


@pytest.mark.parametrize("fsdp", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_shardmap_matches_the_reference(runs, arch, fsdp):
    ref, port = runs
    assert _drops(ref, arch) > 0
    want = ref[f"{arch}/ref/{fsdp}"]
    got = port[f"{arch}/{fsdp}/y"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("fsdp", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_shardmap_gradients_match_one_process(runs, arch, fsdp):
    _, port = runs
    n = sum(k.startswith(f"{arch}/plain/grad") for k in port)
    assert n == 1 + len(T.leaves(L.moe_meta(_config(arch))))
    for i in range(n):
        want = port[f"{arch}/plain/grad{i}"]
        got = port[f"{arch}/{fsdp}/grad{i}"]
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), i
    np.testing.assert_allclose(port[f"{arch}/{fsdp}/y"],
                               port[f"{arch}/plain/y"], rtol=0,
                               atol=1e-5 * np.abs(port[f"{arch}/plain/y"])
                               .max())
