"""The port's ``mesh=`` paths on real ``DeviceMesh``es: CPU processes on
the ``gloo`` backend (``tests/torch_gloo_mesh.py``, one subprocess run a
part) run the sharded fleet surface, the campaign's probe matrix, the
estimation service, ``make_global_array``, ``crosspod_compressed_psum``,
``launch.serve.run`` and ``launch.train.run`` with a rescale, and each is
held against the same call in one process: the estimation side bit for
bit (every (trace, module) pair is independent), the LM side at the
float32 bars of ``tests/torch_gloo_step.py``.  The sharded estimation
results are also held against the reference's plain dispatch on the same
inputs (rtol 1e-5, the fleet tests' bar), and the sharded LM paths
against the reference's own: ``repro.launch.train`` for 3 steps on
(2, 2) and ``repro.launch.serve`` on (2, 1), on four forced host devices
in a subprocess (as ``test_torch_moe_shardmap.py`` runs the reference),
with the port started from the reference's weights.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_gloo_mesh as G
from repro.core import device_sim as rsim
from repro.core import dram as rdram
from repro.core import fleet as rfleet
from repro.core import idd_loops as ridd
from repro.core import params as rparams
from repro.optim import compress as rcompress
from repro_torch.core import device_sim as psim
from repro_torch.core import dram as pdram
from repro_torch.core import fleet as pfleet
from repro_torch.core import idd_loops as pidd
from repro_torch.core import model_api
from repro_torch.core import traces as ptraces
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.serve import QUICK_FIT
from repro_torch.serving import EstimationService, ServiceConfig

HERE = os.path.dirname(os.path.abspath(__file__))
MESHES = ["2x2", "4x1"]

REFERENCE = textwrap.dedent("""\
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint.manager import CheckpointManager
    from repro.configs import registry
    from repro.launch import serve, train
    from repro.models.lm import LM
    from repro.models.meta import materialize
    from repro.optim import adamw

    arch, out, ckpt = json.loads(sys.argv[1])
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                              dtype="float32")
    res = {}

    def flat(tree, prefix):
        for name, value in tree.items():
            if isinstance(value, dict):
                flat(value, f"{prefix}{name}/")
            else:
                res[prefix + name] = np.asarray(value)

    # train: 3 steps on (data 2, model 2); the weights it starts from, as
    # run() draws them, and those it ends with, from its checkpoint
    p0 = materialize(LM(cfg).param_meta(), jax.random.key(0),
                     dtype=jnp.float32)
    flat(p0, "train_init/")
    got = train.run(train.TrainJob(
        arch=arch, config=cfg, steps=3, batch=4, seq=16, data=2, model=2,
        power_every=0, ckpt_dir=ckpt, ckpt_every=2))
    res["train_losses"] = np.asarray(got["losses"])
    ocfg = adamw.AdamWConfig(warmup_steps=5, decay_steps=10)
    state = CheckpointManager(ckpt).restore(
        3, {"params": p0, "opt": adamw.init(p0, ocfg)})
    flat(state["params"], "train_final/")
    res["train_lr"] = np.asarray([ocfg.schedule(jnp.int32(s))
                                  for s in range(3)])
    # serve: greedy on (data 2, model 1), from LM.init's weights
    serve.registry.get_config = lambda arch, smoke=False: cfg
    flat(LM(cfg).init(jax.random.key(0)), "serve_init/")
    got = serve.run(serve.ServeJob(arch=arch, batch=4, prompt_len=8,
                                   decode_tokens=4, data=2, model=1))
    res["serve_tokens"] = np.asarray(got["tokens"])
    np.savez(out, **res)
    """)


def _part(name: str, out_dir, timeout: int, ref=None) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, os.pardir, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_gloo_mesh.py"),
         "--part", name, "--out", str(out_dir),
         *(["--ref", str(ref)] if ref else [])],
        capture_output=True, text=True, timeout=timeout, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded train and serve runs (and the weights they
    start from) on four forced host devices."""
    d = tmp_path_factory.mktemp("reference")
    out = d / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(HERE, os.pardir, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE,
         json.dumps([G.ARCH, str(out), str(d / "ckpt")])],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out


@pytest.fixture(scope="module")
def estimate(tmp_path_factory):
    d = tmp_path_factory.mktemp("estimate")
    res = _part("estimate", d, timeout=240)
    with np.load(d / "estimate.npz") as z:
        res["arrays"] = dict(z)
    return res


@pytest.fixture(scope="module")
def trained(tmp_path_factory, reference):
    d = tmp_path_factory.mktemp("train")
    res = _part("train", d, timeout=240, ref=reference)
    with np.load(d / "train_ref_weights.npz") as z:
        res["ref_weights_params"] = dict(z)
    return res


@pytest.fixture(scope="module")
def served(tmp_path_factory, reference):
    return _part("serve", tmp_path_factory.mktemp("serve"), timeout=240,
                 ref=reference)


@pytest.fixture(autouse=True)
def partitionable():
    # the port follows JAX's partitionable Threefry stream
    with jax.threefry_partitionable(True):
        yield


# ---------------------------------------------------------------- estimate
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("impl", ["vectorized", "cuda"])
def test_the_sharded_fleet_surface_is_the_one_process_surface(estimate,
                                                              mesh, impl):
    for res in estimate["ranks"]:
        assert res[f"surface {mesh} {impl}"]
        assert res[f"surface_mods {mesh} {impl}"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("impl", ["vectorized", "cuda"])
def test_the_sharded_probe_matrix_is_the_one_process_matrix(estimate, mesh,
                                                            impl):
    """Bit for bit, noise-free and noisy; each rank computed its own box:
    (12 modules / model) x (8 probes / data)."""
    d, m = map(int, mesh.split("x"))
    for res in estimate["ranks"]:
        for noisy in (False, True):
            assert res[f"probes {mesh} {impl} noisy={noisy}"]
        assert res[f"box {mesh}"] == [len(G.SPECS) // m, len(G.PROBES) // d]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("impl", ["vectorized", "cuda"])
def test_lone_long_rows_give_the_one_process_bits(estimate, mesh, impl):
    """Four sweeps of 34,000-38,400 commands: on (4, 1) each rank's probe
    box, and on both meshes each rank's service window (windows of four),
    is one row of more than 32768 values, which torch on the CPU would
    sum over its threads unlike the same row among others; the ranks run
    two threads or more.  Bit for bit one process."""
    for r, res in enumerate(estimate["ranks"]):
        assert res[f"long_probes {mesh} {impl}"]
        assert res[f"long_service {mesh} {impl}"]
        assert res[f"long_service_rows {mesh}"] == [r, r + 1]


def test_the_sharded_results_match_the_reference(estimate):
    rtr, rw = rdram.batch_traces([(ridd.validation_sweep(n, reps=r), 2)
                                  for n, r in G.SWEEPS])
    _, rstacked = rsim.synth_fleet_params(G.N_SYNTH)
    want = np.asarray(rfleet.fleet_surface_energy(rstacked, rtr,
                                                  rw).energy_pj)
    points = [rfleet.ProbePoint(("p", i), tr, skip, G.key(i))
              for i, (tr, skip) in enumerate(G.probe_traces(ridd))]
    mods = rsim.make_fleet([rparams.ModuleSpec(*s) for s in G.SPECS])
    probes = rfleet.run_probes(mods, points, noisy=False)
    for mesh in MESHES:
        np.testing.assert_allclose(estimate["arrays"][f"surface_{mesh}"],
                                   want, rtol=1e-5, err_msg=mesh)
        np.testing.assert_allclose(estimate["arrays"][f"probes_{mesh}"],
                                   probes, rtol=1e-5, err_msg=mesh)


def test_the_stacked_fleet_shards_its_modules_over_model(estimate):
    """``fleet_stacked(mods, device, mesh)``: ``Shard(0)`` on a model axis
    of two, replicated where the model axis is one device wide."""
    for res in estimate["ranks"]:
        assert res["stacked 2x2"] == ["R", "S(0)"]
        assert res["stacked_local 2x2"] == [len(G.SPECS) // 2]
        assert res["stacked 4x1"] == ["R", "R"]
        assert res["stacked_local 4x1"] == [len(G.SPECS)]


@pytest.mark.parametrize("mesh", MESHES)
def test_the_service_on_a_mesh_is_the_one_process_service(estimate, mesh):
    """Each window's 8 slots split over the 4 devices in rank order; a
    window of 3 traces does not divide and goes plain (every rank scores
    all three), equal to ``estimate``."""
    rows = []
    for res in estimate["ranks"]:
        assert res[f"service {mesh} vectorized"]
        assert res[f"service {mesh} cuda"]
        assert res[f"n_shards {mesh}"] == 4
        rows.append(res[f"rows {mesh}"])
        assert res[f"three_rows {mesh}"] == [0, 3]
        assert res[f"three {mesh}"] <= 1e-5
    assert rows == [[0, 2], [2, 4], [4, 6], [6, 8]]


def test_a_one_device_mesh_falls_back_bit_for_bit():
    mesh = make_local_mesh(1, 1, device="cpu")
    model = model_api.load_estimator(str(QUICK_FIT), device="cpu")
    trs = [ptraces.app_trace(a, n_requests=40) for a in ptraces.SPEC_APPS[:3]]
    got, want = [], []
    for out, m in ((got, mesh), (want, None)):
        svc = EstimationService(model, ServiceConfig(), mesh=m)
        tickets, _ = svc.submit_many(trs)
        svc.close()
        out += [svc.result(t) for t in tickets]
    assert all(torch.equal(a, b) for ra, rb in zip(got, want)
               for a, b in zip(ra, rb))
    tr, w = pdram.batch_traces([(pidd.validation_sweep(8, reps=4), 2)])
    _, synth = psim.synth_fleet_params(4, device="cpu")
    a = pfleet.fleet_surface_energy(synth, tr, w, device="cpu", mesh=mesh)
    b = pfleet.fleet_surface_energy(synth, tr, w, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_gather_boxes_refuses_a_mesh_that_does_not_span_the_world():
    """The sharded dispatches gather over the whole process group, so a
    mesh of another size than the world is refused, not misassembled."""
    make_local_mesh(1, 1, device="cpu")         # a world of one rank

    class TwoDevices:
        def size(self):
            return 2
    with pytest.raises(ValueError, match="span"):
        model_api.gather_boxes(torch.zeros(1), TwoDevices(), {})


def test_chunking_and_a_mesh_are_exclusive(estimate):
    for res in estimate["ranks"]:
        assert "mutually exclusive" in res["chunk_and_mesh"]


@pytest.mark.parametrize("mesh", MESHES)
def test_make_global_array_is_the_global_batch(estimate, mesh):
    """Every rank's full tensors are ``global_batch``'s, bit for bit, and
    its local box is its data shard's rows."""
    for res in estimate["ranks"]:
        assert res[f"global_array {mesh}"]


@pytest.mark.parametrize("mesh", MESHES)
def test_the_compressed_psum_sums_the_reference_round_trip(estimate, mesh):
    """Rank 0's ``crosspod_compressed_psum`` over ``data`` is the sum over
    its data group of the reference's ``decompress(*compress(g))`` of each
    rank's gradients, at float32 rounding."""
    ranks = estimate["rank0"][f"psum_ranks {mesh}"]
    assert ranks == ([0, 2] if mesh == "2x2" else [0, 1, 2, 3])
    want = sum(np.asarray(rcompress.decompress(*rcompress.compress(
        jnp.asarray(np.random.default_rng(r).standard_normal(
            (3, 8)).astype(np.float32))))) for r in ranks)
    np.testing.assert_allclose(estimate["arrays"][f"psum_{mesh}"], want,
                               rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------- LM paths
def test_train_on_a_mesh_then_rescale(trained):
    """``launch.train.run``: 2 steps on (2, 2) with a checkpoint, then
    the run resumed on (4, 1) runs only step 2; its losses and moments
    equal 3 steps in one process at the float32 bars (1e-6 of the loss,
    1e-5 of each moment's largest).  Parameters agree within 1e-5
    absolute: a key bias's gradient is zero but for rounding, so AdamW's
    first steps move it by the learning rate at that rounding's sign in
    either run."""
    res = trained["rank0"]
    assert res["steps_run"] == [2, 1]
    assert res["loss_err"] <= 1e-6
    assert res["moment_err"] < 1e-5
    assert res["param_abs_err"] < 1e-5
    assert all(r["losses"] == res["losses"] for r in trained["ranks"])


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_serve_on_a_mesh_is_the_one_process_serve(served, mesh):
    """``launch.serve.run`` with data=2 and with model=2: the prefill's
    last logits within 1e-5 of one process, the same greedy tokens on
    every rank and in one process, and the power report's service (on the
    data=2 run, over the mesh) admits every sequence.  No rank gathers a
    whole cache leaf: each grows its own decode shard."""
    res = served["rank0"]
    assert res[f"tokens {mesh}"]
    assert res[f"logit_err {mesh}"] < 1e-5
    toks = [r[f"tokens_rank {mesh}"] for r in served["ranks"]]
    assert all(t == toks[0] for t in toks)
    assert all(r[f"gathered_caches {mesh}"] == [] for r in served["ranks"])
    assert all(r["power_admitted"] == 4 for r in served["ranks"])


def test_train_on_a_mesh_is_the_reference_train_on_its_mesh(trained,
                                                            reference):
    """From the reference's weights, 3 steps on (2, 2): the losses and the
    weights ``repro.launch.train`` reaches on its own (2, 2) mesh.  Losses
    at ``test_torch_train.py``'s rtol 1e-4.  Weights: the warm-up's first
    steps move each element by about the learning rate times the sign of
    its moment, so an element whose gradients sit at float32 rounding in
    either framework (a key bias's, whose gradient is zero but for
    rounding, and a few others) lands anywhere within the rates' sum ``L``;
    every element within ``L``, and at most 1e-4 of them beyond 0.05 ``L``
    (``test_torch_train.py``'s bar for one synchronised step), at rtol
    1e-4 besides.  Measured: 3 of 107,072 beyond 0.05 ``L``, the largest
    0.069 ``L`` off."""
    with np.load(reference) as z:
        ref = dict(z)
    want_losses = ref["train_losses"]
    for res in trained["ranks"]:
        np.testing.assert_allclose(res["ref_weights_losses"], want_losses,
                                   rtol=1e-4)
    from repro_torch import convert
    from repro_torch import tree as T
    final = G.nested({k[len("train_final/"):]: v for k, v in ref.items()
                      if k.startswith("train_final/")})
    want = dict(T.leaves_with_paths(convert.lm_params_from_jax(
        final, G._cfg32())))
    got = trained["ref_weights_params"]
    assert sorted(got) == sorted(want)
    lr_sum = float(ref["train_lr"].sum())
    beyond = n = 0
    for path, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[path], w, rtol=1e-4, atol=lr_sum,
                                   err_msg=path)
        beyond += int((np.abs(got[path] - w)
                       > 0.05 * lr_sum + 1e-4 * np.abs(w)).sum())
        n += w.size
    assert beyond <= 1e-4 * n, (beyond, n)


def test_serve_on_a_mesh_is_the_reference_serve_on_its_mesh(served,
                                                            reference):
    """From the reference's weights, a greedy run on (2, 1): the tokens
    ``repro.launch.serve`` generates on its own (2, 1) mesh, on every
    rank."""
    with np.load(reference) as z:
        want = z["serve_tokens"].tolist()
    for res in served["ranks"]:
        assert res["ref_weights_tokens"] == want
