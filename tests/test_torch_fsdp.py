"""The ``fsdp`` axis in the port: parameters and optimizer state sharded
at rest (parallel/fsdp.py), on the CPU as 8 spawned gloo ranks
(tests/_torch_dist_worker.py ``suite_fsdp8`` over data=2 x fsdp=4, one
spawn for the module, each group made with its own 60 s timeout).

* tests/test_parallel.py:74: ``fsdp_rules(min_size=128)`` puts fc1/w
  (16 x 32) on (None, "fsdp") and leaves fc1/b whole; a rank stores a
  quarter of fc1/w and of its momentum; two steps equal the port's
  one-process step and the JAX package's sharded step (loss rtol 2e-5,
  parameters and momentum rtol 2e-4 / atol 2e-5).
* A global and a per-unit clip norm that only the norm across the shards
  reaches clip on every rank alike (one process's step with the same
  clip, rtol 2e-4 / atol 2e-5); a NaN in one data rank's rows skips the
  step on every rank.
* tests/test_pipeline_product.py:832: the fused 1F1B step over pp2 x
  fsdp2 x dp2, stage arrays over (pipe, None, fsdp), equals the one-
  process step and the JAX package's (loss rtol 2e-5, parameters as
  ``_assert_params_match``: rtol 2e-4 / atol 2e-5).
* tests/_multihost_train.py:48-84: the trainer under data x fsdp with
  ``fsdp_rules(min_size=16)``: rank 0 writes the gathered snapshot,
  which restores into a new trainer under the mesh (rtol 1e-6) that
  keeps its own loader shard and trains on, and which the one-process
  port and the JAX package load.
* ``--mesh data=2,fsdp=2`` on configs/induction_lm.json (4 ranks) trains
  one epoch to the no-mesh run's weights (rtol / atol 1e-5)."""

import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_worker as W  # noqa: E402
from veles_tpu_torch.ops.optimizers import tree_leaves  # noqa: E402

torch.set_num_threads(2)

LOSS_TOL = dict(rtol=2e-5)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp8")
    return d, W.spawn("fsdp8", 8, d, timeout=300)


def _close(got, ref, what, tol=PARAM_TOL):
    ga, ra = tree_leaves(got), tree_leaves(ref)
    assert len(ga) == len(ra), what
    for a, b in zip(ga, ra):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=what, **tol)


def _slots(opt_state):
    return {k: v for k, v in opt_state.items() if not k.startswith("__")}


def _same_on_all(ranks, key):
    for r in ranks[1:]:
        for a, b in zip(tree_leaves(r[key]["state"]),
                        tree_leaves(ranks[0][key]["state"])):
            assert torch.equal(a, b), key
        assert r[key]["metrics"] == ranks[0][key]["metrics"], key


def _plain_fc(seeds, lr=0.1, clip=0.0, per_unit=None):
    """The port's one-process step on the fc workflow."""
    from veles_tpu_torch.config import root
    wf, ws, opt = W.fc_workflow(lr=lr, per_unit=per_unit)
    root.common.train.clip_norm = clip
    try:
        step = wf.make_train_step(opt)
    finally:
        root.common.train.clip_norm = 0.0
    losses = []
    for seed in seeds:
        ws, m = step(ws, W.tree_t(W.fc_batch(seed)))
        losses.append(float(m["loss"]))
    return losses, ws


def test_fsdp_rule_shards_large_params(ranks8):
    """tests/test_parallel.py:74 on the port, and what a rank stores."""
    import veles_tpu as vt
    from jax.sharding import PartitionSpec as P
    from veles_tpu.models.standard import build_workflow
    from veles_tpu.parallel import MeshSpec, fsdp_rules, make_mesh
    from veles_tpu.units import Spec
    from veles_tpu_torch.parallel.mesh import (fsdp_rules as port_fsdp,
                                               state_shardings)
    from veles_tpu_torch.runtime.snapshotter import params_to_numpy
    _, ranks = ranks8
    wf, ws, _ = W.fc_workflow()
    sh = state_shardings(ws, {"data": 2, "fsdp": 4, "model": 1, "seq": 1,
                              "pipe": 1, "expert": 1},
                         port_fsdp(min_size=W.FC_MIN))
    assert sh["params"]["fc1"]["w"] == (None, "fsdp")
    assert sh["params"]["fc1"]["b"] == ()
    for r in ranks:
        st = r["fc"]["stored"]
        assert st["params"]["fc1"]["w"] == (16, 8)
        assert st["opt_state"]["fc1"]["w"] == (16, 8)
        assert st["params"]["fc1"]["b"] == (32,)
    _same_on_all(ranks, "fc")
    got = ranks[0]["fc"]
    losses, ref = _plain_fc((9, 10))
    # the JAX package's sharded step on the same weights and batches
    mesh = make_mesh(MeshSpec(data=2, fsdp=4))
    jwf = build_workflow("fc", W.dp_layers())
    specs = {"@input": Spec((64, 16), jnp.float32),
             "@labels": Spec((64,), jnp.int32),
             "@mask": Spec((64,), jnp.float32)}
    jwf.build(specs)
    opt = vt.optimizers.SGD(0.1, momentum=0.9)
    jws = jwf.init_state(jax.random.key(0), opt)
    jws["params"] = jax.tree.map(jnp.asarray, params_to_numpy(ws["params"]))
    step, state_sh, _ = jwf.make_sharded_train_step(
        opt, mesh, jws, specs, rule=fsdp_rules(min_size=W.FC_MIN),
        donate=False)
    assert state_sh["params"]["fc1"]["w"].spec == P(None, "fsdp")
    jws = jax.device_put(jws, state_sh)
    jlosses = []
    for seed in (9, 10):
        jws, m = step(jws, {k: jnp.asarray(v)
                            for k, v in W.fc_batch(seed).items()})
        jlosses.append(float(m["loss"]))
    for i, m in enumerate(got["metrics"]):
        np.testing.assert_allclose(m["loss"], losses[i], **LOSS_TOL)
        np.testing.assert_allclose(m["loss"], jlosses[i], **LOSS_TOL)
    _close(got["state"]["params"], ref["params"], "params vs port")
    _close(got["state"]["params"], jax.tree.map(np.asarray, jws["params"]),
           "params vs JAX")
    _close(_slots(got["state"]["opt_state"]), _slots(ref["opt_state"]),
           "momentum vs port")
    _close(_slots(got["state"]["opt_state"]),
           jax.tree.map(np.asarray, {k: v for k, v in
                                     jws["opt_state"].items()
                                     if k in jws["params"]}),
           "momentum vs JAX")


@pytest.mark.parametrize("case", ["global", "per_unit"])
def test_clip_norm_spans_the_shards(ranks8, case):
    """The clip norm lies between the largest norm one rank's blocks
    give and the norm over every block: the step clips (on every rank
    alike) and equals one process's clipped step."""
    from veles_tpu_torch.ops.optimizers import HyperParams
    _, ranks = ranks8
    key = f"clip_{case}"
    _same_on_all(ranks, key)
    got = ranks[0][key]
    assert got["local"] < got["clip"] < got["full"]
    if case == "global":
        _, ref = _plain_fc((11,), lr=0.5, clip=got["clip"])
    else:
        _, ref = _plain_fc((11,), lr=0.5, per_unit={
            "fc1": HyperParams(clip_norm=got["clip"])})
    _, unclipped = _plain_fc((11,), lr=0.5)
    _close(got["state"]["params"], ref["params"], "clipped params")
    diff = np.abs(np.asarray(ref["params"]["fc1"]["w"])
                  - np.asarray(unclipped["params"]["fc1"]["w"])).max()
    assert diff > 1e-3, "the clip did not change the step"


def test_anomaly_skip_same_on_every_rank(ranks8):
    """A NaN in one data rank's rows: every rank skips the step, its
    blocks unchanged, the skip counted once."""
    _, ranks = ranks8
    _same_on_all(ranks, "nan")
    got = ranks[0]["nan"]
    assert got["metrics"]["anomaly_steps"] == 1.0
    assert got["metrics"]["loss"] == 0.0
    _, ws, _ = W.fc_workflow()
    for a, b in zip(tree_leaves(got["state"]["params"]),
                    tree_leaves(ws["params"])):
        assert torch.equal(a, b)
    assert int(got["state"]["opt_state"]["__anom_skipped__"]) == 1


def test_config_1f1b_fsdp_sharded_stage_params_matches_ad(ranks8):
    """tests/test_pipeline_product.py:832 on the port: pp2 x fsdp2 x dp2,
    each rank stores 1/(S * n_f) of the stage arrays; one fused step
    equals the one-process step and JAX's AD step on the same weights."""
    import veles_tpu as vt
    from veles_tpu.models.standard import build_workflow
    from veles_tpu.units import Spec
    from veles_tpu_torch.runtime.snapshotter import params_to_numpy
    _, ranks = ranks8
    _same_on_all(ranks, "pp_fsdp")
    got = ranks[0]["pp_fsdp"]
    assert got["stored"]["params"]["stack"]["stage_w1"] == (1, 16, 32)
    assert got["stored"]["params"]["stack"]["stage_w2"] == (1, 64, 8)
    wf, ws, opt = W.pp_fsdp_workflow()
    # a copy: the port's step writes its tensors in place
    params0 = jax.tree.map(np.array, params_to_numpy(ws["params"]))
    ws, m = wf.make_train_step(opt)(ws, W.tree_t(W.pp_fsdp_batch()))
    np.testing.assert_allclose(got["metrics"]["loss"], float(m["loss"]),
                               **LOSS_TOL)
    _close(got["state"]["params"], ws["params"], "params vs port")
    jwf = build_workflow("pp_fsdp", W.PP_FSDP_LAYERS)
    jwf.build({"@input": Spec((16, 16), jnp.float32),
               "@labels": Spec((16,), jnp.int32),
               "@mask": Spec((16,), jnp.float32)})
    jopt = vt.optimizers.SGD(0.1)
    jws = jwf.init_state(jax.random.key(1), jopt)
    jws["params"] = jax.tree.map(jnp.asarray, params0)
    jws, jm = jwf.make_train_step(jopt, donate=False)(
        jws, {k: jnp.asarray(v) for k, v in W.pp_fsdp_batch().items()})
    np.testing.assert_allclose(got["metrics"]["loss"], float(jm["loss"]),
                               **LOSS_TOL)
    _close(got["state"]["params"], jax.tree.map(np.asarray, jws["params"]),
           "params vs JAX")


def test_snapshot_gathered_restores_and_trains(ranks8):
    """tests/_multihost_train.py:48-84 on the port: the restored state
    equals the trained one on every rank (rtol 1e-6), the loader keeps
    its own shard, training continues; rank 0's gathered snapshot loads
    whole into the one-process port and into the JAX package."""
    from veles_tpu.runtime.snapshotter import Snapshotter as JaxSnapshotter
    from veles_tpu_torch.runtime.snapshotter import Snapshotter
    out_dir, ranks = ranks8
    for rank, r in enumerate(ranks):
        rec = r["trainer"]
        assert rec["shard"] == (rank, 8)
        assert rec["stored"]["params"]["fc1"]["w"] == (6, 16)
        assert rec["stored"]["opt_state"]["fc1"]["w"] == (6, 16)
        for a, b in zip(tree_leaves(rec["restored"]),
                        tree_leaves(rec["trained"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
        assert rec["results"]["epochs"] == 3
        assert rec["results2"]["epochs"] == 4
        assert np.isfinite(rec["results2"]["best_value"])
    trained = ranks[0]["trainer"]["trained"]
    path = os.path.join(str(out_dir), "snaps", "mh_current.json")
    for load in (Snapshotter.load, JaxSnapshotter.load):
        params = load(path)["wstate"]["params"]
        assert np.shape(params["fc1"]["w"]) == (24, 16)
        _close(params, trained, "snapshot", tol=dict(rtol=1e-6))
    # the one-process port restores it whole
    tr = W.mh_trainer(None, 0, 1, 4)
    tr.initialize(seed=2)
    tr.restore(path)
    _close(tr.wstate["params"], trained, "one-process restore",
           tol=dict(rtol=1e-6))


def _cli(argv):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}
    env.pop("VELES_PROCESS_ID", None)
    r = subprocess.run([sys.executable, "-m", "veles_tpu_torch", *argv],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, r.stdout
    return json.loads(lines[0])


def test_cli_data_fsdp_matches_one_process(tmp_path):
    """``--mesh data=2,fsdp=2`` on configs/induction_lm.json, 4 gloo
    ranks: one epoch trains to the no-mesh run's weights."""
    from veles_tpu_torch.runtime.snapshotter import Snapshotter, _flatten
    small = ["root.loader.n_train=64", "root.loader.n_valid=32",
             "root.loader.minibatch_size=32", "--max-epochs", "1",
             "--random-seed", "1", "--device", "cpu"]
    cfg = "configs/induction_lm.json"
    one, four = tmp_path / "one", tmp_path / "four"
    r1 = _cli([cfg, *small, "--snapshot-dir", str(one)])
    r4 = _cli([cfg, *small, "--mesh", "data=2,fsdp=2",
               "--snapshot-dir", str(four)])
    assert r1["epochs"] == r4["epochs"] == 1
    assert abs(r4["best_value"] - r1["best_value"]) <= 1.0

    def params(d):
        path = sorted(glob.glob(os.path.join(d, "*_ep*.json")))[-1]
        return _flatten(Snapshotter.load(path)["wstate"]["params"])
    p1, p4 = params(one), params(four)
    assert sorted(p1) == sorted(p4)
    for k in p1:
        np.testing.assert_allclose(p4[k], p1[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
