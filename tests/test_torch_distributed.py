"""The port's process groups, mesh and launcher (parallel/mesh.py,
parallel/distributed.py, parallel/launcher.py, the trainer and the CLI's
``--mesh``/``--hosts``) on the CPU, as spawned gloo ranks
(tests/_torch_dist_worker.py), each group made with its own timeout.

``MeshSpec.axis_sizes`` and the rank layout equal the JAX package's
(tests/test_parallel.py:37).  Two-rank data parallelism equals one
process (tests/test_parallel.py:48): three steps' losses rtol 1e-5 (a
ragged tail batch among them), the parameters after them rtol 1e-5 /
atol 1e-6, and a trainer with a Decision rollback keeps its groups and
its steps (tests/test_parallel.py:156) and ends where one process does
(parameters rtol 1e-4 / atol 1e-5); rank 0 alone writes snapshots.  A
rank that never joins fails the other's collective within the group's
timeout.  The launcher's two-rank CLI runs (tests/test_multihost.py:31
and :67): induction_lm.json data-parallel, and induction_lm_pp.json on
the fused schedule (pipe=2, interleave 2), each against one process.
The fsdp and model axes run (tests/test_torch_fsdp.py and
tests/test_torch_tensor_parallel.py hold them to the one-process step);
a multi-rank mesh on the card is refused."""

import glob
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_worker as W  # noqa: E402
from veles_tpu.parallel.mesh import MeshSpec as JaxMeshSpec  # noqa: E402
from veles_tpu_torch.ops.optimizers import tree_leaves  # noqa: E402
from veles_tpu_torch.parallel.mesh import (AXES, Mesh, MeshSpec,  # noqa: E402
                                           axis_groups, check_axes,
                                           rank_coords)

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


@pytest.mark.parametrize("spec,n", [
    (dict(), 8), (dict(data=-1, model=2), 8), (dict(data=2, pipe=4), 8),
    (dict(data=2, pipe=2), 4), (dict(pipe=-1), 4), (dict(data=3, model=2), 8)])
def test_mesh_spec_tiling_equals_jax(spec, n):
    try:
        want = JaxMeshSpec(**spec).axis_sizes(n)
    except ValueError as e:
        with pytest.raises(ValueError, match="does not tile"):
            MeshSpec(**spec).axis_sizes(n)
        assert "does not tile" in str(e)
        return
    assert MeshSpec(**spec).axis_sizes(n) == want


def test_rank_layout_is_the_jax_device_layout():
    """Rank r sits where ``make_mesh`` reshapes device r: row-major over
    (data, fsdp, model, seq, pipe, expert)."""
    sizes = MeshSpec(data=2, pipe=2).axis_sizes(4)
    grid = np.arange(4).reshape([sizes[a] for a in AXES])
    for r in range(4):
        c = rank_coords(r, sizes)
        assert grid[tuple(c[a] for a in AXES)] == r
    assert axis_groups("pipe", sizes) == [[0, 1], [2, 3]]
    assert axis_groups("data", sizes) == [[0, 2], [1, 3]]
    m = Mesh(sizes, 3)
    assert m.axis_ranks("pipe") == [2, 3] and m.axis_index("data") == 1
    assert MeshSpec.parse("data=2,pipe=2") == MeshSpec(data=2, pipe=2)


def test_placement_rules_and_host_helpers_equal_jax():
    """``data_parallel_rules``, ``pipeline_rules`` and
    ``pipeline_stage_shardings`` give the JAX package's partitions (as
    tuples), ``state_shardings`` walks a state tree, ``gather_to_host``
    copies it to numpy, and a lone process is one host."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from veles_tpu.parallel.mesh import data_parallel_rules as jax_dp
    from veles_tpu.units.parallel_nn import pipeline_rules as jax_pp
    from veles_tpu_torch.parallel import distributed as pd
    from veles_tpu_torch.parallel.mesh import (AXES, data_parallel_rules,
                                               state_shardings)
    from veles_tpu_torch.parallel.pipeline import pipeline_stage_shardings
    from veles_tpu_torch.units.parallel_nn import pipeline_rules
    params = {"stack": {"stage_w1": torch.zeros(3, 4, 5),
                        "stage_w2": torch.zeros(3, 5, 4)},
              "out": {"w": torch.zeros(4, 2)}}
    sizes = {a: 1 for a in AXES}
    sizes["pipe"] = 3
    got = state_shardings(params, sizes, pipeline_rules())
    rule = jax_pp()
    for u, sub in params.items():
        for k, t in sub.items():
            want = rule(("params", u, k),
                        jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32))
            # the guard trims trailing None: the same partition
            want = tuple(want)
            while want and want[-1] is None:
                want = want[:-1]
            assert got[u][k] == want, (u, k)
    assert data_parallel_rules(("x",), (4,)) == () and \
        jax_dp(("x",), None) == P()
    assert pipeline_stage_shardings(params["stack"]) == {
        "stage_w1": ("pipe", None, None), "stage_w2": ("pipe", None, None)}
    host = pd.gather_to_host({"a": torch.ones(2), "b": [torch.zeros(1)]})
    assert isinstance(host["a"], np.ndarray) and host["b"][0].shape == (1,)
    assert pd.host_count() == 1 and pd.host_index() == 0
    assert not pd.is_multihost()
    assert pd.initialize_distributed() is False     # no coordinator


def test_item_6b_axes_raise():
    """Every axis runs now: the mesh takes fsdp and model (an unknown
    axis raises), attention and MoE on seq and expert and a model split
    reach their collectives (which need the axes' process groups, absent
    from a one-process mesh), and the CLI trains on ``--mesh fsdp=2``."""
    from veles_tpu_torch.units.base import Context, Spec
    from veles_tpu_torch.units.parallel_nn import MoEFFN, MultiHeadAttention
    for axis in ("fsdp", "model", "seq", "expert"):
        check_axes({axis: 2})
    with pytest.raises(ValueError, match="unknown mesh axis"):
        check_axes({"tensor": 2})
    sizes = {**{a: 1 for a in AXES}, "seq": 2, "expert": 2}
    ctx = Context(mesh=Mesh(sizes))
    attn = MultiHeadAttention(2, name="a")
    p, _ = attn.init(torch.Generator(), [Spec((1, 4, 8), torch.float32)],
                     "cpu")
    with pytest.raises(RuntimeError, match="'seq' axis .* process group"):
        attn.apply(p, {}, [torch.zeros(1, 4, 8)], ctx)
    moe = MoEFFN(2, 8, name="m")
    p, _ = moe.init(torch.Generator(), [Spec((4, 8), torch.float32)], "cpu")
    with pytest.raises(RuntimeError, match="'expert' axis .* process group"):
        moe.apply(p, {}, [torch.zeros(4, 8)], ctx)
    split = {k: (None, "model") for k in ("wq", "wk", "wv")}
    split["wo"] = ("model",)
    ctx = Context(mesh=Mesh({**{a: 1 for a in AXES}, "model": 2}),
                  tp={"a": split})
    p, _ = attn.init(torch.Generator(), [Spec((1, 4, 8), torch.float32)],
                     "cpu")
    with pytest.raises(RuntimeError, match="'model' axis .* process group"):
        attn.apply(p, {}, [torch.zeros(1, 4, 8)], ctx)
    r = _cli(["configs/induction_lm.json", *SMALL, "--mesh", "fsdp=2"])
    assert _results(r)["epochs"] == 1


def test_multi_rank_mesh_refused_on_the_card(monkeypatch):
    """A run on the card has one rank: a larger mesh stops, naming why,
    and a rank group larger than the host's GPUs is refused."""
    import argparse

    from veles_tpu_torch import __main__ as cli
    from veles_tpu_torch.parallel import distributed
    monkeypatch.delenv("VELES_PROCESS_ID", raising=False)
    monkeypatch.setattr(cli, "resolve_device",
                        lambda d: torch.device("cuda"))
    args = argparse.Namespace(hosts=None, mesh="data=2", device=None)
    with pytest.raises(SystemExit, match="one rank"):
        cli._launch_ranks(args, [])
    monkeypatch.setattr("veles_tpu_torch.ops.resolve_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one rank drives"):
        distributed.initialize_distributed("127.0.0.1:1", 2, 0)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    return out, W.spawn("dp", 2, out)


def test_data_parallel_steps_match_one_process(dp):
    """Three sharded steps on 2 ranks (the last batch ragged) against the
    plain step on the whole batch."""
    _, res = dp
    wf, ws, opt = W.dp_workflow()
    step = wf.make_train_step(opt)
    for b, r0, r1 in zip(W.dp_batches(), res[0]["steps"], res[1]["steps"]):
        ws, mets = step(ws, W.tree_t(b))
        assert r0 == r1
        for k in ("loss", "n_err", "n_samples", "grad_norm"):
            np.testing.assert_allclose(r0[k], float(mets[k]), rtol=1e-5,
                                       err_msg=k)
    for a, b, c in zip(tree_leaves(res[0]["params"]),
                       tree_leaves(res[1]["params"]),
                       tree_leaves(ws["params"])):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_trainer_rollback_keeps_the_groups(dp):
    """A trainer on the mesh rolls back (Decision rollback_after=1) and
    keeps its sharded steps and groups, with no rebuild; it ends where
    one process ends; rank 0 alone wrote snapshots."""
    from veles_tpu_torch.ops.optimizers import SGD
    from veles_tpu_torch.runtime.decision import Decision
    from veles_tpu_torch.runtime.trainer import Trainer
    out, res = dp
    t0, t1 = res[0]["trainer"], res[1]["trainer"]
    assert t0["rollbacks"] >= 1 and t0["rollbacks"] == t1["rollbacks"]
    assert t0["sharded"] and t0["same_group"]
    assert t0["compiles"] == 2               # train + eval, built once
    wf, _, _ = W.dp_workflow()
    tr = Trainer(wf, W.dp_loader(), SGD(0.05, momentum=0.9),
                 Decision(max_epochs=3, fail_iterations=10,
                          rollback_after=1), device="cpu")
    tr.initialize(seed=0)
    tr.run()
    assert t0["best_value"] == t1["best_value"]
    assert abs(t0["best_value"] - tr.decision.best_value) <= 0.5
    for a, b, c in zip(tree_leaves(t0["params"]),
                       tree_leaves(t1["params"]),
                       tree_leaves(tr.wstate["params"])):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-4,
                                   atol=1e-5)
    assert glob.glob(os.path.join(out, "snaps0", "dp_*.json"))
    assert not glob.glob(os.path.join(out, "snaps1", "*"))


def test_hung_rank_fails_within_the_group_timeout(tmp_path):
    """Rank 1 never joins the collective; rank 0's all-reduce fails
    within the 5 s group timeout instead of waiting forever."""
    res = W.spawn("hang", 2, tmp_path, timeout=60, wait_ranks=[0])[0]
    assert res["error"] is not None
    assert res["waited_s"] < 30, res


def _cli(argv, check=True, timeout=240):
    # two threads a process: the suite's workers share the host's cores
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}
    env.pop("VELES_PROCESS_ID", None)
    r = subprocess.run([sys.executable, "-m", "veles_tpu_torch", *argv],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=timeout, env=env)
    if check:
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r


def _results(r):
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, r.stdout
    return json.loads(lines[0])


def _snapshot_params(d):
    from veles_tpu_torch.runtime.snapshotter import Snapshotter, _flatten
    path = sorted(glob.glob(os.path.join(d, "*_ep*.json")))[-1]
    return _flatten(Snapshotter.load(path)["wstate"]["params"])


SMALL = ["root.loader.n_train=64", "root.loader.n_valid=32",
         "root.loader.minibatch_size=32", "--max-epochs", "1",
         "--random-seed", "1", "--device", "cpu"]


@pytest.mark.parametrize("case", [
    ("induction_lm", [], ["--hosts", "localhost,localhost"], 1e-5),
    ("induction_lm_pp", ["root.workflow.pipeline_interleave=2"],
     ["--mesh", "pipe=2"], 1e-4)],
    ids=["data_parallel_hosts", "pp2_fused"])
def test_two_rank_cli_matches_one_process(tmp_path, case):
    """The two-rank CLI: one results line, written by rank 0 with its
    snapshots; the trained weights equal one process's."""
    name, overrides, extra, tol = case
    cfg = f"configs/{name}.json"
    one, two = tmp_path / "one", tmp_path / "two"
    r1 = _cli([cfg, *SMALL, "--snapshot-dir", str(one)])
    r2 = _cli([cfg, *overrides, *SMALL, *extra, "--snapshot-dir", str(two),
               "--result-file", str(tmp_path / "res.json")])
    res1, res2 = _results(r1), _results(r2)
    assert json.load(open(tmp_path / "res.json")) == res2
    assert res2["epochs"] == res1["epochs"] == 1
    assert abs(res2["best_value"] - res1["best_value"]) <= 1.0
    p1, p2 = _snapshot_params(one), _snapshot_params(two)
    assert sorted(p1) == sorted(p2)
    for k in p1:
        np.testing.assert_allclose(p2[k], p1[k], rtol=tol, atol=tol,
                                   err_msg=k)
