"""The ``seq`` and ``expert`` mesh axes in the port's train steps, on the
CPU as 8 spawned gloo ranks (tests/_torch_dist_worker.py ``suite_axes8``,
one spawn for the module, each group made with its own 60 s timeout).

* The fused 1F1B step (parallel/pipeline_compile.py) over pp2 x sp2 x
  dp2 (tests/test_pipeline_product.py:565; ragged :483; sliding window +
  GQA :803; interleaved :931) and pp2 x ep2 x dp2 (:596, interleaved
  :1001): one SGD step equals the port's one-process step (each
  microbatch's rows of each data shard through the plain forward, the
  masked losses weighted into the global masked mean, the aux losses
  averaged over those slices) and the JAX package's no-mesh forward on
  the same weights and slices — loss rtol 2e-5, parameters rtol 2e-4 /
  atol 2e-5.  The aux loss weighs in (0.01), as the reference's ep case
  asks: its statistics sum over the expert group.
* pp2 x sp2 x ep2 (:631) trains 8 steps with a falling loss; an idle
  expert axis on a model without MoE stays replication (:770); the plan
  refuses heterogeneous stages and a non-positionwise edge unit under
  seq (:675, :706).
* The sharded train step (units/workflow.py) over data=2 x seq=4,
  data=2 x expert=4 and data=2 x seq=2 x expert=2: two steps of a ragged
  batch at ample capacity equal the one-process step (rows of each data
  shard, the aux averaged over them) and JAX's; the eval step equals
  the plain one; tests/test_parallel_units.py:55-163's configs train
  with a falling loss.
* The CLI trains configs/induction_lm_pp_sp.json on ``--mesh
  data=2,seq=2,pipe=2`` (8 ranks) one epoch to the no-mesh run's
  weights."""

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
from veles_tpu_torch.ops.optimizers import tree_leaves, tree_map  # noqa: E402
from veles_tpu_torch.parallel.mesh import AXES, Mesh  # noqa: E402
from veles_tpu_torch.units.workflow import WorkflowError  # noqa: E402

torch.set_num_threads(2)

LOSS_TOL = dict(rtol=2e-5)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    return W.spawn("axes8", 8, tmp_path_factory.mktemp("axes8"),
                   timeout=400)


def _aux_units(wf):
    return [u for u in wf.units if getattr(u, "has_aux_loss", False)]


def _port_slices_sgd(layers, batch, n_slices, lr, steps):
    """The port's one-process step over ``n_slices`` contiguous row
    slices: each through the plain forward, its masked loss weighted by
    its share of the global mask count, the aux losses averaged over the
    slices; SGD(lr).  Returns the losses and the params."""
    from veles_tpu_torch.units.base import Context
    from veles_tpu_torch.units.workflow import sample_count
    wf, ws, _ = W.axes_workflow(layers, batch, lr)
    params = ws["params"]
    b = W.tree_t(batch)
    ev = wf.evaluator
    norm = sample_count(ev, [b[k] for k in ev.inputs[1:]]).clamp_min(1.0)
    rows = np.split(np.arange(len(batch["@mask"])), n_slices)
    losses = []
    for _ in range(steps):
        live = [p.detach().clone().requires_grad_(True)
                for p in tree_leaves(params)]
        it = iter(live)
        lp = tree_map(lambda _: next(it), params)
        obj = loss = 0.0
        for r in rows:
            sl = {k: v[r] for k, v in b.items()}
            out, ns = wf.forward(lp, ws["state"], sl, Context(train=True))
            part = out[ev.name] * sample_count(
                ev, [sl[k] for k in ev.inputs[1:]]) / norm
            loss = loss + float(part.detach())
            obj = obj + part + sum(u.aux_weight * ns[u.name]["aux_loss"]
                                   for u in _aux_units(wf)) / n_slices
        grads = torch.autograd.grad(obj, live, allow_unused=True)
        it = iter([p - lr * (0 if g is None else g)
                   for p, g in zip(live, grads)])
        params = tree_map(lambda _: next(it).detach(), params)
        losses.append(loss)
    return losses, params


def _jax_slices_sgd(layers, batch, params0, n_slices, lr, steps):
    """The same objective through the JAX package's no-mesh forward on
    the port's initial weights."""
    from veles_tpu.models.standard import build_workflow
    from veles_tpu.units import Spec
    from veles_tpu.units.base import Context
    from veles_tpu_torch.runtime.snapshotter import params_to_numpy
    jwf = build_workflow("axes", layers)
    jwf.build({k: Spec(v.shape, jnp.asarray(v).dtype)
               for k, v in batch.items()})
    ev = jwf.evaluator
    mask = batch["@mask"]
    per = float(np.prod(batch["@labels"].shape[1:]))
    norm = max(float(mask.sum()) * per, 1.0)
    rows = np.split(np.arange(len(mask)), n_slices)
    auxes = _aux_units(jwf)

    def obj(p):
        tot, loss = 0.0, 0.0
        for r in rows:
            sl = {k: jnp.asarray(v[r]) for k, v in batch.items()}
            out, ns = jwf.forward(p, {}, sl, Context(train=True))
            part = out[ev.name] * float(mask[r].sum()) * per / norm
            loss = loss + part
            tot = tot + part + sum(u.aux_weight * ns[u.name]["aux_loss"]
                                   for u in auxes) / n_slices
        return tot, loss

    vg = jax.jit(jax.value_and_grad(obj, has_aux=True))
    p = jax.tree.map(jnp.asarray, params_to_numpy(params0))
    losses = []
    for _ in range(steps):
        (_, loss), g = vg(p)
        p = jax.tree.map(lambda a, b: a - lr * b, p, g)
        losses.append(float(loss))
    return losses, p


def _match(got, layers, batch, n_slices, lr, steps=1):
    """``got`` (a suite's params and metrics) against the port's and the
    JAX package's one-process step."""
    from veles_tpu_torch.runtime.snapshotter import params_to_numpy
    losses, params = _port_slices_sgd(layers, batch, n_slices, lr, steps)
    _, ws, _ = W.axes_workflow(layers, batch, lr)
    jlosses, jparams = _jax_slices_sgd(layers, batch, ws["params"],
                                       n_slices, lr, steps)
    for i, m in enumerate(got["metrics"]):
        np.testing.assert_allclose(m["loss"], losses[i], **LOSS_TOL)
        np.testing.assert_allclose(m["loss"], jlosses[i], **LOSS_TOL)
    gp = params_to_numpy(got["params"])
    for ref in (params_to_numpy(params),
                jax.tree.map(np.asarray, jparams)):
        for a, b in zip(tree_leaves(W.tree_t(gp)),
                        tree_leaves(W.tree_t(ref))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **PARAM_TOL)


def _same_on_all(ranks, key):
    for r in ranks[1:]:
        for a, b in zip(tree_leaves(r[key]["params"]),
                        tree_leaves(ranks[0][key]["params"])):
            assert torch.equal(a, b), key
        assert r[key]["metrics"] == ranks[0][key]["metrics"]


FUSED = {
    # key: (layers, batch, n_slices = n_mb x the row-splitting ranks)
    "sp": (lambda: W.per_position_layers(W.SP_STAGE, 2),
           lambda: W.lm_batch(1, 8, 8), 4),
    "sp_ragged": (lambda: W.per_position_layers(W.SP_STAGE, 2),
                  lambda: W.lm_batch(1, 8, 8, ragged=3), 4),
    "sp_swa_gqa": (lambda: W.per_position_layers(W.SWA_STAGE, 2),
                   lambda: W.lm_batch(2, 8, 16), 4),
    "sp_interleaved": (lambda: W.per_position_layers(W.SP_STAGE, 4),
                       lambda: W.lm_batch(1, 8, 8), 4),
    # rows split over data x expert; each expert group pools a data
    # shard's rows
    "ep": (lambda: W.per_position_layers(W.EP_STAGE, 2),
           lambda: W.lm_batch(1, 8, 8), 4),
    "ep_interleaved": (lambda: W.per_position_layers(W.EP_BLOCK, 4),
                       lambda: W.lm_batch(1, 8, 8), 4),
}


@pytest.mark.parametrize("key", sorted(FUSED))
def test_fused_step_matches_one_process(ranks8, key):
    """One fused 1F1B step on 8 ranks equals the one-process step and
    JAX's; every rank ends with the same parameters."""
    layers, batch, n_slices = FUSED[key]
    _same_on_all(ranks8, key)
    _match(ranks8[0][key], layers(), batch(), n_slices, 0.1)


def test_rank_layout_and_in_stage_axes(ranks8):
    """Ranks sit where the JAX mesh puts devices (data, seq, pipe); the
    plan runs the ring and the expert exchange inside the stages on the
    shared template, and keeps an idle expert axis out."""
    from veles_tpu_torch.parallel.pipeline_compile import PipelinePlan
    assert [r["coords"]["seq"] for r in ranks8] == [0, 0, 1, 1] * 2
    assert [r["coords"]["pipe"] for r in ranks8] == [0, 1] * 4
    assert [r["coords"]["data"] for r in ranks8] == [0] * 4 + [1] * 4
    for spec, layers, batch, manual, baxes in (
            (dict(data=2, seq=2, pipe=2),
             W.per_position_layers(W.SP_STAGE, 2), W.lm_batch(1, 8, 8),
             ("seq",), ("data",)),
            (dict(data=2, expert=2, pipe=2),
             W.per_position_layers(W.EP_STAGE, 2), W.lm_batch(1, 8, 8),
             ("expert",), ("data", "expert")),
            (dict(data=2, expert=2, pipe=2), W.het_layers(),
             W.lm_batch(1, 8, 8, per_position=False), (), ("data",))):
        wf, _, _ = W.axes_workflow(layers, batch, 0.1)
        plan = PipelinePlan(wf, _mesh(**spec), 2)
        assert plan.manual == manual and plan.batch_axes == baxes
        assert plan.shared == bool(manual)
    idle = ranks8[0]["ep_idle"]["metrics"][0]
    assert np.isfinite(idle["loss"]) and idle["aux"] == 0.0
    _same_on_all(ranks8, "ep_idle")


def test_schedule_width_axes(ranks8):
    """``pipeline_train_step(width_axes=("seq",))`` (:612-621): each
    sample's sequence dim splits over the seq ranks, the loss (a mean
    over this rank's chunk) reduces over them like a batch axis; equal
    to the whole sequence through the stages in one process."""
    p, x, y = W.width_data()
    live = [{k: W.t(v[i]).requires_grad_(True) for k, v in p.items()}
            for i in range(2)]
    loss = 0.0
    for m in range(x.shape[0]):
        h = W.t(x[m])
        for lp in live:
            h = W.tanh_stage(lp, h)
        loss = loss + W.mse(h, W.t(y[m])) / x.shape[0]
    grads = torch.autograd.grad(loss, [lp[k] for lp in live
                                       for k in ("b", "w")])
    for r in ranks8:
        got_loss, got = r["width"]
        np.testing.assert_allclose(float(got_loss), float(loss.detach()),
                                   rtol=1e-5)
        for i, lp in enumerate(live):
            for j, k in enumerate(("b", "w")):
                np.testing.assert_allclose(got[k][i].numpy(),
                                           grads[2 * i + j].numpy(),
                                           rtol=1e-5, atol=1e-6)


def test_sp_ep_composed_trains(ranks8):
    """pp2 x sp2 x ep2: attention + dropout + MoE blocks, the ring and
    the expert exchange in every stage; 8 steps, finite, loss falls."""
    _same_on_all(ranks8, "sp_ep")
    mets = ranks8[0]["sp_ep"]["metrics"]
    losses = [m["loss"] for m in mets]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["aux"])
               for m in mets)
    assert mets[0]["aux"] > 0
    assert losses[-1] < losses[0], losses


def _mesh(**sizes):
    return Mesh({**{a: 1 for a in AXES}, **sizes})


@pytest.mark.parametrize("case", ["heterogeneous", "non_positionwise",
                                  "moe_edge"])
def test_plan_refusals(case):
    """Under seq/expert the plan refuses stages that are not
    structurally identical, a folded edge unit that mixes positions, and
    a MoE unit in an edge stage."""
    b = W.lm_batch(1, 8, 8, per_position=case != "non_positionwise")
    if case == "heterogeneous":
        layers, mesh, match = W.het_layers(), _mesh(seq=2, pipe=2), \
            "IDENTICAL"
        layers[2:] = [{"type": "softmax", "output_size": W.AX_V,
                       "per_position": True, "name": "out"}]
    elif case == "non_positionwise":
        layers = W.per_position_layers(W.SP_STAGE, 2)
        layers[2:] = [{"type": "seq_last", "name": "last"},
                      {"type": "softmax", "output_size": W.AX_V,
                       "name": "out"}]
        mesh, match = _mesh(seq=2, pipe=2), "positionwise"
    else:
        layers = W.per_position_layers(W.SP_STAGE, 2)
        layers.insert(1, {"type": "moe", "n_experts": 2, "d_hidden": 8,
                          "name": "edge_moe"})
        mesh, match = _mesh(data=2, expert=2, pipe=2), "edge"
    wf, _, opt = W.axes_workflow(layers, b, 0.1)
    with pytest.raises(WorkflowError, match=match):
        wf.make_pipeline_train_step(opt, mesh, n_microbatches=2)


@pytest.mark.parametrize("spec,kind", W.SHARDED_MESHES,
                         ids=[s for s, _ in W.SHARDED_MESHES])
def test_sharded_step_matches_one_process(ranks8, spec, kind):
    """Two sharded steps of a ragged batch at ample capacity equal the
    one-process step over the two data shards and JAX's; the eval step
    equals the plain eval on the whole batch."""
    key = f"exact_{spec}"
    _same_on_all(ranks8, key)
    layers = W.unit_layers(kind, capacity_factor=8.0)
    batch = W.unit_batch(3, ragged=2)
    got = ranks8[0][key]
    _match(got, layers, batch, 2, 0.1, steps=2)
    assert got["metrics"][0]["n_samples"] == 6.0
    wf, ws, _ = W.axes_workflow(layers, batch, 0.1)
    ws["params"] = got["params"]
    ref = wf.make_eval_step()(ws, W.tree_t(batch))
    for k, v in ref.items():
        np.testing.assert_allclose(got["eval"][k], float(v), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("spec,kind", W.SHARDED_MESHES,
                         ids=[s for s, _ in W.SHARDED_MESHES])
def test_sharded_step_trains(ranks8, spec, kind):
    """tests/test_parallel_units.py:55-163 on the port: the attention
    config on data=2 x seq=4 (loss below 0.7 of the first), the MoE
    config on data=2 x expert=4 (below 0.8, aux reported and finite),
    both on data=2 x seq=2 x expert=2 (falls in 15 steps)."""
    mets = ranks8[0][f"trains_{spec}"]["metrics"]
    losses = [m["loss"] for m in mets]
    assert np.isfinite(losses).all()
    bound = {"sp": 0.7, "ep": 0.8, "sp_ep": 1.0}[kind]
    assert losses[-1] < losses[0] * bound, losses
    if kind != "sp":
        assert np.isfinite(mets[-1]["aux_moe1"])


@pytest.mark.parametrize("step", ["sharded", "fused"])
def test_indivisible_expert_batch_refused(step):
    """MoE units exchange tokens over the expert axis: a batch (in the
    fused step, a microbatch) whose rows it does not divide is refused
    by the one layout both steps share, not run on copies."""
    from veles_tpu_torch.parallel.pipeline_compile import PipelinePlan
    from veles_tpu_torch.units.workflow import _Layout
    with pytest.raises(ValueError, match="expert axis"):
        if step == "sharded":
            b = W.unit_batch(B=6)
            wf, _, _ = W.axes_workflow(W.unit_layers("ep"), b, 0.1)
            _Layout(wf, _mesh(expert=4), W.tree_t(b))
        else:
            # 8 rows in 4 microbatches of 2 over expert=4
            wf, _, _ = W.axes_workflow(W.per_position_layers(
                W.EP_STAGE, 2, n_mb=4), W.lm_batch(1, 8, 8), 0.1)
            PipelinePlan(wf, _mesh(data=2, expert=4, pipe=2), 4)


def _cli(argv):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    env.pop("VELES_PROCESS_ID", None)
    r = subprocess.run([sys.executable, "-m", "veles_tpu_torch", *argv],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, r.stdout
    return json.loads(lines[0])


def test_pp_sp_config_on_its_mesh_matches_one_process(tmp_path):
    """configs/induction_lm_pp_sp.json on its published mesh, 8 gloo
    ranks: one epoch trains to the no-mesh run's weights."""
    from veles_tpu_torch.runtime.snapshotter import Snapshotter, _flatten
    small = ["root.loader.n_train=64", "root.loader.n_valid=32",
             "root.loader.minibatch_size=32", "--max-epochs", "1",
             "--random-seed", "1", "--device", "cpu"]
    cfg = "configs/induction_lm_pp_sp.json"
    one, eight = tmp_path / "one", tmp_path / "eight"
    r1 = _cli([cfg, *small, "--snapshot-dir", str(one)])
    r8 = _cli([cfg, *small, "--mesh", "data=2,seq=2,pipe=2",
               "--snapshot-dir", str(eight)])
    assert r1["epochs"] == r8["epochs"] == 1
    assert abs(r8["best_value"] - r1["best_value"]) <= 1.0

    def params(d):
        path = sorted(glob.glob(os.path.join(d, "*_ep*.json")))[-1]
        return _flatten(Snapshotter.load(path)["wstate"]["params"])
    p1, p8 = params(one), params(eight)
    assert sorted(p1) == sorted(p8)
    for k in p1:
        np.testing.assert_allclose(p8[k], p1[k], err_msg=k, **PARAM_TOL)
