"""The port's pipeline schedules (parallel/pipeline.py,
parallel/pipeline_compile.py) across spawned gloo ranks on the CPU: one
2-rank group (pipe=2) and one 4-rank group (data=2 x pipe=2, then
pipe=4), each spawned once for the module (tests/_torch_dist_worker.py;
each group made with its own 60 s timeout).

Held against the port's own sequential math (the same stages, one
process, autograd) at f32 rtol 1e-5 / atol 1e-6 (only summation orders
differ), and against the JAX package's sequential autodiff at rtol 1e-4:
the GPipe forward, the fused 1F1B step (uniform, heterogeneous, the
S x M sweep, data x pipe, a stochastic stage with an aux loss), the
interleaved schedule, and whole workflows on the fused step (dropout
and MoE inside the stages, a ragged tail batch, a stateful normalizer,
the interleaved plan, data x pipe) — the contracts of tests/test_pipeline_moe.py:255-420 and
:504-585 and tests/test_pipeline_product.py:59-482, :720 and :888 that
need no seq/expert/fsdp axis.  Also: ``bubble_fraction`` equals JAX's,
and a stack whose stage count does not fit the pipe axis is refused."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_worker as W  # noqa: E402
from veles_tpu.parallel.pipeline import (  # noqa: E402
    bubble_fraction as jax_bubble)
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.ops.optimizers import tree_leaves, tree_map  # noqa: E402
from veles_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from veles_tpu_torch.parallel.pipeline import bubble_fraction  # noqa: E402
from veles_tpu_torch.units.base import Context  # noqa: E402
from veles_tpu_torch.units.workflow import WorkflowError  # noqa: E402

torch.set_num_threads(2)

SEQ_TOL = dict(rtol=1e-5, atol=1e-6)
JAX_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return W.spawn("schedules2", 2, tmp_path_factory.mktemp("s2"))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return W.spawn("schedules4", 4, tmp_path_factory.mktemp("s4"))


def _close(a, b, tol=SEQ_TOL, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), err_msg=what,
                               **tol)


def _same_on_all(results, key):
    """Every rank returns the same (loss, grads)."""
    ref = results[0][key]
    for r in results[1:]:
        for a, b in zip(tree_leaves(ref), tree_leaves(r[key])):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), key


def _seq_uniform(p, x, y, fns=None, keyed=False, rng=None):
    """The port's sequential reference: every microbatch through every
    stage in one process, mean of the microbatch losses (+ aux)."""
    L = len(fns) if fns is not None else p["w"].shape[0]
    live = [tree_map(lambda a: a.clone().requires_grad_(True),
                     p[i] if fns is not None else
                     {k: v[i] for k, v in p.items()}) for i in range(L)]
    M = x.shape[0]
    loss = aux_t = 0.0
    for m in range(M):
        h = torch.from_numpy(x[m])
        for i in range(L):
            fn = fns[i] if fns is not None else (
                W.keyed_stage if keyed else W.tanh_stage)
            if keyed:
                h, a = fn(live[i], h, prng.fold_in(rng, m))
                aux_t = aux_t + a
            else:
                h = fn(live[i], h)
        loss = loss + W.mse(h, torch.from_numpy(y[m]))
    total = (loss + aux_t) / M
    grads = torch.autograd.grad(total, [t for lp in live
                                        for t in tree_leaves(lp)])
    return float(loss.detach()) / M, float(aux_t) / M, grads


def _jax_uniform(p, x, y):
    def f(p):
        h = jnp.asarray(x)
        for i in range(p["w"].shape[0]):
            h = jnp.tanh(h @ p["w"][i] + p["b"][i][None])
        return jnp.mean(jnp.mean((h - y) ** 2, axis=(1, 2)))
    return jax.value_and_grad(f)(jax.tree.map(jnp.asarray, p))


def test_bubble_fraction_equals_jax():
    for S in (1, 2, 4, 8):
        for M in (1, 4, 16):
            assert bubble_fraction(S, M) == jax_bubble(S, M)


def test_gpipe_forward_equals_sequential(ranks2):
    ps, x, _ = W.hetero_data(1, 4, 3, 8)
    with torch.no_grad():
        h = torch.from_numpy(x)
        h = W.res_stage(W.tree_t(ps[1]), W.tanh_stage(W.tree_t(ps[0]), h))
    for r in ranks2:
        _close(r["apply"], h)


@pytest.mark.parametrize("M", [2, 4, 6])
def test_1f1b_sweep_matches_sequential_and_jax(ranks2, M):
    """S=2 over M microbatches: (loss, grads) equal the sequential
    autodiff of the mean microbatch loss, in the port and in JAX."""
    key = f"uniform_M{M}"
    _same_on_all(ranks2, key)
    loss, grads = ranks2[0][key]
    p, x, y = W.uniform_data(M, 2, M, 3, 8)
    sl, _, sg = _seq_uniform(W.tree_t(p), x, y)
    _close(float(loss), sl)
    got = [grads["b"], grads["w"]]
    L = 2
    seq = {"b": torch.stack([sg[2 * i] for i in range(L)]),
           "w": torch.stack([sg[2 * i + 1] for i in range(L)])}
    _close(got[0], seq["b"], what="b")
    _close(got[1], seq["w"], what="w")
    jl, jg = _jax_uniform(p, x, y)
    _close(float(loss), float(jl), JAX_TOL)
    _close(grads["w"], jg["w"], JAX_TOL)
    _close(grads["b"], jg["b"], JAX_TOL)


def test_1f1b_heterogeneous_stages(ranks2):
    _same_on_all(ranks2, "hetero")
    loss, grads = ranks2[0]["hetero"]
    ps, x, y = W.hetero_data(2, 4, 3, 8)
    sl, _, sg = _seq_uniform([W.tree_t(p) for p in ps], x, y,
                             fns=[W.tanh_stage, W.res_stage])
    _close(float(loss), sl)
    for a, b in zip([g for gl in grads for g in tree_leaves(gl)], sg):
        _close(a, b)


def test_interleaved_matches_sequential(ranks2):
    """v=2 on pipe=2 (4 virtual stages): the same (loss, grads) as the
    sequential 4-stage stack."""
    _same_on_all(ranks2, "interleaved")
    loss, grads = ranks2[0]["interleaved"]
    p, x, y = W.uniform_data(3, 4, 4, 3, 8)
    sl, _, sg = _seq_uniform(W.tree_t(p), x, y)
    _close(float(loss), sl)
    _close(grads["w"], torch.stack([sg[2 * i + 1] for i in range(4)]))
    _close(grads["b"], torch.stack([sg[2 * i] for i in range(4)]))
    jl, jg = _jax_uniform(p, x, y)
    _close(grads["w"], jg["w"], JAX_TOL)


def test_keyed_stage_dropout_and_aux(ranks2):
    """A stochastic stage draws from fold_in(rng, m) under the schedule
    exactly as the sequential form does, and its aux loss joins the
    gradient with cotangent 1 (mean over microbatches)."""
    loss, aux, grads = ranks2[0]["keyed"]
    p, x, y = W.uniform_data(4, 2, 4, 3, 8)
    sl, sa, sg = _seq_uniform(W.tree_t(p), x, y, keyed=True, rng=(3, 9))
    _close(float(loss), sl)
    _close(float(aux), sa)
    _close(grads["w"], torch.stack([sg[1], sg[3]]))
    _close(grads["b"], torch.stack([sg[0], sg[2]]))


def _seq_workflow(layers, B, T, n_mb, seed=3, n_data=1):
    """The port's sequential reference of a fused workflow step: each
    microbatch forward with the key fold_in(sub, m), its masked loss
    weighted by its share of the global mask count, the stack's aux
    over n_mb * n_data; the gradient of the sum."""
    from veles_tpu_torch.units.workflow import split_state_key
    wf, ws, _ = W.pp_workflow(layers, B, T, seed)
    batch = W.tree_t(W.pp_batch(seed, B, T))
    _, sub = split_state_key(ws["key"])
    live = tree_map(lambda a: a.clone().requires_grad_(True),
                    ws["params"])
    norm = batch["@mask"].sum().clamp_min(1.0)
    mb = B // n_mb
    total = loss_t = aux_t = 0.0
    for m in range(n_mb):
        for d in range(n_data):
            rows = slice(m * mb + d * mb // n_data,
                         m * mb + (d + 1) * mb // n_data)
            out, ns = wf.forward(live, ws["state"],
                                 {k: v[rows] for k, v in batch.items()},
                                 Context(train=True,
                                         key=prng.fold_in(sub, m)))
            lm = out["evaluator"] * batch["@mask"][rows].sum() / norm
            aux = ns.get("stack", {}).get("aux_loss", torch.zeros(()))
            total = total + lm + aux / (n_mb * n_data)
            loss_t = loss_t + float(lm)
            aux_t = aux_t + float(aux) / (n_mb * n_data)
    grads = torch.autograd.grad(total, tree_leaves(live),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, tree_leaves(live))]
    return loss_t, aux_t, grads, ws


@pytest.mark.parametrize("case", [
    ("workflow", dict(n_stages=2), 4, 1),
    ("workflow_plain", dict(n_stages=2, moe=False, dropout=False), 2, 1),
    ("workflow_interleaved", dict(n_stages=4, moe=False, dropout=False),
     4, 1)], ids=["dropout_moe_ragged", "plain", "interleaved"])
def test_fused_workflow_step_matches_sequential(ranks2, case):
    """A whole workflow on the fused step (embedding folded into stage
    0, seq_last + head + loss into the last): the SGD(1) update equals
    minus the sequential gradient, the loss the global masked mean and
    the aux its mean; every rank ends with the same parameters."""
    key, kw, n_mb, _ = case
    layers = W.pp_layers(**kw)
    _same_on_all(ranks2, key)
    res = ranks2[0][key]
    sl, sa, sg, ws = _seq_workflow(layers, 16, 6, n_mb)
    _close(res["metrics"]["loss"], sl)
    _close(res["metrics"]["aux"], sa)
    assert res["metrics"]["n_samples"] == 16
    for a, b in zip(tree_leaves(res["grads"]), sg):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=2e-6)


def test_fused_plain_workflow_matches_jax(ranks2):
    """Without dropout the fused step's gradient is the JAX package's
    sequential autodiff of the whole batch (shared weights)."""
    from veles_tpu.models.standard import build_workflow as jax_build
    from veles_tpu.units import Spec as JSpec
    from veles_tpu.units.base import Context as JaxContext
    from veles_tpu_torch.runtime.snapshotter import params_to_numpy
    layers = W.pp_layers(moe=False, dropout=False)
    b = W.pp_batch(3, 16, 6)
    jwf = jax_build("pp", layers)
    jwf.build({"@input": JSpec((16, 6), jnp.int32),
               "@labels": JSpec((16,), jnp.int32),
               "@mask": JSpec((16,), jnp.float32)})
    _, ws, _ = W.pp_workflow(layers, 16, 6, 3)     # the worker's weights
    params = jax.tree.map(jnp.asarray, params_to_numpy(ws["params"]))
    jl, jg = jax.value_and_grad(lambda p: jwf.forward(
        p, {}, b, JaxContext(train=True))[0][jwf.evaluator.name])(params)
    res = ranks2[0]["workflow_plain"]
    _close(res["metrics"]["loss"], float(jl), JAX_TOL)
    jflat = tree_leaves(jax.tree.map(np.asarray, jg))
    for a, g in zip(tree_leaves(res["grads"]), jflat):
        np.testing.assert_allclose(a.numpy(), g, rtol=1e-4, atol=1e-5)


def test_stateful_normalizer_folds_into_stage_0(ranks2):
    """tests/test_pipeline_product.py:720: a normalizer with read-only
    dataset statistics folds into stage 0; the fused step equals the
    plain step on the whole batch and leaves the statistics as they
    were."""
    _same_on_all(ranks2, "stateful_normalizer")
    got = ranks2[0]["stateful_normalizer"]
    ref = W.norm_step()
    _close(got["metrics"]["loss"], ref["metrics"]["loss"])
    for a, b in zip(tree_leaves(got["grads"]), tree_leaves(ref["grads"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=2e-6)
    for a, b in zip(tree_leaves(got["state"]), tree_leaves(ref["state"])):
        assert torch.equal(a, b)
    assert set(got["state"]["norm"]) == {"mean", "rdisp"}


def test_data_by_pipe_ranks(ranks4):
    """data=2 x pipe=2: ranks sit where the JAX mesh puts devices (rank
    = data * pipe + p); the uniform step and a whole workflow equal the
    sequential math over the global batch."""
    assert [r["coords"]["data"] for r in ranks4] == [0, 0, 1, 1]
    assert [r["coords"]["pipe"] for r in ranks4] == [0, 1, 0, 1]
    _same_on_all(ranks4, "uniform_dp")
    loss, grads = ranks4[0]["uniform_dp"]
    p, x, y = W.uniform_data(5, 2, 4, 4, 8)
    sl, _, sg = _seq_uniform(W.tree_t(p), x, y)
    _close(float(loss), sl)
    _close(grads["w"], torch.stack([sg[1], sg[3]]))
    _same_on_all(ranks4, "workflow_dp")
    res = ranks4[0]["workflow_dp"]
    sl, sa, sg, _ = _seq_workflow(W.pp_layers(), 16, 6, 2, n_data=2)
    _close(res["metrics"]["loss"], sl)
    _close(res["metrics"]["aux"], sa)
    for a, b in zip(tree_leaves(res["grads"]), sg):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=2e-6)


def test_data_axis_not_dividing_the_microbatch(ranks4):
    """Microbatches of 3 rows on data=2: each data rank computes them
    whole (the reference replicates such a batch), and the step still
    equals the sequential math."""
    _same_on_all(ranks4, "workflow_dp_replicated")
    res = ranks4[0]["workflow_dp_replicated"]
    sl, sa, sg, _ = _seq_workflow(W.pp_layers(), 6, 6, 2)
    _close(res["metrics"]["loss"], sl)
    _close(res["metrics"]["aux"], sa)
    for a, b in zip(tree_leaves(res["grads"]), sg):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=2e-6)


@pytest.mark.parametrize("M", [4, 8])
def test_deep_pipe_sweep(ranks4, M):
    """S=4 (pipe=4 over the same four ranks) at M = S and 2S."""
    key = f"deep_M{M}"
    _same_on_all(ranks4, key)
    loss, grads = ranks4[0][key]
    p, x, y = W.uniform_data(10 + M, 4, M, 2, 8)
    sl, _, sg = _seq_uniform(W.tree_t(p), x, y)
    _close(float(loss), sl)
    _close(grads["w"], torch.stack([sg[2 * i + 1] for i in range(4)]))
    jl, jg = _jax_uniform(p, x, y)
    _close(grads["w"], jg["w"], JAX_TOL)


@pytest.mark.parametrize("bad", [
    (dict(pipe=3), 1, "3 stages|stages but"),
    (dict(pipe=2), 3, "microbatches"),
    (dict(pipe=2, interleave=3), 4, "interleave")],
    ids=["stage_count", "microbatches", "interleave"])
def test_bad_plans_are_refused(bad):
    """A stack whose stage count does not fit the pipe axis (times the
    interleave), or microbatches that do not divide, is refused when the
    step is built."""
    from veles_tpu_torch.parallel.pipeline_compile import PipelinePlan
    axes, n_mb, match = bad
    axes = dict(axes)
    v = axes.pop("interleave", 1)
    sizes = {"data": 1, "fsdp": 1, "model": 1, "seq": 1, "pipe": 1,
             "expert": 1, **axes}
    wf, _, _ = W.pp_workflow(W.pp_layers(2, moe=False, dropout=False),
                             12, 6)
    with pytest.raises(WorkflowError, match=match):
        PipelinePlan(wf, Mesh(sizes), n_mb, interleave=v)
