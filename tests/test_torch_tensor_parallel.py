"""The ``model`` axis and the placement rules in the port, on the CPU as
8 spawned gloo ranks (tests/_torch_dist_worker.py ``suite_tp8``, one
spawn for the module, each group made with its own 60 s timeout).

* The rules (parallel/mesh.py) equal the JAX package's:
  tests/test_parallel.py:103 (the table), :147 (fsdp's divisibility),
  :37 (a mesh of model = 2), and ``state_shardings``' guard over a
  state tree.
* The sharded train and eval steps over data=4 x fsdp=2, data=4 x
  model=2 and data=2 x fsdp=2 x model=2, on the dryrun stack (fc6 by
  columns, fc7 by rows, fsdp_rules(min_size=256)), an attention + FFN
  LM whose heads and hidden columns split whole, and one whose single kv
  head does not split (its attention gathered on use): two SGD steps
  with momentum on a ragged batch equal the port's one-process step and
  the JAX package's sharded step on the same weights and batch (loss
  rtol 2e-5, parameters and momentum rtol 2e-4 / atol 2e-5); a rank
  stores its block of each leaf the rule splits, momentum alike.
* The rank loops the card runs (parallel/tensor_parallel.py
  ``model_ranks``, parallel/fsdp.py ``zero_step_ranks``) equal the
  unsplit block and the one-device step on the CPU (f32: forward 2e-5
  relative, gradients 2e-4 / 2e-5), down to one head a rank and a GQA
  group a rank.
* ``python -m veles_tpu_torch.parallel.dryrun 8`` trains one step over
  data=2 x fsdp=2 x model=2 gloo ranks (__graft_entry__.py:51-104)."""

import os
import re
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
    return W.spawn("tp8", 8, tmp_path_factory.mktemp("tp8"), timeout=300)


def _P(part):
    from jax.sharding import PartitionSpec as P
    return P(*part)


def _jax_rule(table, min_size):
    from veles_tpu.parallel import (compose_rules, fsdp_rules,
                                    tensor_parallel_rules)
    return compose_rules(
        tensor_parallel_rules({k: _P(v) for k, v in table.items()}),
        fsdp_rules(min_size=min_size))


def _jax_sharded(spec, layers, batch, table, min_size, params0, steps):
    """The JAX package's sharded train step on the 8 CPU devices, from
    the port's initial weights: every step's loss and the params and
    momentum after."""
    import veles_tpu as vt
    from veles_tpu.models.standard import build_workflow
    from veles_tpu.parallel import MeshSpec, make_mesh
    from veles_tpu.units import Spec
    from veles_tpu_torch.parallel.mesh import MeshSpec as PortSpec
    from veles_tpu_torch.runtime.snapshotter import params_to_numpy
    sizes = PortSpec.parse(spec).axis_sizes(8)
    mesh = make_mesh(MeshSpec(**sizes))
    jwf = build_workflow("axes", layers)
    specs = {k: Spec(v.shape, jnp.asarray(v).dtype)
             for k, v in batch.items()}
    jwf.build(specs)
    opt = vt.optimizers.SGD(W.TP_LR, momentum=W.TP_MOMENTUM)
    ws = jwf.init_state(jax.random.key(0), opt)
    ws["params"] = jax.tree.map(jnp.asarray, params_to_numpy(params0))
    step, state_sh, _ = jwf.make_sharded_train_step(
        opt, mesh, ws, specs, rule=_jax_rule(table, min_size),
        donate=False)
    ws = jax.device_put(ws, state_sh)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(steps):
        ws, m = step(ws, jb)
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, ws["params"]), \
        jax.tree.map(np.asarray, {k: v for k, v in ws["opt_state"].items()
                                  if k in ws["params"]})


def _port_plain(layers, batch, steps):
    """The port's one-process step on the whole batch."""
    wf, ws, opt = W.axes_workflow(layers, batch, W.TP_LR,
                                  momentum=W.TP_MOMENTUM)
    step = wf.make_train_step(opt)
    losses = []
    for _ in range(steps):
        ws, m = step(ws, W.tree_t(batch))
        losses.append(float(m["loss"]))
    ev = wf.make_eval_step()(ws, W.tree_t(batch))
    return losses, ws, {k: float(v) for k, v in ev.items()}


def _close(got, ref, what):
    ga, ra = tree_leaves(got), tree_leaves(ref)
    assert len(ga) == len(ra), what
    for a, b in zip(ga, ra):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=what, **PARAM_TOL)


def _same_on_all(ranks, key):
    for r in ranks[1:]:
        for a, b in zip(tree_leaves(r[key]["state"]),
                        tree_leaves(ranks[0][key]["state"])):
            assert torch.equal(a, b), key
        assert r[key]["metrics"] == ranks[0][key]["metrics"], key


@pytest.mark.parametrize("case", W.TP_CASES)
@pytest.mark.parametrize("spec", W.TP_MESHES)
def test_sharded_step_matches_one_process_and_jax(ranks8, spec, case):
    """Two sharded steps equal the port's one-process step and JAX's
    sharded step on the same weights; the eval step equals the plain
    eval; every rank ends with the same gathered state."""
    key = f"{spec}/{case}"
    _same_on_all(ranks8, key)
    got = ranks8[0][key]
    layers, batch, table, min_size = W.tp_case(case)
    losses, ws, ev = _port_plain(layers, batch, W.TP_STEPS)
    _, ws0, _ = W.axes_workflow(layers, batch, W.TP_LR)
    jlosses, jparams, jmom = _jax_sharded(spec, layers, batch, table,
                                          min_size, ws0["params"],
                                          W.TP_STEPS)
    for i, m in enumerate(got["metrics"]):
        np.testing.assert_allclose(m["loss"], losses[i], **LOSS_TOL)
        np.testing.assert_allclose(m["loss"], jlosses[i], **LOSS_TOL)
    _close(got["state"]["params"], ws["params"], "params vs port")
    _close(got["state"]["params"], jparams, "params vs JAX")
    mom = {k: v for k, v in got["state"]["opt_state"].items()
           if not k.startswith("__")}
    _close(mom, {k: v for k, v in ws["opt_state"].items()
                 if not k.startswith("__")}, "momentum vs port")
    _close(mom, jmom, "momentum vs JAX")
    for k, v in ev.items():
        np.testing.assert_allclose(got["eval"][k], v, rtol=1e-5, err_msg=k)


def test_ranks_store_blocks_and_split_units(ranks8):
    """Under data=2 x fsdp=2 x model=2 a rank stores half of each leaf
    the rule splits, momentum alike; attention and the FFN compute over
    the model group where the split falls on whole heads, the one-kv-head
    attention is gathered on use; ranks sit where the JAX mesh puts
    devices."""
    assert [r["coords"]["model"] for r in ranks8] == [0, 1] * 4
    assert [r["coords"]["fsdp"] for r in ranks8] == [0, 0, 1, 1] * 2
    assert [r["coords"]["data"] for r in ranks8] == [0] * 4 + [1] * 4
    spec = "data=2,fsdp=2,model=2"
    rec = ranks8[0][f"{spec}/lm_whole"]
    st = rec["stored"]
    # attention by heads and the FFN by hidden columns over model; the
    # embedding (12 x 16) and the head (16 x 12) over fsdp
    for unit, name, shape in (("attn", "wq", (16, 8)), ("attn", "wo", (8, 16)),
                              ("ffn", "w1", (16, 16)), ("ffn", "w2", (16, 16)),
                              ("emb", "table", (12, 8)), ("out", "w", (8, 12)),
                              ("ffn", "b1", (32,)), ("ln", "scale", (16,))):
        assert st["params"][unit][name] == shape, (unit, name)
        assert st["opt_state"][unit][name] == shape, (unit, name)
    assert set(rec["tp"]) == {"attn", "ffn"}
    assert rec["tp"]["attn"] == {"wq": (None, "model"), "wk": (None, "model"),
                                 "wv": (None, "model"), "wo": ("model",)}
    gqa = ranks8[0][f"{spec}/lm_gqa_gathered"]
    assert set(gqa["tp"]) == {"ffn"}
    # stored split all the same: gathered on use
    assert gqa["stored"]["params"]["attn"]["wq"] == (16, 8)
    dry = ranks8[0][f"{spec}/dryrun"]
    assert dry["tp"] == {"fc6": {"w": (None, "model")},
                         "fc7": {"w": ("model",)}}
    assert dry["stored"]["params"]["fc6"]["w"] == (1024, 32)
    assert dry["stored"]["params"]["conv1"]["w"] == (3, 3, 3, 8)


def test_tensor_parallel_rules_table():
    """tests/test_parallel.py:103, the port's rule against JAX's."""
    from veles_tpu.parallel import tensor_parallel_rules as jtp
    from veles_tpu_torch.parallel.mesh import tensor_parallel_rules
    table = {"fc1/w": (None, "model"), "out/w": ("model", None)}
    rule = tensor_parallel_rules(table)
    jrule = jtp({k: _P(v) for k, v in table.items()})
    spec = jax.ShapeDtypeStruct((16, 32), jnp.float32)
    for path in (("params", "fc1", "w"), ("params", "other", "w"),
                 ("params", "out", "w"), ("fc1", "w")):
        assert _P(rule(path, (16, 32))) == jrule(path, spec), path
    assert rule(("params", "fc1", "w"), (16, 32)) == (None, "model")
    assert rule(("params", "other", "w"), (16, 32)) == ()


def test_fsdp_axis_size_divisibility():
    """tests/test_parallel.py:147: a dim the axis does not tile is
    skipped, and no tiling dim leaves the leaf replicated."""
    from veles_tpu.parallel import fsdp_rules as jfsdp
    from veles_tpu_torch.parallel.mesh import fsdp_rules
    rule = fsdp_rules(min_size=16, axis_size=4)
    jrule = jfsdp(min_size=16, axis_size=4)
    assert rule((), (50, 48)) == (None, "fsdp")
    assert rule((), (50, 49)) == ()
    for shape in ((50, 48), (50, 49), (48, 48), (3, 5), (64,), (4, 8, 12)):
        spec = jax.ShapeDtypeStruct(shape, jnp.float32)
        assert _P(rule((), shape)) == jrule((), spec), shape
        assert _P(fsdp_rules(min_size=16)((), shape)) == \
            jfsdp(min_size=16)((), spec), shape


def test_state_shardings_guard_equals_jax():
    """``state_shardings`` over a workflow state (params, momentum,
    scalars) with the divisibility guard gives JAX's partitions, on a
    mesh of model = 2 (tests/test_parallel.py:37)."""
    from veles_tpu.parallel import MeshSpec, make_mesh
    from veles_tpu.parallel.mesh import state_shardings as jss
    from veles_tpu_torch.parallel.mesh import MeshSpec as PortSpec
    from veles_tpu_torch.parallel.mesh import state_shardings
    jm = make_mesh(MeshSpec(data=-1, model=2))
    assert jm.shape["data"] == 4 and jm.shape["model"] == 2
    sizes = PortSpec(data=-1, model=2).axis_sizes(8)
    assert sizes == dict(jm.shape)
    with pytest.raises(ValueError, match="does not tile"):
        PortSpec(data=3, model=2).axis_sizes(8)
    tree = {"params": {"a": {"w": np.zeros((16, 6)), "b": np.zeros(6)},
                       "c": {"w": np.zeros((5, 32))}},
            "opt_state": {"a": {"w": np.zeros((16, 6))}},
            "step": np.zeros(())}
    table = {"a/w": (None, "model"), "c/w": ("model", None),
             "a/b": ("model",)}
    port = W.tp_rule(table, 64)
    got = state_shardings(tree, sizes, port)
    want = jss(tree, jm, _jax_rule(table, 64))
    flat = [(p, s) for p, s in jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: hasattr(x, "spec"))]
    for path, sh in flat:
        node = got
        for k in path:
            node = node[k.key]
        assert _P(node) == sh.spec, (path, node, sh.spec)
    # a (5, 32) weight's row split does not tile: replicated
    assert got["params"]["c"]["w"] == ()


def _block(heads, kv_heads, E=32, hidden=64, dtype=torch.float32, seed=0):
    from veles_tpu_torch.units.base import Spec
    from veles_tpu_torch.units.nn import FFN
    from veles_tpu_torch.units.parallel_nn import MultiHeadAttention
    gen = torch.Generator().manual_seed(seed)
    attn = MultiHeadAttention(heads, n_kv_heads=kv_heads, rope=True,
                              residual=True, name="attn")
    ffn = FFN(hidden, name="ffn")
    spec = [Spec((2, 8, E), dtype)]
    return attn, attn.init(gen, spec, "cpu")[0], ffn, \
        ffn.init(gen, spec, "cpu")[0]


ATTN_SPLIT = {"wq": (None, "model"), "wk": (None, "model"),
              "wv": (None, "model"), "wo": ("model",)}
FFN_SPLIT = {"w1": (None, "model"), "w2": ("model",), "b1": ("model",)}


@pytest.mark.parametrize("heads,kv,n", [(4, 4, 2), (4, 4, 4), (4, 2, 2),
                                        (8, 4, 4)],
                         ids=["h4_m2", "one_head_a_rank",
                              "gqa_group_a_rank", "h8_kv4_m4"])
def test_rank_loop_block_matches_unsplit(heads, kv, n):
    """``model_ranks``: every model rank's attention on its H/model
    heads and FFN on its hidden columns, summed, equals the unsplit
    block forward and backward; each rank's weight gradients are its
    blocks of the unsplit ones."""
    from veles_tpu_torch.parallel.fsdp import slice_block
    from veles_tpu_torch.parallel.tensor_parallel import (RankLoop,
                                                          model_ranks,
                                                          split_weights)
    from veles_tpu_torch.units.base import Context
    attn, pa, ffn, pf = _block(heads, kv)
    assert attn.tp_local(ATTN_SPLIT, n) == set(ATTN_SPLIT)
    assert ffn.tp_local(FFN_SPLIT, n) == set(FFN_SPLIT)
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(3))
    w = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(4))

    def leaves(p):
        return {k: v.detach().clone().requires_grad_(True)
                for k, v in p.items()}
    ref_pa, ref_pf = leaves(pa), leaves(pf)
    xr = x.clone().requires_grad_(True)
    y, _ = attn.apply(ref_pa, {}, [xr], Context())
    y, _ = ffn.apply(ref_pf, {}, [y], Context())
    ref = torch.autograd.grad((y * w).sum(), [xr, *ref_pa.values(),
                                              *ref_pf.values()])
    ranks_a = [leaves(p) for p in split_weights(pa, ATTN_SPLIT, n)]
    ranks_f = [leaves(p) for p in split_weights(pf, FFN_SPLIT, n)]
    xs = x.clone().requires_grad_(True)
    h = model_ranks(attn, ranks_a, xs, ATTN_SPLIT)
    out = model_ranks(ffn, ranks_f, h, FFN_SPLIT)
    np.testing.assert_allclose(out.detach().numpy(), y.detach().numpy(),
                               rtol=2e-5, atol=2e-5)
    wrt = [xs] + [t for r in range(n)
                  for t in (*ranks_a[r].values(), *ranks_f[r].values())]
    # a whole term is added on rank 0 only: the others' copies unused
    got = [torch.zeros_like(t) if g is None else g for g, t in zip(
        torch.autograd.grad((out * w).sum(), wrt, allow_unused=True), wrt)]
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), **PARAM_TOL)
    it = iter(got[1:])
    names = [("a", k) for k in pa] + [("f", k) for k in pf]
    per_rank = [{nm: next(it) for nm in names} for _ in range(n)]
    refs = dict(zip(names, ref[1:]))
    for (tag, k), want in refs.items():
        split = ATTN_SPLIT if tag == "a" else FFN_SPLIT
        if k in split:
            for r in range(n):
                np.testing.assert_allclose(
                    per_rank[r][(tag, k)].numpy(),
                    slice_block(want, split[k], RankLoop(r, n)).numpy(),
                    err_msg=f"{tag}/{k} rank {r}", **PARAM_TOL)
        else:
            # a whole leaf (the FFN's output bias): the ranks' gradients
            # sum to the unsplit one
            tot = sum(per_rank[r][(tag, k)] for r in range(n))
            np.testing.assert_allclose(tot.numpy(), want.numpy(),
                                       err_msg=f"{tag}/{k}", **PARAM_TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_zero_step_ranks_matches_one_device(n):
    """``zero_step_ranks``: n fsdp ranks' Adam step in one process (rows
    split, gradients reduce-scattered, each block updated on its own)
    equals the one-device step: parameters and both moments."""
    from veles_tpu_torch.models.standard import build_workflow
    from veles_tpu_torch.ops.optimizers import Adam
    from veles_tpu_torch.parallel.fsdp import zero_step_ranks
    from veles_tpu_torch.parallel.mesh import fsdp_rules
    from veles_tpu_torch.units.base import Spec
    batch = W.lm_batch(6, 8, 8, ragged=2)
    specs = {k: Spec(v.shape, torch.from_numpy(v).dtype)
             for k, v in batch.items()}

    def make():
        wf = build_workflow("zero", W.tp_lm_layers())
        wf.build(specs)
        opt = Adam(1e-2)
        return wf, wf.init_state(0, opt, "cpu"), opt
    wf, ws, opt = make()
    got = zero_step_ranks(wf, opt, ws, W.tree_t(batch), n,
                          fsdp_rules(min_size=64))
    wf2, ws2, opt2 = make()
    ws2, mets = wf2.make_train_step(opt2)(ws2, W.tree_t(batch))
    np.testing.assert_allclose(float(got["loss"]), float(mets["loss"]),
                               **LOSS_TOL)
    _close(got["params"], ws2["params"], "params")
    _close({k: v for k, v in got["opt_state"].items()
            if not k.startswith("__")},
           {k: v for k, v in ws2["opt_state"].items()
            if not k.startswith("__")}, "moments")


def test_zero_step_ranks_refuses_the_optimizers_clip():
    """The rank loop takes the global norm only: an optimizer's own or
    per-unit ``clip_norm`` (a norm of clipped gradients) is refused."""
    from veles_tpu_torch.models.standard import build_workflow
    from veles_tpu_torch.ops.optimizers import Adam, HyperParams
    from veles_tpu_torch.parallel.fsdp import zero_step_ranks
    from veles_tpu_torch.parallel.mesh import fsdp_rules
    from veles_tpu_torch.units.base import Spec
    batch = W.lm_batch(4, 8, 8)
    wf = build_workflow("zero", W.tp_lm_layers())
    wf.build({k: Spec(v.shape, torch.from_numpy(v).dtype)
              for k, v in batch.items()})
    for opt in (Adam(1e-2, clip_norm=1.0),
                Adam(1e-2, per_unit={"ffn": HyperParams(clip_norm=1.0)})):
        ws = wf.init_state(0, opt, "cpu")
        with pytest.raises(ValueError, match="global norm only"):
            zero_step_ranks(wf, opt, ws, W.tree_t(batch), 2,
                            fsdp_rules(min_size=64))


def test_dryrun_over_gloo_ranks():
    """``python -m veles_tpu_torch.parallel.dryrun 8``: one step of the
    dryrun stack over data=2 x fsdp=2 x model=2; every rank reports the
    same finite loss."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("VELES_PROCESS_ID", None)
    r = subprocess.run([sys.executable, "-m",
                        "veles_tpu_torch.parallel.dryrun", "8"], cwd=REPO,
                       capture_output=True, text=True, timeout=240, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    # the ranks share the launcher's stdout: two lines may run together
    got = re.findall(r"rank (\d+) of data=2 x fsdp=2 x model=2: "
                     r"loss ([0-9.]+)", r.stdout)
    assert sorted(int(rank) for rank, _ in got) == list(range(8)), r.stdout
    losses = {loss for _, loss in got}
    assert len(losses) == 1 and np.isfinite(float(losses.pop()))
