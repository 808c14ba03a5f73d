"""The port's ring attention and expert exchange (parallel/ring_attention.py,
parallel/moe.py ``moe_apply_manual``) against the JAX package's, on the
same seeded numpy inputs.

The JAX side runs on conftest's 8 virtual CPU devices (``ring_attention``
on a ``seq`` axis of 2, 4 and 8, ``moe_apply_manual`` under
``shard_map``).  The port's side runs two ways: its group form over
spawned gloo ranks (tests/_torch_dist_worker.py ``suite_ring4``: seq=4
and data=2 x seq=2, expert=4 and data=2 x expert=2; one spawn for the
module, each group made with its own 60 s timeout), and its in-process
rank loop at seq 2, 4 and 8.  Forward and gradients within rtol 2e-4 /
atol 2e-5 of the JAX ring and of the JAX ``full_attention``
(tests/test_parallel_units.py:77, tests/test_parallel.py:132-204), for
full, causal and windowed grouped-query attention."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_worker as W  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from veles_tpu.parallel import MeshSpec, make_mesh  # noqa: E402
from veles_tpu.parallel.mesh import shard_map  # noqa: E402

# the packages' ``parallel`` namespaces export functions of these names
jmoe = importlib.import_module("veles_tpu.parallel.moe")
jring = importlib.import_module("veles_tpu.parallel.ring_attention")
tmoe = importlib.import_module("veles_tpu_torch.parallel.moe")
tring = importlib.import_module("veles_tpu_torch.parallel.ring_attention")

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return W.spawn("ring4", 4, tmp_path_factory.mktemp("ring4"))


def _close(a, b, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), err_msg=what,
                               **TOL)


def _repeat(a, H):
    return jnp.repeat(a, H // a.shape[2], axis=2)


@functools.lru_cache(maxsize=None)
def _jax_ring(i, n):
    """The JAX ring's output and (q, k, v) gradients of sum(o * w) on
    case ``i`` over a seq axis of ``n``."""
    name, causal, window, H, Hk = W.RING_CASES[i]
    q, k, v, w = (jnp.asarray(a) for a in W.ring_inputs(i, H, Hk))
    mesh = make_mesh(MeshSpec(data=8 // n, seq=n))

    def loss(q, k, v):
        o = jring.ring_attention(q, k, v, mesh, causal=causal,
                                 window=window)
        return jnp.sum(o * w), o

    (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True))(q, k, v)
    return np.asarray(o), [np.asarray(a) for a in g]


@functools.lru_cache(maxsize=None)
def _jax_full(i):
    """JAX ``full_attention`` (k/v heads repeated for GQA) on case ``i``;
    None for the windowed case, which it does not mask."""
    name, causal, window, H, Hk = W.RING_CASES[i]
    if window is not None:
        return None
    q, k, v, w = (jnp.asarray(a) for a in W.ring_inputs(i, H, Hk))

    def loss(q, k, v):
        o = jring.full_attention(q, _repeat(k, H), _repeat(v, H),
                                 causal=causal)
        return jnp.sum(o * w), o

    (_, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                   has_aux=True)(q, k, v)
    return np.asarray(o), [np.asarray(a) for a in g]


def _check(o, grads, i, n):
    name = W.RING_CASES[i][0]
    jo, jg = _jax_ring(i, n)
    _close(o, jo, f"{name} seq={n} output")
    for a, b, s in zip(grads, jg, "qkv"):
        _close(a, b, f"{name} seq={n} d{s}")
    full = _jax_full(i)
    if full is not None:
        _close(o, full[0], f"{name} seq={n} vs full_attention")
        for a, b, s in zip(grads, full[1], "qkv"):
            _close(a, b, f"{name} seq={n} d{s} vs full_attention")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("i", range(len(W.RING_CASES)),
                         ids=[c[0] for c in W.RING_CASES])
def test_group_ring_matches_jax(ranks4, i, n):
    """The group form (``ring_attention`` over the seq group: each rank
    slices its chunk, runs the P2P ring, all-gathers the output): every
    rank returns the whole output and gradients, equal to JAX's."""
    key = f"ring_{W.RING_CASES[i][0]}_seq{n}"
    for r in ranks4[1:]:
        assert torch.equal(r[key]["o"], ranks4[0][key]["o"])
        for a, b in zip(r[key]["grads"], ranks4[0][key]["grads"]):
            assert torch.equal(a, b)
    res = ranks4[0][key]
    _check(res["o"].numpy(), [g.numpy() for g in res["grads"]], i, n)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("i", range(len(W.RING_CASES)),
                         ids=[c[0] for c in W.RING_CASES])
def test_in_process_ring_matches_jax(i, n):
    """The in-process rank loop (every rank's chunk in one list, the
    lists rotated), differentiated by plain autograd."""
    name, causal, window, H, Hk = W.RING_CASES[i]
    q, k, v, w = (W.t(a).requires_grad_(True)
                  for a in W.ring_inputs(i, H, Hk))
    outs = tring.ring_attention_ranks(q.chunk(n, 1), k.chunk(n, 1),
                                      v.chunk(n, 1), causal=causal,
                                      window=window)
    o = torch.cat(outs, 1)
    g = torch.autograd.grad((o * w).sum(), (q, k, v))
    _check(o.detach().numpy(), [a.numpy() for a in g], i, n)


def test_port_full_attention_matches_jax():
    """The port's plain ``full_attention`` (the card's reference) equals
    JAX's, causal and not."""
    q, k, v, _ = W.ring_inputs(0, 4, 4)
    for causal in (False, True):
        got = tring.full_attention(W.t(q), W.t(k), W.t(v), causal=causal)
        want = jring.full_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
        _close(got.numpy(), np.asarray(want))


def test_ring_refusals():
    """A window needs causal, GQA heads must divide, the sequence must
    divide over the axis, and the ring needs the axis's group."""
    from veles_tpu_torch.parallel.mesh import AXES, Mesh
    q, k, v, _ = (W.t(a) for a in W.ring_inputs(0, 4, 4))
    with pytest.raises(ValueError, match="causal"):
        tring.ring_attention_ranks([q], [k], [v], window=4)
    with pytest.raises(ValueError, match="multiple"):
        tring.ring_attention_ranks([q], [k[:, :, :3]], [v[:, :, :3]])
    mesh = Mesh({**{a: 1 for a in AXES}, "seq": 2})
    with pytest.raises(RuntimeError, match="process group"):
        tring.ring_attention(q, k, v, mesh)


def _jax_moe_manual(p, x, n_groups, n, top_k, cf):
    """JAX ``moe_apply_manual`` under ``shard_map`` on n_groups x n
    devices (data x expert, the tokens split over both, as the port's
    ranks hold them): the concatenated y and each device's aux."""
    mesh = make_mesh(MeshSpec(data=n_groups, expert=n),
                     devices=jax.devices()[:n_groups * n])
    body = functools.partial(jmoe.moe_apply_manual, axis_name="expert",
                             top_k=top_k, capacity_factor=cf)
    spec = P(("data", "expert"))
    fn = jax.jit(shard_map(lambda p, x: (lambda y, a: (y, a.reshape(1)))(
                       *body(p, x)),
                   mesh=mesh, in_specs=(P(), spec), out_specs=(spec, spec),
                   check_vma=False))
    y, aux = fn(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    return np.asarray(y), np.asarray(aux)


@pytest.mark.parametrize("top_k,cf", W.MOE_CASES,
                         ids=[f"top{k}" for k, _ in W.MOE_CASES])
@pytest.mark.parametrize("spec,n_groups", [("expert=4", 1),
                                           ("data=2,expert=2", 2)])
def test_group_moe_manual_matches_jax(ranks4, spec, n_groups, top_k, cf):
    """moe_apply_manual over the expert group (8 tokens a rank): each
    rank's y and its group's aux equal JAX's ``moe_apply_manual`` under
    ``shard_map``; the gradients summed over the ranks equal the JAX
    gradient of the same objective through the local ``moe_apply`` on
    each group's tokens (nothing dropped at this capacity)."""
    p, x, wy = W.moe_inputs(top_k)
    n = 4 // n_groups
    key = f"moe_{spec}_k{top_k}"
    y = np.concatenate([r[key]["y"].numpy() for r in ranks4])
    jy, jaux = _jax_moe_manual(p, x, n_groups, n, top_k, cf)
    _close(y, jy, "y vs moe_apply_manual")
    groups = np.split(np.arange(32), n_groups)
    local = jax.jit(functools.partial(jmoe.moe_apply, top_k=top_k,
                                      capacity_factor=cf))
    for r, res in enumerate(ranks4):
        g = r // n
        want = local(jax.tree.map(jnp.asarray, p),
                     jnp.asarray(x[groups[g]]))[1]
        _close(res[key]["aux"], float(want), f"aux of rank {r}")
        _close(res[key]["aux"], jaux[r], "aux vs moe_apply_manual")

    def obj(params):
        tot = 0.0
        for rows in groups:
            yy, aux = jmoe.moe_apply(params, jnp.asarray(x[rows]),
                                     top_k=top_k, capacity_factor=cf)
            tot = tot + jnp.sum(yy * wy[rows]) + W.MOE_AUX_W * aux * n
        return tot

    jg = jax.jit(jax.grad(obj))(jax.tree.map(jnp.asarray, p))
    for k in p:
        for res in ranks4:
            _close(res[key]["grads"][k].reshape(p[k].shape),
                   np.asarray(jg[k]), f"d{k}")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("top_k", [1, 2])
def test_in_process_moe_manual_matches_jax(n, top_k):
    """The in-process rank loop of moe_apply_manual: y equals JAX's
    ``moe_apply_manual`` under shard_map (one expert group of n ranks,
    tokens split over it), aux equals ``moe_apply``'s on all tokens, and
    the gradients equal the JAX gradient through ``moe_apply``."""
    p, x, wy = W.moe_inputs(top_k)
    pt = {k: W.t(a).requires_grad_(True) for k, a in p.items()}
    ys, aux = tmoe.moe_apply_manual_ranks(pt, list(W.t(x).chunk(n)),
                                          top_k=top_k, capacity_factor=8.0)
    y = torch.cat(ys)
    g = torch.autograd.grad((y * W.t(wy)).sum() + W.MOE_AUX_W * aux,
                            list(pt.values()))
    jy, jaux = _jax_moe_manual(p, x, 1, n, top_k, 8.0)
    _close(y.detach().numpy(), jy)
    _close(float(aux.detach()), float(jaux[0]))

    def obj(params):
        yy, a = jmoe.moe_apply(params, jnp.asarray(x), top_k=top_k,
                               capacity_factor=8.0)
        return jnp.sum(yy * wy) + W.MOE_AUX_W * a

    jg = jax.jit(jax.grad(obj))(jax.tree.map(jnp.asarray, p))
    for a, k in zip(g, p):
        _close(a.numpy(), np.asarray(jg[k]), f"d{k}")


def test_expert_placement_equals_jax():
    """``expert_rules`` and ``moe_shardings`` give the JAX package's
    partitions (as tuples), and ``state_shardings`` walks a state tree
    with the rule."""
    from veles_tpu.units.parallel_nn import expert_rules as jax_rules
    from veles_tpu_torch.parallel.mesh import AXES, state_shardings
    from veles_tpu_torch.units.parallel_nn import expert_rules
    rule, jrule = expert_rules(), jax_rules()
    shapes = {"moe": {"router": (16, 4), "w1": (4, 16, 24),
                      "w2": (4, 24, 16)}, "out": {"w": (16, 4)}}
    for u, sub in shapes.items():
        for k, s in sub.items():
            want = jrule(("params", u, k),
                         jax.ShapeDtypeStruct(s, jnp.float32))
            assert P(*rule((u, k), s)) == want, (u, k)
    assert tmoe.moe_shardings({}) == {"router": (), "w1": ("expert",),
                                      "w2": ("expert",)}
    params = {u: {k: torch.zeros(s) for k, s in sub.items()}
              for u, sub in shapes.items()}
    sizes = {a: 1 for a in AXES}
    sizes["expert"] = 4
    assert state_shardings(params, sizes, rule) == {
        "moe": tmoe.moe_shardings({}), "out": {"w": ()}}
