"""The dropout seed read on the device, on the CPU, against the JAX
package: the plain dropout with a seed tensor bitwise the JAX kernel
(``pallas_kernels.fused_dropout`` in interpret mode), the host-int entry
bitwise the tensor entry, the train step's host part staging each dropout
unit's seed (``bits32(fold_in(sub, hash(name)))`` of the JAX key chain)
into the unit's slot, the forward and the backward of a step reading that
step's seed, a write into the slot between them refused, three train
steps against the JAX step with ``use_pallas=True`` (loss rtol 1e-5,
state rtol 1e-4 / atol 1e-6, dropout zero patterns identical), and a CPU
``StepCache`` that names no dropout reason any more."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from veles_tpu.models.standard import StandardWorkflow as JaxStandard  # noqa: E402,E501
from veles_tpu.ops import pallas_kernels as pk  # noqa: E402
from veles_tpu.runtime.snapshotter import _to_numpy as jax_host  # noqa: E402
from veles_tpu.units import Spec as JSpec  # noqa: E402
from veles_tpu.units.base import Context as JaxContext  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.loader.base import TRAIN, VALID, ArrayLoader  # noqa: E402
from veles_tpu_torch.models.standard import StandardWorkflow  # noqa: E402
from veles_tpu_torch.ops.kernels import fused_dropout as fd  # noqa: E402
from veles_tpu_torch.runtime.decision import Decision  # noqa: E402
from veles_tpu_torch.runtime.snapshotter import (  # noqa: E402
    _flatten, wstate_from_jax, wstate_to_numpy)
from veles_tpu_torch.units.base import Context, Spec  # noqa: E402

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
B, D_IN, CLASSES = 8, 12, 5


@pytest.fixture(autouse=True)
def _reset_port_prng():
    prng.streams.reset()
    yield
    prng.streams.reset()


def _config():
    return {"name": "DropFC", "layers": [
        {"type": "all2all_relu", "output_size": 16, "name": "fc1"},
        {"type": "dropout", "dropout_ratio": 0.5, "name": "drop1",
         "use_pallas": True},
        {"type": "all2all_relu", "output_size": 16, "name": "fc2"},
        {"type": "dropout", "dropout_ratio": 0.3, "name": "drop2",
         "use_pallas": True},
        {"type": "softmax", "output_size": CLASSES, "name": "out"}],
        "optimizer": "momentum",
        "optimizer_args": {"lr": 0.05, "momentum": 0.9}}


def _pair(key=7):
    """The JAX workflow initialized from ``key`` and the port's with its
    params, unit state and key carried across."""
    jsw, psw = JaxStandard(_config()), StandardWorkflow(_config())
    jsw.workflow.build({"@input": JSpec((B, D_IN), jnp.float32),
                        "@labels": JSpec((B,), jnp.int32),
                        "@mask": JSpec((B,), jnp.float32)})
    psw.workflow.build({"@input": Spec((B, D_IN), torch.float32),
                        "@labels": Spec((B,), torch.int32),
                        "@mask": Spec((B,), torch.float32)})
    jws = jsw.workflow.init_state(jax.random.key(key), jsw.optimizer)
    pws = wstate_from_jax(jax_host(jws), psw.workflow,
                          optimizer=psw.optimizer, device="cpu")
    return jsw, jws, psw, pws


def _batch(rng):
    return {"@input": rng.standard_normal((B, D_IN)).astype(np.float32),
            "@labels": rng.integers(0, CLASSES, B).astype(np.int32),
            "@mask": np.ones(B, np.float32)}


# -- the kernel's plain version with the seed in a tensor ----------------------

@pytest.mark.parametrize("shape,rate,seed", [
    ((100, 256), 0.5, 0xDEADBEEF), ((50, 128), 0.5, 7),
    ((4, 7, 7, 8), 0.3, 2 ** 31)],
    ids=["drop3_100x256_high_bit", "drop4_50x128", "nhwc"])
def test_plain_with_a_seed_tensor_matches_the_jax_kernel(shape, rate, seed):
    """Forward and gradient bitwise the JAX kernel in interpret mode with
    the seed in a one-element int32 tensor (a seed with its top bit set
    is a negative int32: the bits are what count)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jout, vjp = jax.vjp(lambda a: pk.fused_dropout(
        a, jnp.uint32(seed), rate, 256, True), jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(g))
    slot = fd.seed_tensor(seed, "cpu")
    assert slot.dtype == torch.int32 and slot.shape == (1,)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = fd.fused_dropout(tx, slot, rate)
    (grad,) = torch.autograd.grad(out, tx, torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(grad.numpy(), np.asarray(jgrad))
    np.testing.assert_array_equal(
        fd.fused_dropout_plain(torch.from_numpy(x), slot, rate).numpy(),
        np.asarray(jout))


def test_int_seed_entry_equals_the_tensor_entry():
    x = torch.randn(64, 33, generator=torch.Generator().manual_seed(2))
    for seed in (0, 1, 0x9E3779B9, 2 ** 32 - 1):
        assert torch.equal(fd.fused_dropout(x, seed, 0.4),
                           fd.fused_dropout(x, fd.seed_tensor(seed, "cpu"),
                                            0.4))
    # one slot, two seeds written into it: two masks
    slot = fd.seed_tensor(5, "cpu")
    a = fd.fused_dropout(x, slot, 0.5)
    slot.fill_(fd.seed_bits(6))
    b = fd.fused_dropout(x, slot, 0.5)
    assert torch.equal(a, fd.fused_dropout(x, 5, 0.5))
    assert torch.equal(b, fd.fused_dropout(x, 6, 0.5))
    assert not torch.equal(a == 0, b == 0)


def test_a_slot_written_between_forward_and_backward_is_refused():
    """The backward reads the forward's seed tensor: writing the slot in
    between is an in-place change autograd refuses, so a backward can
    never regenerate another step's mask."""
    slot = fd.seed_tensor(3, "cpu")
    x = torch.randn(16, 16).requires_grad_(True)
    y = fd.fused_dropout(x, slot, 0.5)
    slot.fill_(fd.seed_bits(4))
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        y.sum().backward()


# -- the train step's seed slots ---------------------------------------------

def _jax_seeds(jkey, names):
    """What the JAX step's dropouts draw: ``sub`` of ``split(key)``, each
    unit's ``bits32(fold_in(sub, hash(name)))``."""
    sub = jax.random.split(jkey)[1]
    ctx = JaxContext(train=True, key=sub)
    return [int(jax.random.bits(ctx.unit_key(n), dtype=jnp.uint32))
            for n in names]


def test_train_step_stages_each_dropout_seed():
    jsw, jws, psw, pws = _pair()
    step = psw.workflow.make_train_step(psw.optimizer)
    assert step.seeded == ["drop1", "drop2"]
    step.begin(pws)
    got = [int(np.asarray(step.seeds[n]).view(np.uint32)[0])
           for n in step.seeded]
    assert got == _jax_seeds(jws["key"], step.seeded)
    # the lr and the NaN flag share the staging tensor as float32 bits
    assert float(step.scalars[0]) == np.float32(psw.optimizer.schedule(0))
    assert float(step.scalars[1]) == 0.0
    assert step.scalars.data_ptr() == step.staging.data_ptr()


def test_forward_and_backward_read_their_steps_seed(monkeypatch):
    """Over two eager steps every dropout call reads its unit's slot;
    the forward and the backward of one step see the seed the step's
    host part staged, and the next step's host part writes a new one
    only after the backward ran."""
    jsw, jws, psw, pws = _pair()
    step = psw.workflow.make_train_step(psw.optimizer)
    seen = []
    inner = fd._apply

    def spy(x, seed, rate):
        seen.append((seed.data_ptr(), int(seed.view(torch.int32)[0])))
        return inner(x, seed, rate)

    monkeypatch.setattr(fd, "_apply", spy)
    rng = np.random.default_rng(0)
    want, key = [], jws["key"]
    for _ in range(2):
        want.append(_jax_seeds(key, ["drop1", "drop2"]))
        key = jax.random.split(key)[0]
        b = {k: torch.from_numpy(v) for k, v in _batch(rng).items()}
        pws, _ = step(pws, b)
    slots = {step.seeds[n].data_ptr(): i for i, n in
             enumerate(step.seeded)}
    assert len(seen) == 8            # 2 steps x 2 units x (fwd, bwd)
    for s in range(2):
        calls = seen[4 * s:4 * s + 4]
        assert {p for p, _ in calls} == set(slots)   # the slots, no copy
        for ptr, bits in calls:
            assert np.uint32(np.int32(bits)) == want[s][slots[ptr]]
    assert want[0] != want[1]


def test_three_train_steps_match_jax():
    """Same weights and key; three momentum steps of the port's step
    (seeds through the slots) against the JAX step with the Pallas
    dropout: the dropout zero patterns of each step's forward identical,
    loss rtol 1e-5, the keys equal, the state rtol 1e-4 / atol 1e-6."""
    jsw, jws, psw, pws = _pair()
    jwf, pwf = jsw.workflow, psw.workflow
    jstep = jwf.make_train_step(jsw.optimizer, donate=False)
    pstep = pwf.make_train_step(psw.optimizer)
    rng = np.random.default_rng(3)
    for i in range(3):
        b = _batch(rng)
        pb = {k: torch.from_numpy(v) for k, v in b.items()}
        jsub = jax.random.split(jws["key"])[1]
        jout, _ = jwf.forward(jws["params"], jws["state"], b,
                              JaxContext(train=True, key=jsub))
        sub = pstep.begin(dict(pws))        # stage this step's seeds
        pout, _ = pwf.forward(pws["params"], pws["state"], pb,
                              Context(train=True, key=sub,
                                      seeds=pstep.seeds))
        for name in ("drop1", "drop2"):
            np.testing.assert_array_equal(
                pout[name].numpy() == 0, np.asarray(jout[name]) == 0,
                err_msg=name)
        jws, jm = jstep(jws, b)
        pws, pm = pstep(pws, pb)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        assert tuple(int(v) for v in pws["key"]) == tuple(
            int(v) for v in jax.random.key_data(jws["key"])), i
    jh = jax_host(jws)
    for part in ("params", "opt_state"):
        pf = _flatten(wstate_to_numpy(pws)[part])
        jf = _flatten(jh[part])
        for key in jf:
            np.testing.assert_allclose(pf[key], jf[key], err_msg=key,
                                       **STATE_TOL)


def test_a_state_without_a_key_cannot_train_a_dropout():
    jsw, jws, psw, pws = _pair()
    pws["key"] = None
    step = psw.workflow.make_train_step(psw.optimizer)
    with pytest.raises(ValueError, match="drop1.*no key"):
        step.begin(pws)


def test_cpu_step_cache_reports_no_dropout_seed():
    """A trainer of a dropout workflow on the CPU: its steps are eager
    for the one reason left, the CPU; nothing names the dropout seed."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((24, D_IN)).astype(np.float32)
    y = rng.integers(0, CLASSES, 24).astype(np.int32)
    loader = ArrayLoader({TRAIN: x[:16], VALID: x[16:]},
                         {TRAIN: y[:16], VALID: y[16:]}, minibatch_size=B)
    sw = StandardWorkflow(_config())
    tr = sw.make_trainer(loader, Decision(max_epochs=1), device="cpu")
    tr.initialize(seed=0)
    tr.run()
    st = tr.step_cache.stats()
    assert st["train"] == {"captured": False, "reason": "cpu"}
    assert st["eval"] == {"captured": False, "reason": "cpu"}
    assert "dropout" not in repr(st)
