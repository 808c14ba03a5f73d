"""The port's training path on the CPU against the JAX package's: the
induction loader's data and epoch order, the train step (loss, gradients
and three Adam steps), two epochs of the ``Trainer``, snapshots resumed
across the two packages, and the training CLI.

Both packages compute in float32 here.  Tolerances: loader data,
permutations and batches bitwise; the loss rtol 1e-5; gradients rtol 1e-4
/ atol 1e-6 (the two sides sum in different orders); parameters and Adam
slots after three steps rtol 1e-4 / atol 1e-6; the trainer's epoch losses
and gradient norms rtol 1e-4, its error counts exact; a restored state
bitwise."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_helpers import (build_pair, induction_layers,  # noqa: E402
                            narrow_bench_layers, tokens, vocab_of)
from veles_tpu.models import lm as jlm  # noqa: E402
from veles_tpu.models.standard import StandardWorkflow as JaxStandard  # noqa: E402,E501
from veles_tpu.ops import losses as jlosses  # noqa: E402
from veles_tpu.ops import optimizers as jopt  # noqa: E402
from veles_tpu.runtime.decision import Decision as JaxDecision  # noqa: E402
from veles_tpu.runtime.snapshotter import Snapshotter as JaxSnapshotter  # noqa: E402,E501
from veles_tpu.runtime.snapshotter import _flatten as jax_flatten  # noqa: E402,E501
from veles_tpu.units.base import Context as JaxContext  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.loader.base import TRAIN, VALID  # noqa: E402
from veles_tpu_torch.models import lm  # noqa: E402
from veles_tpu_torch.models.standard import StandardWorkflow  # noqa: E402
from veles_tpu_torch.ops import losses  # noqa: E402
from veles_tpu_torch.ops import optimizers as popt  # noqa: E402
from veles_tpu_torch.runtime.decision import Decision  # noqa: E402
from veles_tpu_torch.runtime.snapshotter import (  # noqa: E402
    Snapshotter, _flatten, params_from_jax, wstate_to_numpy)
from veles_tpu_torch.units.base import Context  # noqa: E402
from veles_tpu_torch.units.workflow import new_state, seed_key  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
EPOCH_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _reset_port_prng():
    prng.streams.reset()
    yield
    prng.streams.reset()


def _host(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


# -- loader -------------------------------------------------------------------

def test_synth_data_matches_jax_at_full_width():
    """The chip's training data (seq_len 2048, vocab 1024) bit for bit."""
    for a, b in zip(lm.synth_induction(512, 64, 2048, 1024),
                    jlm.synth_induction(512, 64, 2048, 1024), strict=True):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for a, b in zip(lm.synth_repeat(256, 2048, 1024),
                    jlm.synth_repeat(256, 2048, 1024), strict=True):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("per_position", [False, True],
                         ids=["last_token", "per_position"])
def test_induction_loader_matches_jax(per_position):
    """Epoch permutations and every batch (tokens, labels, masks) of two
    epochs, bitwise; the port gathers on the CPU through gather_rows."""
    kw = dict(minibatch_size=32, n_train=100, n_valid=40, seq_len=24,
              vocab=16, per_position=per_position)
    jl, pl = jlm.InductionLoader(**kw), lm.InductionLoader(device="cpu", **kw)
    jl.initialize()
    pl.initialize()
    assert pl.on_device and pl.class_lengths == jl.class_lengths
    for klass in (TRAIN, VALID):
        for epoch in (0, 1):
            np.testing.assert_array_equal(pl.epoch_permutation(klass, epoch),
                                          jl.epoch_permutation(klass, epoch))
            for jb, pb in zip(jl.iter_epoch(klass, epoch),
                              pl.iter_epoch(klass, epoch), strict=True):
                jb, pb = _host(jb), _host(pb)
                assert sorted(jb) == sorted(pb)
                for key in jb:
                    assert jb[key].dtype == pb[key].dtype, key
                    assert jb[key].shape == pb[key].shape, key
                    assert jb[key].tobytes() == pb[key].tobytes(), key
    assert pl.state() == jl.state()


@pytest.mark.parametrize("per_position", [False, True],
                         ids=["last_token", "per_position"])
def test_force_host_batches_equal_the_device_path(per_position):
    """``force_host=True`` (numpy batches, the host branch of the
    per-position mask) serves the device path's tokens, labels and masks
    bitwise, padded last batch included."""
    kw = dict(minibatch_size=32, n_train=100, n_valid=40, seq_len=24,
              vocab=16, per_position=per_position)
    host = lm.InductionLoader(device="cpu", force_host=True, **kw)
    dev = lm.InductionLoader(device="cpu", **kw)
    host.initialize()
    dev.initialize()
    assert not host.on_device and dev.on_device
    for klass in (TRAIN, VALID):
        for hb, db in zip(host.iter_epoch(klass, 0), dev.iter_epoch(klass, 0),
                          strict=True):
            assert all(isinstance(v, np.ndarray) for v in hb.values())
            assert all(torch.is_tensor(v) for v in db.values())
            db = _host(db)
            assert sorted(hb) == sorted(db)
            for key in hb:
                assert hb[key].dtype == db[key].dtype, key
                assert hb[key].shape == db[key].shape, key
                assert hb[key].tobytes() == db[key].tobytes(), key


def test_context_makes_its_generator_on_first_use():
    """A train step's Context builds its generator only when a unit asks
    for it, once."""
    made = []

    def make():
        made.append(1)
        return torch.Generator().manual_seed(5)

    ctx = Context(train=True, make_generator=make)
    assert made == []
    gen = ctx.generator
    assert ctx.generator is gen and made == [1]
    assert Context(train=True).generator is None


# -- losses -------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_losses_match_jax(rng, masked):
    """Softmax CE per sample and per position (loss, n_err) and MSE
    (loss, per-sample sum; with the root), float32."""
    for lab_shape, lg_shape in (((6,), (6, 10)), ((3, 5), (3, 5, 10))):
        lg = rng.standard_normal(lg_shape).astype(np.float32)
        lab = rng.integers(0, 10, lab_shape).astype(np.int32)
        m = (rng.random(lab_shape) > 0.3).astype(np.float32) \
            if masked else None
        jl, je = jlosses.softmax_cross_entropy(lg, lab, mask=m)
        pl, pe = losses.softmax_cross_entropy(
            torch.from_numpy(lg), torch.from_numpy(lab),
            mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(pl), float(jl), rtol=LOSS_RTOL)
        assert float(pe) == float(je)
    out = rng.standard_normal((4, 3, 5)).astype(np.float32)
    tgt = rng.standard_normal((4, 15)).astype(np.float32)
    m = np.asarray([1, 1, 0, 1], np.float32) if masked else None
    for root_flag in (False, True):
        ref = jlosses.mse_loss(out, tgt, mask=m, root_flag=root_flag)
        got = losses.mse_loss(torch.from_numpy(out), torch.from_numpy(tgt),
                              mask=None if m is None else torch.from_numpy(m),
                              root_flag=root_flag)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(float(g), float(r), rtol=LOSS_RTOL)


# -- train step ---------------------------------------------------------------

STEP_CASES = {
    # configs/induction_lm.json: 2 attention layers, seq_last, softmax
    "induction_lm": (induction_layers, False, 4, 12),
    # bench_lm.py's topology, narrow, GQA, per-position head
    "narrow_bench": (narrow_bench_layers, True, 2, 16),
}


def _batches(rng, layers, per_position, B, T, n):
    V = vocab_of(layers)
    out = []
    for _ in range(n):
        lab = (B, T) if per_position else (B,)
        mask = np.ones(lab, np.float32)
        mask[-1] = 0.0                    # a padded row
        out.append({"@input": tokens(rng, (B, T), V),
                    "@labels": tokens(rng, lab, V), "@mask": mask})
    return out


def _port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _names(tree):
    return [f"{u}/{k}" for u in sorted(tree) for k in sorted(tree[u])]


@pytest.mark.parametrize("case", list(STEP_CASES), ids=list(STEP_CASES))
def test_train_step_matches_jax(rng, case):
    layers_fn, per_position, B, T = STEP_CASES[case]
    layers = layers_fn()
    jo, po = jopt.Adam(1e-3), popt.Adam(1e-3)
    jwf, jws, pwf, pws = build_pair(layers, B=B, T=T, seed=7,
                                    optimizers=(jo, po),
                                    per_position=per_position)
    batches = _batches(rng, layers, per_position, B, T, 3)

    # loss and gradients at the shared initial weights
    def jax_loss(params):
        out, _ = jwf.forward(params, jws["state"], batches[0],
                             JaxContext(train=True, key=jax.random.key(0)))
        return out[jwf.evaluator.name]

    j_loss, j_grads = jax.value_and_grad(jax_loss)(jws["params"])
    live = popt.tree_map(lambda t: t.detach().requires_grad_(True),
                         pws["params"])
    out, _ = pwf.forward(live, {}, _port_batch(batches[0]),
                         Context(train=True))
    p_loss = out[pwf.evaluator.name]
    p_grads = torch.autograd.grad(p_loss, popt.tree_leaves(live))
    np.testing.assert_allclose(float(p_loss.detach()), float(j_loss),
                               rtol=LOSS_RTOL)
    jg = jax_flatten(jax.device_get(j_grads))
    for name, g in zip(_names(live), p_grads, strict=True):
        np.testing.assert_allclose(g.numpy(), jg[name], err_msg=name,
                                   **GRAD_TOL)

    # three Adam steps through both train steps
    jstep = jwf.make_train_step(jo, donate=False)
    pstep = pwf.make_train_step(po)
    for b in batches:
        jws, jm = jstep(jws, b)
        pws, pm = pstep(pws, _port_batch(b))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        assert float(pm["n_err"]) == float(jm["n_err"])
        assert float(pm["n_samples"]) == float(jm["n_samples"])
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=EPOCH_RTOL)
    assert pws["step"] == int(jws["step"]) == 3
    for part in ("params", "opt_state"):
        pf = _flatten(wstate_to_numpy(pws)[part])
        jf = jax_flatten(jax.device_get(jws[part]))
        assert sorted(pf) == sorted(jf)
        for key in jf:
            np.testing.assert_allclose(pf[key], jf[key], err_msg=key,
                                       **STATE_TOL)


# -- trainer ------------------------------------------------------------------

CFG = {**jlm.INDUCTION_CONFIG, "max_epochs": 2}
LOADER = dict(minibatch_size=100, n_train=200, n_valid=100)


def _jax_trainer(epochs, seed=3, snapshotter=None):
    sw = JaxStandard(CFG)
    tr = sw.make_trainer(jlm.InductionLoader(**LOADER),
                         JaxDecision(max_epochs=epochs), snapshotter)
    tr.initialize(seed=seed)
    return tr


def _port_trainer(epochs, snapshotter=None, like=None):
    """A port trainer; ``like`` (a JAX trainer) gives it the same initial
    weights and a fresh optimizer state."""
    sw = StandardWorkflow(CFG)
    tr = sw.make_trainer(lm.InductionLoader(device="cpu", **LOADER),
                         Decision(max_epochs=epochs), snapshotter,
                         device="cpu")
    tr.initialize(seed=0)
    if like is not None:
        params = params_from_jax(jax.device_get(like.wstate["params"]),
                                 sw.workflow, device="cpu")
        tr.wstate = new_state(params, {}, sw.optimizer.init(params), 0,
                              seed_key(3))
    return tr


def _same_epochs(p_hist, j_hist):
    assert len(p_hist) == len(j_hist)
    for pe, je in zip(p_hist, j_hist):
        assert pe["epoch"] == je["epoch"]
        for split in ("train", "valid"):
            for k in ("n_err", "n_samples", "n_batches"):
                assert pe[split][k] == je[split][k], (split, k)
            for k in ("loss", "error_pct") + (("grad_norm",)
                                              if split == "train" else ()):
                np.testing.assert_allclose(pe[split][k], je[split][k],
                                           rtol=EPOCH_RTOL,
                                           err_msg=f"{split}/{k}")


def test_trainer_two_epochs_match_jax():
    jtr = _jax_trainer(2)
    ptr = _port_trainer(2, like=jtr)
    jres, pres = jtr.run(), ptr.run()
    _same_epochs(ptr.decision.history, jtr.decision.history)
    for k in ("workflow", "checksum", "epochs", "best_epoch"):
        assert pres[k] == jres[k], k
    np.testing.assert_allclose(pres["best_value"], jres["best_value"])
    assert pres["anomaly_steps_skipped"] == 0


def _same_state(p_ws, j_ws):
    pf = _flatten(wstate_to_numpy(p_ws))
    jf = jax_flatten(jax.device_get(
        {k: v for k, v in j_ws.items() if k != "key"}))
    pf.pop("key", None)
    assert sorted(pf) == sorted(jf)
    for key in jf:
        assert pf[key].dtype == jf[key].dtype, key
        assert pf[key].tobytes() == jf[key].tobytes(), key


def test_snapshots_resume_across_packages(tmp_path):
    """A port snapshot restores in the JAX Trainer (workflow checksums
    equal) and a JAX snapshot in the port's; state, loader position and
    decision carry over bitwise, and the next epoch agrees."""
    jsrc = _jax_trainer(1)
    psnap = Snapshotter("ind", str(tmp_path / "port"))
    ptr = _port_trainer(1, psnap, like=jsrc)
    ptr.run()
    assert psnap.last_path is not None

    jtr = _jax_trainer(2, seed=5)
    jtr.restore(psnap.last_path)
    _same_state(ptr.wstate, jtr.wstate)
    assert jtr.loader.epoch_number == ptr.loader.epoch_number == 1
    assert jtr.decision.best_value == ptr.decision.best_value

    jpath = JaxSnapshotter("jax", str(tmp_path / "jax")).save(
        "ep0", jtr._payload())
    ptr2 = _port_trainer(2)
    ptr2.restore(jpath)
    _same_state(ptr2.wstate, jtr.wstate)
    assert ptr2.loader.state() == jtr.loader.state()
    assert prng.streams.state().keys() >= {"loader"}

    jtr.run()
    ptr2.run()
    _same_epochs(ptr2.decision.history, jtr.decision.history)


def test_snapshot_throttle_and_retention(tmp_path):
    """``tick``/``maybe_save`` every ``interval``-th epoch (a best epoch
    always), ``snapshot_keep`` retention that spares the symlink
    targets."""
    from veles_tpu_torch.config import root
    snap = Snapshotter("t", str(tmp_path), interval=2)
    payload = {"wstate": {"params": {"u": {"w": np.ones(3, np.float32)}},
                          "step": 0}}
    assert snap.maybe_save("e0", payload) is None
    assert snap.maybe_save("e1", payload).endswith("t_e1.json")
    best = snap.maybe_save("e2", payload, best=True)
    assert best.endswith("t_e2.json")
    prev = root.common.get("snapshot_keep", 0)
    root.common.snapshot_keep = 1
    try:
        snap.save("e3", payload)
    finally:
        root.common.snapshot_keep = prev
    left = sorted(f for f in os.listdir(tmp_path) if f.endswith(".json"))
    # e1 went; e2 is the _best target, e3 the _current target
    assert left == ["t_best.json", "t_current.json", "t_e2.json",
                    "t_e3.json"]
    assert Snapshotter.load(str(tmp_path / "t_best.json"))["wstate"][
        "params"]["u"]["w"].tolist() == [1.0, 1.0, 1.0]


def test_restore_refuses_another_workflow(tmp_path):
    psnap = Snapshotter("ind", str(tmp_path))
    ptr = _port_trainer(1, psnap)
    ptr.run()
    other = StandardWorkflow({**CFG, "layers": CFG["layers"][:2] + [
        {"type": "seq_last", "name": "last"},
        {"type": "softmax", "output_size": 16, "name": "out"}]})
    tr = other.make_trainer(lm.InductionLoader(device="cpu", **LOADER),
                            device="cpu")
    with pytest.raises(ValueError, match="different workflow"):
        tr.restore(psnap.last_path)


# -- CLI ----------------------------------------------------------------------

def test_cli_trains_and_prints_results(tmp_path):
    cmd = [sys.executable, "-m", "veles_tpu_torch",
           os.path.join("configs", "induction_lm.json"),
           "root.loader.n_train=200", "root.loader.n_valid=100",
           "--max-epochs", "1", "--device", "cpu",
           "--snapshot-dir", str(tmp_path)]
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["workflow"] == "InductionLM" and res["epochs"] == 1
    assert 0.0 <= res["best_value"] <= 100.0
    assert os.path.exists(tmp_path / "InductionLM_current.json")
