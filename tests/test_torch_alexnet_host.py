"""The host-cropped AlexNet input path of the port
(veles_tpu_torch/models/alexnet.py ``ImagenetHostLoader`` and
``alexnet_e2e_workflow``) against the JAX package's: the loader's uint8
batches bitwise (train crops and mirrors from the same
``default_rng([seed, klass, first index])`` stream, the validation
centre crop, a batch of 128 cut on the thread pool), and two end-to-end
train steps (tests/test_models.py:115-140) through both Trainers from the
same weights, unit state and key, at the smallest side whose pool5 is
1x1 (input 67, store 72) and in float32: epoch loss and gradient norm
rtol 1e-4, error counts exact, the state key equal after the epoch."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from veles_tpu import prng as jprng  # noqa: E402
from veles_tpu.models import alexnet as jalex  # noqa: E402
from veles_tpu.runtime.decision import Decision as JaxDecision  # noqa: E402
from veles_tpu.runtime.snapshotter import _to_numpy as jax_host  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.loader.base import TRAIN, VALID  # noqa: E402
from veles_tpu_torch.models import alexnet  # noqa: E402
from veles_tpu_torch.runtime.decision import Decision  # noqa: E402
from veles_tpu_torch.runtime.snapshotter import wstate_from_jax  # noqa: E402
from _torch_helpers import port_autotune_off  # noqa: E402,F401

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _streams():
    for mod in (prng, jprng):
        mod.streams.reset()
        mod.seed("loader", 5)
    yield
    prng.streams.reset()
    jprng.streams.reset()


@pytest.fixture
def small_sides(monkeypatch):
    """Input 67 and store 72 in both packages."""
    monkeypatch.setattr(alexnet, "INPUT_HW", 67)
    monkeypatch.setattr(alexnet, "STORE_HW", 72)
    monkeypatch.setattr(jalex, "INPUT_HW", 67)
    monkeypatch.setattr(jalex.ImagenetHostLoader, "STORE_HW", 72)


def _same(jb, pb):
    assert sorted(jb) == sorted(pb)
    for k in jb:
        assert pb[k].dtype == jb[k].dtype and pb[k].shape == jb[k].shape, k
        assert pb[k].tobytes() == jb[k].tobytes(), k


@pytest.mark.parametrize("mb,n_train", [(8, 32), (128, 128)],
                         ids=["inline", "thread_pool"])
def test_host_loader_batches_match_jax(mb, n_train):
    kw = dict(minibatch_size=mb, n_train=n_train, n_valid=8)
    jld, pld = jalex.ImagenetHostLoader(**kw), alexnet.ImagenetHostLoader(
        **kw)
    jld.initialize()
    pld.initialize()
    assert pld.class_lengths == jld.class_lengths == [0, 8, n_train]
    for epoch in (0, 1):
        for klass in (VALID, TRAIN):
            for jb, pb in zip(jld.iter_epoch(klass, epoch),
                              pld.iter_epoch(klass, epoch), strict=True):
                _same(jb, pb)
    b = next(pld.iter_epoch(TRAIN, 0))
    assert b["@input"].dtype == np.uint8
    assert b["@input"].shape == (mb, 227, 227, 3)
    # the validation class is centre-cropped in every epoch
    _same(next(pld.iter_epoch(VALID, 0)), next(pld.iter_epoch(VALID, 1)))


def test_e2e_two_steps_match_jax(small_sides):
    kw = dict(minibatch_size=4, n_train=8, n_valid=4, compute_dtype=None)
    jsw = jalex.alexnet_e2e_workflow(minibatch_size=4, n_train=8,
                                     compute_dtype=None)
    jsw.loader.n_valid = 4
    for u in jsw.workflow.units:
        if type(u).__name__ == "Dropout":
            # the hashed mask (Pallas, interpret mode here), the port's
            u.use_pallas = True
    psw = alexnet.alexnet_e2e_workflow(**kw)
    assert [u.name for u in psw.workflow.units][:2] == ["norm0", "conv1"]
    jtr = jsw.make_trainer(jsw.loader, JaxDecision(max_epochs=1))
    ptr = psw.make_trainer(psw.loader, Decision(max_epochs=1),
                           device="cpu")
    jtr.initialize(seed=9)
    ptr.initialize(seed=0)
    ptr.wstate = wstate_from_jax(jax_host(jtr.wstate), psw.workflow,
                                 optimizer=psw.optimizer, device="cpu")
    jtr.run()
    ptr.run()
    (je,), (pe,) = jtr.decision.history, ptr.decision.history
    assert pe["train"]["n_batches"] == 2
    for split in ("train", "valid"):
        for k in ("n_err", "n_samples", "n_batches"):
            assert pe[split][k] == je[split][k], (split, k)
        for k in (("loss", "grad_norm") if split == "train"
                  else ("loss",)):
            assert np.isfinite(pe[split][k])
            np.testing.assert_allclose(pe[split][k], je[split][k],
                                       rtol=1e-4, err_msg=f"{split}/{k}")
    assert tuple(int(v) for v in ptr.wstate["key"]) == tuple(
        int(v) for v in jax.random.key_data(jtr.wstate["key"]))
