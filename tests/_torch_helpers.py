"""Shared fixtures of the tests/test_torch_*.py parity files: one layer
list built in both packages, with the JAX package's initial weights
carried into the port (float32, on the CPU)."""

import contextlib
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import veles_tpu as vt
from veles_tpu.models.standard import build_workflow as jax_build
from veles_tpu.ops import optimizers as jax_opt
from veles_tpu_torch.models.standard import build_workflow as port_build
from veles_tpu_torch.runtime.snapshotter import params_from_jax
from veles_tpu_torch.units.base import Spec
from veles_tpu_torch.units.workflow import new_state

@pytest.fixture(autouse=True)
def port_autotune_off():
    """The port's measured op picks off (``LRN(method="auto")`` is then
    "cumsum"), as tests/conftest.py turns the JAX package's off: a
    parity test must not depend on which formulation a timing picked.
    Autouse in every module that imports it."""
    from veles_tpu_torch.config import root as port_root
    prev = port_root.common.autotune
    port_root.common.autotune = False
    yield
    port_root.common.autotune = prev


CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "configs")


def induction_layers():
    """configs/induction_lm.json's layer list (attention x2 + seq_last +
    softmax head, vocab 16)."""
    with open(os.path.join(CONFIGS, "induction_lm.json")) as f:
        return json.load(f)["workflow"]["layers"]


def narrow_bench_layers(blocks=2, E=32, heads=4, kv_heads=2, hidden=64,
                        vocab=64):
    """bench_lm.py's layer list at a narrow width: embedding -> blocks x
    (GQA RoPE residual attention, layer_norm, ffn, layer_norm) ->
    per-position all2all head."""
    layers = [{"type": "embedding", "vocab": vocab, "dim": E,
               "name": "emb"}]
    for i in range(blocks):
        layers += [
            {"type": "attention", "n_heads": heads, "n_kv_heads": kv_heads,
             "rope": True, "residual": True, "name": f"attn{i}"},
            {"type": "layer_norm", "name": f"ln{i}a"},
            {"type": "ffn", "d_hidden": hidden, "name": f"ffn{i}"},
            {"type": "layer_norm", "name": f"ln{i}b"},
        ]
    layers.append({"type": "all2all", "output_size": vocab,
                   "per_position": True, "name": "head"})
    return layers


def vocab_of(layers):
    return layers[0]["vocab"]


def build_pair(layers, B=2, T=12, seed=0, optimizers=None,
               per_position=False):
    """(jax_wf, jax_wstate, port_wf, port_wstate) on shared weights: the
    JAX package initializes, the port receives the same numpy values.
    ``optimizers=(jax_optimizer, port_optimizer)`` gives both states the
    optimizer's fresh ``opt_state`` (else the port's stays empty);
    ``per_position`` builds (B, T) labels and masks (per-position head)."""
    lab = (B, T) if per_position else (B,)
    jwf = jax_build("parity", layers)
    jwf.build({"@input": vt.Spec((B, T), jnp.int32),
               "@labels": vt.Spec(lab, jnp.int32),
               "@mask": vt.Spec(lab, jnp.float32)})
    jopt = jax_opt.SGD(0.1) if optimizers is None else optimizers[0]
    jws = jwf.init_state(jax.random.key(seed), jopt)
    pwf = port_build("parity", layers)
    pwf.build({"@input": Spec((B, T), torch.int32),
               "@labels": Spec(lab, torch.int32),
               "@mask": Spec(lab, torch.float32)})
    params = params_from_jax(jax.device_get(jws["params"]), pwf,
                             device="cpu")
    opt_state = {} if optimizers is None else optimizers[1].init(params)
    return jwf, jws, pwf, new_state(params, {}, opt_state, 0, None)


def tokens(rng, shape, vocab):
    return rng.integers(0, vocab, shape).astype(np.int32)


# -- serving (tests/test_torch_serving_*.py) ---------------------------------

#: the served LM family (bench_lm.py's layer types) at a narrow width
SERVE_LAYERS = narrow_bench_layers()
SERVE_V = SERVE_LAYERS[0]["vocab"]


def serve_pair(seed=21):
    """(jax_wf, jax_wstate, port_wf, port_wstate) of SERVE_LAYERS."""
    return build_pair(SERVE_LAYERS, B=2, T=12, seed=seed)


def wait_for(cond, timeout=60.0, what=""):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.002)


def wait_busy(eng, timeout=60.0):
    """Until a slot decodes and nothing is queued (either package)."""
    wait_for(lambda: eng.stats()["occupancy"] >= 1
             and eng.stats()["queue_depth"] == 0, timeout, "engine busy")


@contextlib.contextmanager
def held(eng, method="_step_once"):
    """Hold a started port engine's scheduler at its next call of
    ``method`` (the decode step, or ``_admit``) for the body of the
    block; the rest of the scheduler waits with it."""
    gate = threading.Event()
    orig = getattr(eng, method)
    setattr(eng, method, lambda: (gate.wait(120), orig()))
    try:
        yield
    finally:
        gate.set()
