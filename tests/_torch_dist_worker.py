"""One rank of the port's gloo process groups in the tests
(tests/test_torch_pipeline_schedule.py, tests/test_torch_distributed.py):
``python _torch_dist_worker.py OUT RANK WORLD PORT SUITE`` joins the
group over ``127.0.0.1:PORT``, runs the named suite and saves what it
computed to ``OUT/<SUITE>_rank<RANK>.pt``.  Inputs come from numpy seeds,
so the test process rebuilds them for its references.  Imports no JAX.

``spawn(...)`` starts a whole group and waits for it; every group is
created with its own timeout, so a rank that hangs fails the test within
it."""

import math
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

#: seconds a collective of a test group may wait
GROUP_TIMEOUT_S = 60.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(suite: str, world: int, out_dir, timeout: float = 240.0,
          wait_ranks=None):
    """Run ``suite`` on ``world`` ranks; returns the saved dicts of the
    ``wait_ranks`` (default all; asserting each exited 0) and kills the
    others once those are done."""
    wait_ranks = list(range(world)) if wait_ranks is None else wait_ranks
    port = free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("VELES_PROCESS_ID", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(out_dir), str(r),
         str(world), str(port), suite],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    outs = {}
    deadline = time.monotonic() + timeout
    try:
        for r in wait_ranks:
            left = max(deadline - time.monotonic(), 1.0)
            outs[r] = procs[r].communicate(timeout=left)[0].decode()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r in wait_ranks:
        assert procs[r].returncode == 0, f"rank {r}:\n{outs[r][-4000:]}"
    return [torch.load(os.path.join(str(out_dir), f"{suite}_rank{r}.pt"))
            for r in wait_ranks]


# -- shared inputs ----------------------------------------------------------------

def tanh_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def res_stage(p, x):
    return x + torch.relu(x @ p["w1"]) @ p["w2"]


def mse(y, t):
    return torch.mean((y - t) ** 2)


def uniform_data(seed, L, M, mb, D):
    """Stage-stacked tanh params (L, ...), x and targets (M, mb, D)."""
    rng = np.random.default_rng(seed)
    p = {"w": rng.standard_normal((L, D, D)).astype(np.float32) * 0.4,
         "b": rng.standard_normal((L, D)).astype(np.float32) * 0.1}
    x = rng.standard_normal((M, mb, D)).astype(np.float32)
    y = rng.standard_normal((M, mb, D)).astype(np.float32)
    return p, x, y


def hetero_data(seed, M, mb, D, H=12):
    rng = np.random.default_rng(seed)
    p0 = {"w": rng.standard_normal((D, D)).astype(np.float32) * 0.4,
          "b": np.zeros(D, np.float32)}
    p1 = {"w1": rng.standard_normal((D, H)).astype(np.float32) * 0.3,
          "w2": rng.standard_normal((H, D)).astype(np.float32) * 0.3}
    x = rng.standard_normal((M, mb, D)).astype(np.float32)
    y = rng.standard_normal((M, mb, D)).astype(np.float32)
    return [p0, p1], x, y


def keyed_stage(p, x, key):
    """A stochastic stage with an aux loss: tanh, a dropout drawn from
    the microbatch key, aux = 0.1 * mean(h^2)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.ops.kernels.fused_dropout import fused_dropout
    h = torch.tanh(x @ p["w"] + p["b"])
    h = fused_dropout(h, prng.bits32(prng.fold_in(key, 7)), 0.25)
    return h, 0.1 * torch.mean(h ** 2)


def t(a):
    return torch.from_numpy(np.asarray(a))


def tree_t(tree):
    if isinstance(tree, dict):
        return {k: tree_t(v) for k, v in tree.items()}
    return t(tree)


V, E = 12, 16


def pp_layers(n_stages=2, moe=True, dropout=True):
    """A small pipelined LM: embedding -> stack -> seq_last -> head; the
    stages attention (+ dropout) + layer_norm, the last an MoE stage."""
    stages = []
    for i in range(n_stages):
        st = [{"type": "attention", "n_heads": 2, "rope": True,
               "residual": True}]
        if dropout:
            st.append({"type": "dropout", "dropout_ratio": 0.2})
        st.append({"type": "layer_norm"})
        stages.append(st)
    if moe:
        stages[-1] = [{"type": "moe", "n_experts": 4, "d_hidden": 24,
                       "top_k": 2, "aux_weight": 0.1},
                      {"type": "layer_norm"}]
    return [{"type": "embedding", "vocab": V, "dim": E, "name": "emb"},
            {"type": "pipeline_stack", "name": "stack", "stages": stages,
             "n_microbatches": n_stages},
            {"type": "seq_last", "name": "last"},
            {"type": "softmax", "output_size": V, "name": "out"}]


def pp_batch(seed, B, T):
    rng = np.random.default_rng(seed)
    mask = np.ones(B, np.float32)
    mask[-3:] = 0.0                      # a ragged tail: padded rows
    return {"@input": rng.integers(0, V, (B, T)).astype(np.int32),
            "@labels": rng.integers(0, V, B).astype(np.int32),
            "@mask": mask}


def pp_workflow(layers, B, T, seed=3):
    """(workflow, wstate) with SGD(lr=1): new params = old - grads."""
    from veles_tpu_torch.models.standard import build_workflow
    from veles_tpu_torch.ops.optimizers import SGD
    from veles_tpu_torch.units.base import Spec
    wf = build_workflow("pp", layers)
    wf.build({"@input": Spec((B, T), torch.int32),
              "@labels": Spec((B,), torch.int32),
              "@mask": Spec((B,), torch.float32)})
    opt = SGD(1.0)
    ws = wf.init_state(seed, opt, "cpu")
    return wf, ws, opt


def fused_step(mesh, layers, B, T, n_mb, interleave=1, seed=3):
    """One fused step; returns the grads (old - new params) and metrics."""
    from veles_tpu_torch.ops.optimizers import tree_map
    wf, ws, opt = pp_workflow(layers, B, T, seed)
    before = tree_map(lambda x: x.clone(), ws["params"])
    step = wf.make_pipeline_train_step(opt, mesh, n_microbatches=n_mb,
                                       interleave=interleave)
    ws, mets = step(ws, tree_t(pp_batch(seed, B, T)))
    grads = tree_map(lambda a, b: a - b, before, ws["params"])
    return {"grads": grads, "metrics": {k: float(v)
                                        for k, v in mets.items()}}


def norm_layers(D=16, S=2):
    """tests/test_pipeline_product.py:720's chain: a MeanDispNormalizer
    with read-only dataset statistics before a homogeneous stack."""
    return [{"type": "norm", "name": "norm",
             "mean": np.linspace(-1.0, 1.0, D).tolist(),
             "rdisp": np.linspace(0.5, 2.0, D).tolist()},
            {"type": "pipeline_stack", "n_stages": S, "d_hidden": 32,
             "n_microbatches": S, "name": "stack"},
            {"type": "softmax", "output_size": 5, "name": "out"}]


def norm_step(mesh=None, B=16, D=16):
    """One SGD(1) step of the normalizer chain: fused on ``mesh``, else
    the plain step; returns the grads (old - new params), the metrics
    and the normalizer's state after it."""
    from veles_tpu_torch.models.standard import build_workflow
    from veles_tpu_torch.ops.optimizers import SGD, tree_map
    from veles_tpu_torch.units.base import Spec
    wf = build_workflow("pp_statenorm", norm_layers(D))
    wf.build({"@input": Spec((B, D), torch.float32),
              "@labels": Spec((B,), torch.int32),
              "@mask": Spec((B,), torch.float32)})
    opt = SGD(1.0)
    ws = wf.init_state(1, opt, "cpu")
    rng = np.random.default_rng(8)
    batch = tree_t({"@input": (rng.standard_normal((B, D)) * 2 + 1)
                    .astype(np.float32),
                    "@labels": rng.integers(0, 5, B).astype(np.int32),
                    "@mask": np.ones(B, np.float32)})
    before = tree_map(lambda x: x.clone(), ws["params"])
    step = (wf.make_train_step(opt) if mesh is None else
            wf.make_pipeline_train_step(opt, mesh, n_microbatches=2))
    ws, mets = step(ws, batch)
    return {"grads": tree_map(lambda a, b: a - b, before, ws["params"]),
            "metrics": {k: float(v) for k, v in mets.items()},
            "state": tree_map(lambda x: x.clone(), ws["state"])}


def dp_layers():
    """tests/test_parallel.py's fc workflow (fc1 tanh 32, softmax 4)."""
    return [{"type": "all2all_tanh", "output_size": 32, "name": "fc1"},
            {"type": "softmax", "output_size": 4, "name": "out"}]


def dp_workflow(B=16):
    from veles_tpu_torch.models.standard import build_workflow
    from veles_tpu_torch.ops.optimizers import SGD
    from veles_tpu_torch.units.base import Spec
    wf = build_workflow("fc", dp_layers())
    wf.build({"@input": Spec((B, 16), torch.float32),
              "@labels": Spec((B,), torch.int32),
              "@mask": Spec((B,), torch.float32)})
    opt = SGD(0.05, momentum=0.9)
    return wf, wf.init_state(0, opt, "cpu"), opt


def dp_batches(B=16, n=3):
    rng = np.random.default_rng(21)
    out = []
    for i in range(n):
        mask = np.ones(B, np.float32)
        if i == n - 1:
            mask[-5:] = 0.0              # a ragged tail batch
        out.append({"@input": rng.standard_normal((B, 16)).astype(
                        np.float32),
                    "@labels": rng.integers(0, 4, B).astype(np.int32),
                    "@mask": mask})
    return out


def dp_loader(n=224, mb=32):
    """Four Gaussian blobs (tests/test_parallel.py:30-35); the validation
    labels are shuffled, so the validation error stalls and the Decision
    rolls back."""
    from veles_tpu_torch.loader.base import TRAIN, VALID, ArrayLoader
    rng = np.random.default_rng(3)
    centers = np.random.default_rng(7).standard_normal((4, 16)) * 3
    lab = rng.integers(0, 4, n).astype(np.int32)
    d = (centers[lab] + rng.standard_normal((n, 16))).astype(np.float32)
    return ArrayLoader({TRAIN: d, VALID: d[:96]},
                       {TRAIN: lab, VALID: rng.permutation(lab[:96])},
                       minibatch_size=mb)


# -- suites -------------------------------------------------------------------------

def suite_schedules2(mesh):
    from veles_tpu_torch.parallel.pipeline import (interleaved_train_step,
                                                   pipeline_apply,
                                                   pipeline_train_step)
    out = {}
    ps, x, _ = hetero_data(1, 4, 3, 8)
    fns = [lambda p, h: (tanh_stage(p, h), torch.zeros(())),
           lambda p, h: (res_stage(p, h), torch.zeros(()))]
    out["apply"] = pipeline_apply(fns, [tree_t(p) for p in ps], t(x),
                                  mesh)[0]
    for M in (2, 4, 6):
        p, x, y = uniform_data(M, 2, M, 3, 8)
        out[f"uniform_M{M}"] = pipeline_train_step(
            tanh_stage, mse, tree_t(p), t(x), t(y), mesh)
    ps, x, y = hetero_data(2, 4, 3, 8)
    out["hetero"] = pipeline_train_step(
        [tanh_stage, res_stage], mse, [tree_t(p) for p in ps], t(x), t(y),
        mesh)
    p, x, y = uniform_data(3, 4, 4, 3, 8)
    out["interleaved"] = interleaved_train_step(
        tanh_stage, mse, tree_t(p), t(x), t(y), mesh, interleave=2)
    p, x, y = uniform_data(4, 2, 4, 3, 8)
    out["keyed"] = pipeline_train_step(
        keyed_stage, mse, tree_t(p), t(x), t(y), mesh, rng=(3, 9),
        with_aux=True)
    out["workflow"] = fused_step(mesh, pp_layers(), 16, 6, 4)
    out["workflow_plain"] = fused_step(
        mesh, pp_layers(moe=False, dropout=False), 16, 6, 2)
    out["workflow_interleaved"] = fused_step(
        mesh, pp_layers(4, moe=False, dropout=False), 16, 6, 4,
        interleave=2)
    out["stateful_normalizer"] = norm_step(mesh)
    return out


def suite_schedules4(mesh):
    from veles_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from veles_tpu_torch.parallel.pipeline import pipeline_train_step
    out = {"coords": dict(mesh.coords)}
    p, x, y = uniform_data(5, 2, 4, 4, 8)
    out["uniform_dp"] = pipeline_train_step(
        tanh_stage, mse, tree_t(p), t(x), t(y), mesh, batch_axes=("data",))
    out["workflow_dp"] = fused_step(mesh, pp_layers(), 16, 6, 2)
    # microbatches of 3 rows: the data axis does not divide them, so
    # every data rank computes them whole
    out["workflow_dp_replicated"] = fused_step(mesh, pp_layers(), 6, 6, 2)
    deep = make_mesh(MeshSpec(data=1, pipe=4), timeout_s=GROUP_TIMEOUT_S)
    for M in (4, 8):
        p, x, y = uniform_data(10 + M, 4, M, 2, 8)
        out[f"deep_M{M}"] = pipeline_train_step(
            tanh_stage, mse, tree_t(p), t(x), t(y), deep)
    return out


def suite_dp(mesh, out_dir, rank):
    """Data parallelism over 2 ranks: three sharded steps, then a
    trainer with a rollback and a snapshotter (rank 0 writes)."""
    from veles_tpu_torch.ops.optimizers import SGD
    from veles_tpu_torch.runtime.decision import Decision
    from veles_tpu_torch.runtime.snapshotter import Snapshotter
    from veles_tpu_torch.runtime.trainer import Trainer
    from veles_tpu_torch.units.workflow import ShardedTrainStep
    out = {}
    wf, ws, opt = dp_workflow()
    step = wf.make_sharded_train_step(opt, mesh)
    out["steps"] = []
    for b in dp_batches():
        ws, mets = step(ws, tree_t(b))
        out["steps"].append({k: float(v) for k, v in mets.items()})
    out["params"] = ws["params"]
    wf2, _, _ = dp_workflow()
    snap_dir = os.path.join(str(out_dir), f"snaps{rank}")
    tr = Trainer(wf2, dp_loader(), SGD(0.05, momentum=0.9),
                 Decision(max_epochs=3, fail_iterations=10,
                          rollback_after=1),
                 Snapshotter("dp", snap_dir), device="cpu", mesh=mesh)
    tr.initialize(seed=0)
    group = mesh.group("data")
    rollbacks = []
    write = tr._write_state
    tr._write_state = lambda payload: (rollbacks.append(1), write(payload))
    res = tr.run()
    out["trainer"] = {"best_value": res["best_value"],
                      "sharded": isinstance(tr._train_step.step,
                                            ShardedTrainStep),
                      "same_group": tr.mesh.group("data") is group,
                      "compiles": tr.step_cache.compiles,
                      "rollbacks": len(rollbacks),
                      "params": tr.wstate["params"]}
    return out


def suite_hang(mesh, out_dir, rank):
    """Rank 1 never joins: rank 0's all-reduce must fail within the
    group's timeout (the group here is made with 5 s)."""
    import torch.distributed as dist
    if rank == 1:
        time.sleep(120)          # the test kills it once rank 0 is done
        return {}
    t0 = time.monotonic()
    try:
        dist.all_reduce(torch.ones(3))
        err = None
    except Exception as e:                    # the timeout surfaces here
        err = repr(e)
    return {"error": err, "waited_s": time.monotonic() - t0}


# -- ring attention and the expert exchange -----------------------------------

#: (name, causal, window, heads, kv heads) of the ring's cases
RING_CASES = (("full", False, None, 4, 4), ("causal", True, None, 4, 4),
              ("window_gqa", True, 6, 4, 2))


def ring_inputs(seed, H, Hk, B=2, T=16, D=8):
    """q (B, T, H, D), k/v (B, T, Hk, D) and the loss weights w (like
    q): the loss is sum(attention(q, k, v) * w)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hk, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hk, D)).astype(np.float32)
    w = rng.standard_normal((B, T, H, D)).astype(np.float32)
    return q, k, v, w


def moe_inputs(seed, N=32, D=16, E=4, Hd=24):
    """A MoE layer's params (router (D, E), banks w1 (E, D, Hd), w2 (E,
    Hd, D)), tokens x (N, D) and the loss weights wy (N, D)."""
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, E)).astype(np.float32) * 0.5,
         "w1": rng.standard_normal((E, D, Hd)).astype(np.float32) * 0.3,
         "w2": rng.standard_normal((E, Hd, D)).astype(np.float32) * 0.3}
    x = rng.standard_normal((N, D)).astype(np.float32)
    wy = rng.standard_normal((N, D)).astype(np.float32)
    return p, x, wy


#: MoE cases: (top_k, capacity_factor); 8.0 drops nothing
MOE_CASES = ((1, 8.0), (2, 8.0))
#: the aux loss's weight in the MoE cases' objective
MOE_AUX_W = 0.5


def suite_ring4(mesh):
    """ring_attention over seq=4 and over data=2 x seq=2 (whole tensors
    in, whole output and gradients out), and moe_apply_manual over
    expert=4 and data=2 x expert=2 (tokens split over every axis; the
    gradients summed over the world)."""
    import torch.distributed as dist
    from veles_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from veles_tpu_torch.parallel.moe import moe_apply_manual
    from veles_tpu_torch.parallel.ring_attention import ring_attention
    out = {}
    meshes = {4: mesh, 2: make_mesh(MeshSpec(data=2, seq=2),
                                    timeout_s=GROUP_TIMEOUT_S)}
    for n, m in meshes.items():
        for i, (name, causal, window, H, Hk) in enumerate(RING_CASES):
            q, k, v, w = (t(a).requires_grad_(True)
                          for a in ring_inputs(i, H, Hk))
            o = ring_attention(q, k, v, m, causal=causal, window=window)
            g = torch.autograd.grad((o * w).sum(), (q, k, v))
            out[f"ring_{name}_seq{n}"] = {"o": o.detach(), "grads": g}
    for spec in ("expert=4", "data=2,expert=2"):
        m = make_mesh(MeshSpec.parse(spec), timeout_s=GROUP_TIMEOUT_S)
        for top_k, cf in MOE_CASES:
            p, x, wy = moe_inputs(top_k)
            p = {k: t(a).requires_grad_(True) for k, a in p.items()}
            rows = slice(mesh.rank * 8, mesh.rank * 8 + 8)
            y, aux = moe_apply_manual(p, t(x)[rows], mesh=m, top_k=top_k,
                                      capacity_factor=cf)
            obj = (y * t(wy)[rows]).sum() + MOE_AUX_W * aux
            g = torch.autograd.grad(obj, list(p.values()))
            flat = torch.cat([a.reshape(-1) for a in g])
            dist.all_reduce(flat)
            out[f"moe_{spec}_k{top_k}"] = {
                "y": y.detach(), "aux": float(aux),
                "grads": {k: a for k, a in zip(p, flat.split(
                    [a.numel() for a in g]))}}
    return out


# -- the seq and expert axes in the train steps ------------------------------

AX_V, AX_E = 12, 16

#: tests/test_pipeline_product.py's stage blocks
SP_STAGE = [{"type": "attention", "n_heads": 2, "rope": True,
             "residual": True}, {"type": "layer_norm"}]
SWA_STAGE = [{"type": "attention", "n_heads": 4, "n_kv_heads": 2,
              "window": 8, "rope": True, "residual": True},
             {"type": "layer_norm"}]
EP_STAGE = [{"type": "moe", "n_experts": 4, "d_hidden": 32, "top_k": 1,
             "capacity_factor": 8.0, "aux_weight": 0.01},
            {"type": "layer_norm"}]
EP_BLOCK = [{"type": "attention", "n_heads": 2, "rope": True,
             "residual": True}, {"type": "layer_norm"},
            {"type": "moe", "n_experts": 4, "d_hidden": 32, "top_k": 1,
             "capacity_factor": 8.0, "aux_weight": 0.0},
            {"type": "layer_norm"}]
SP_EP_BLOCK = [{"type": "attention", "n_heads": 2, "rope": True,
                "residual": True},
               {"type": "dropout", "dropout_ratio": 0.1},
               {"type": "layer_norm"},
               {"type": "moe", "n_experts": 4, "d_hidden": 32, "top_k": 1,
                "capacity_factor": 4.0},
               {"type": "layer_norm"}]


def per_position_layers(stage, n_stages, n_mb=2):
    """tests/test_pipeline_product.py:513's LM: embedding -> stack ->
    per-position head (every folded edge unit positionwise)."""
    return [{"type": "embedding", "vocab": AX_V, "dim": AX_E, "name": "emb"},
            {"type": "pipeline_stack", "name": "stack",
             "stages": [stage] * n_stages, "n_microbatches": n_mb},
            {"type": "softmax", "output_size": AX_V, "per_position": True,
             "name": "out"}]


def het_layers():
    """An attention stage and an FFN stage, seq_last and a head
    (tests/test_pipeline_product.py:675 and :770)."""
    return [{"type": "embedding", "vocab": AX_V, "dim": AX_E, "name": "emb"},
            {"type": "pipeline_stack", "name": "stack", "n_microbatches": 2,
             "stages": [SP_STAGE, [{"type": "ffn", "d_hidden": 32},
                                   {"type": "layer_norm"}]]},
            {"type": "seq_last", "name": "last"},
            {"type": "softmax", "output_size": AX_V, "name": "out"}]


def lm_batch(seed, B, T, ragged=0, per_position=True):
    """Next-token batch (labels (B, T), or (B,) the last token); the
    last ``ragged`` rows masked out."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, AX_V, (B, T)).astype(np.int32)
    y = np.roll(x, -1, axis=1).astype(np.int32) if per_position \
        else x[:, -1].copy()
    mask = np.ones(B, np.float32)
    if ragged:
        mask[-ragged:] = 0.0
    return {"@input": x, "@labels": y, "@mask": mask}


def axes_workflow(layers, batch, lr, seed=0, momentum=0.0):
    from veles_tpu_torch.models.standard import build_workflow
    from veles_tpu_torch.ops.optimizers import SGD
    from veles_tpu_torch.units.base import Spec
    wf = build_workflow("axes", layers)
    wf.build({k: Spec(v.shape, torch.from_numpy(v).dtype)
              for k, v in batch.items()})
    opt = SGD(lr, momentum=momentum)
    return wf, wf.init_state(seed, opt, "cpu"), opt


def fused_axes_step(mesh, layers, batch, *, n_mb=2, interleave=1, lr=0.1,
                    steps=1):
    """``steps`` fused steps of SGD(lr); the params and every step's
    metrics."""
    wf, ws, opt = axes_workflow(layers, batch, lr)
    step = wf.make_pipeline_train_step(opt, mesh, n_microbatches=n_mb,
                                       interleave=interleave)
    mets = []
    for _ in range(steps):
        ws, m = step(ws, tree_t(batch))
        mets.append({k: float(v) for k, v in m.items()})
    return {"params": ws["params"], "metrics": mets}


def sharded_axes_steps(mesh, layers, batch, *, lr, steps, momentum=0.0):
    """``steps`` sharded train steps on one fixed batch; the params and
    every step's metrics."""
    wf, ws, opt = axes_workflow(layers, batch, lr, momentum=momentum)
    step = wf.make_sharded_train_step(opt, mesh)
    mets = []
    for _ in range(steps):
        ws, m = step(ws, tree_t(batch))
        mets.append({k: float(v) for k, v in m.items()})
    ev = wf.make_sharded_eval_step(mesh)(ws, tree_t(batch))
    return {"params": ws["params"], "metrics": mets,
            "eval": {k: float(v) for k, v in ev.items()}}


def unit_layers(kind, capacity_factor=None):
    """tests/test_parallel_units.py's configs: attention (sp), MoE (ep)
    or both, then flatten and a 4-class head."""
    attn = {"type": "attention", "n_heads": 2, "name": "attn",
            "causal": False}
    moe = {"type": "moe", "n_experts": 4 if kind == "ep" else 2,
           "d_hidden": 32, "name": "moe1", "top_k": 2}
    if capacity_factor is not None:
        moe["capacity_factor"] = capacity_factor
    body = {"sp": [attn], "ep": [moe], "sp_ep": [attn, moe]}[kind]
    return body + [{"type": "flatten", "name": "flat"},
                   {"type": "softmax", "output_size": 4, "name": "out"}]


def unit_batch(seed=0, B=8, T=16, E=16, ragged=0):
    """tests/test_parallel_units.py:20's task: the label is the quarter of
    the feature space with the most energy in the mean token."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    mean = x.mean(1).reshape(B, 4, E // 4)
    mask = np.ones(B, np.float32)
    if ragged:
        mask[-ragged:] = 0.0
    return {"@input": x,
            "@labels": np.abs(mean).sum(-1).argmax(-1).astype(np.int32),
            "@mask": mask}


def width_data(seed=31, L=2, M=2, mb=4, T=6, D=8):
    """Stage-stacked tanh params (L, ...), x and targets (M, mb, T, D):
    samples with a leading sequence dim for ``width_axes``."""
    rng = np.random.default_rng(seed)
    p = {"w": rng.standard_normal((L, D, D)).astype(np.float32) * 0.4,
         "b": rng.standard_normal((L, D)).astype(np.float32) * 0.1}
    x = rng.standard_normal((M, mb, T, D)).astype(np.float32)
    y = rng.standard_normal((M, mb, T, D)).astype(np.float32)
    return p, x, y


#: (mesh spec, kind) of the sharded steps
SHARDED_MESHES = (("data=2,seq=4", "sp"), ("data=2,expert=4", "ep"),
                  ("data=2,seq=2,expert=2", "sp_ep"))


def suite_axes8(mesh):
    """8 ranks: the fused 1F1B step over pp2 x sp2 x dp2 (plain, ragged,
    sliding window + GQA, interleaved), over pp2 x ep2 x dp2 (MoE stages,
    interleaved attention + MoE blocks, an idle expert axis), over pp2 x
    sp2 x ep2 (8 steps), and the sharded step over the
    SHARDED_MESHES."""
    from veles_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    def mk(spec):
        return make_mesh(MeshSpec.parse(spec), timeout_s=GROUP_TIMEOUT_S)
    from veles_tpu_torch.parallel.mesh import shard_rows
    from veles_tpu_torch.parallel.pipeline import pipeline_train_step
    out = {"coords": dict(mesh.coords)}
    p, x, y = width_data()
    out["width"] = pipeline_train_step(
        tanh_stage, lambda h, tgt: mse(h, shard_rows(tgt, ("seq",), mesh,
                                                     dim=1)),
        tree_t(p), t(x), t(y), mesh, batch_axes=("data",),
        width_axes=("seq",))
    b8 = lm_batch(1, 8, 8)
    out["sp"] = fused_axes_step(mesh, per_position_layers(SP_STAGE, 2), b8)
    out["sp_ragged"] = fused_axes_step(
        mesh, per_position_layers(SP_STAGE, 2), lm_batch(1, 8, 8, ragged=3))
    out["sp_swa_gqa"] = fused_axes_step(
        mesh, per_position_layers(SWA_STAGE, 2), lm_batch(2, 8, 16))
    out["sp_interleaved"] = fused_axes_step(
        mesh, per_position_layers(SP_STAGE, 4), b8, interleave=2)
    ep = mk("data=2,expert=2,pipe=2")
    out["ep"] = fused_axes_step(ep, per_position_layers(EP_STAGE, 2), b8)
    out["ep_interleaved"] = fused_axes_step(
        ep, per_position_layers(EP_BLOCK, 4), b8, interleave=2)
    out["ep_idle"] = fused_axes_step(
        ep, het_layers(), lm_batch(1, 8, 8, per_position=False))
    out["sp_ep"] = fused_axes_step(
        mk("seq=2,expert=2,pipe=2"), per_position_layers(SP_EP_BLOCK, 2),
        b8, lr=0.3, steps=8)
    for spec, kind in SHARDED_MESHES:
        m = mk(spec)
        out[f"exact_{spec}"] = sharded_axes_steps(
            m, unit_layers(kind, capacity_factor=8.0),
            unit_batch(3, ragged=2), lr=0.1, steps=2)
        out[f"trains_{spec}"] = sharded_axes_steps(
            m, unit_layers(kind), unit_batch(), lr=0.05, momentum=0.9,
            steps=30 if kind != "sp_ep" else 15)
    return out


# -- the fsdp and model axes ---------------------------------------------------

#: the LM's megatron table: attention by heads, the FFN by hidden columns
TP_TABLE = {"attn/wq": (None, "model"), "attn/wk": (None, "model"),
            "attn/wv": (None, "model"), "attn/wo": ("model", None),
            "ffn/w1": (None, "model"), "ffn/w2": ("model", None)}


def tp_lm_layers(n_heads=4, n_kv_heads=None):
    """embedding -> attention (RoPE, residual) -> FFN -> layer norm ->
    per-position head; ``n_kv_heads`` below the model axis splits no
    whole kv head (gathered on use)."""
    attn = {"type": "attention", "n_heads": n_heads, "rope": True,
            "residual": True, "name": "attn"}
    if n_kv_heads is not None:
        attn["n_kv_heads"] = n_kv_heads
    return [{"type": "embedding", "vocab": AX_V, "dim": AX_E, "name": "emb"},
            attn, {"type": "ffn", "d_hidden": 32, "name": "ffn"},
            {"type": "layer_norm", "name": "ln"},
            {"type": "softmax", "output_size": AX_V, "per_position": True,
             "name": "out"}]


def image_batch(seed, B=16, ragged=3):
    rng = np.random.default_rng(seed)
    mask = np.ones(B, np.float32)
    mask[-ragged:] = 0.0
    return {"@input": rng.standard_normal((B, 16, 16, 3)).astype(np.float32),
            "@labels": rng.integers(0, 10, B).astype(np.int32),
            "@mask": mask}


def tp_case(name):
    """(layers, batch, rule table, fsdp min_size) of a TP_CASES entry."""
    from veles_tpu_torch.parallel.dryrun import dryrun_layers
    if name == "dryrun":
        return (dryrun_layers(), image_batch(4),
                {"fc6/w": (None, "model"), "fc7/w": ("model", None)}, 256)
    kv = {"lm_whole": None, "lm_gqa_gathered": 1}[name]
    return (tp_lm_layers(4 if kv is None else 2, kv),
            lm_batch(5, 8, 8, ragged=2), TP_TABLE, 64)


#: the sharded step's cases: the dryrun stack, an LM whose heads split
#: whole, one whose single kv head does not split (gathered on use)
TP_CASES = ("dryrun", "lm_whole", "lm_gqa_gathered")
#: meshes over the 8 ranks: data x fsdp, data x model, all three
TP_MESHES = ("data=4,fsdp=2", "data=4,model=2", "data=2,fsdp=2,model=2")
TP_LR, TP_MOMENTUM, TP_STEPS = 0.1, 0.9, 2


def tp_rule(table, min_size):
    from veles_tpu_torch.parallel.mesh import (compose_rules, fsdp_rules,
                                               tensor_parallel_rules)
    return compose_rules(tensor_parallel_rules(table),
                         fsdp_rules(min_size=min_size))


def host_t(tree):
    """A host (numpy) state tree as tensors, for ``torch.save``."""
    if isinstance(tree, dict):
        return {k: host_t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_t(v) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree))
    return tree


def gathered(step, ws):
    """The whole params and optimizer state, gathered (collective)."""
    full = step.state.gather_state(ws)
    return host_t({"params": full["params"],
                   "opt_state": full["opt_state"]})


def stored_shapes(ws):
    from veles_tpu_torch.ops.optimizers import tree_map
    return {"params": tree_map(lambda x: tuple(x.shape), ws["params"]),
            "opt_state": tree_map(lambda x: tuple(np.shape(x)),
                                  ws["opt_state"])}


def suite_tp8(mesh):
    """The sharded train and eval steps over TP_MESHES x TP_CASES
    (SGD with momentum, TP_STEPS steps on one ragged batch): each
    rank's stored shapes, the splits its units compute over the model
    group, every step's metrics, the eval metrics and the whole state
    gathered after."""
    from veles_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    out = {"coords": dict(mesh.coords)}
    for spec in TP_MESHES:
        m = make_mesh(MeshSpec.parse(spec), timeout_s=GROUP_TIMEOUT_S)
        for name in TP_CASES:
            layers, batch, table, min_size = tp_case(name)
            rule = tp_rule(table, min_size)
            wf, ws, opt = axes_workflow(layers, batch, TP_LR,
                                        momentum=TP_MOMENTUM)
            step = wf.make_sharded_train_step(opt, m, rule=rule)
            ws = step.place(ws)
            rec = {"stored": stored_shapes(ws), "tp": step.state.tp,
                   "metrics": []}
            for _ in range(TP_STEPS):
                ws, mets = step(ws, tree_t(batch))
                rec["metrics"].append({k: float(v) for k, v in mets.items()})
            ev = wf.make_sharded_eval_step(m, rule=rule)(ws, tree_t(batch))
            rec["eval"] = {k: float(v) for k, v in ev.items()}
            rec["state"] = gathered(step, ws)
            out[f"{spec}/{name}"] = rec
    return out


def fc_workflow(B=64, lr=0.1, per_unit=None):
    """tests/test_parallel.py:24's fc workflow at batch ``B``."""
    from veles_tpu_torch.models.standard import build_workflow
    from veles_tpu_torch.ops.optimizers import SGD
    from veles_tpu_torch.units.base import Spec
    wf = build_workflow("fc", dp_layers())
    wf.build({"@input": Spec((B, 16), torch.float32),
              "@labels": Spec((B,), torch.int32),
              "@mask": Spec((B,), torch.float32)})
    opt = SGD(lr, momentum=0.9, per_unit=per_unit)
    return wf, wf.init_state(0, opt, "cpu"), opt


def fc_batch(seed=9, B=64, nan_rows=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 16)).astype(np.float32) * 2
    if nan_rows is not None:
        x[nan_rows] = np.nan
    mask = np.ones(B, np.float32)
    mask[-7:] = 0.0
    return {"@input": x, "@labels": rng.integers(0, 4, B).astype(np.int32),
            "@mask": mask}


def whole_grads(wf, ws, batch):
    """The one-process step's gradients of the whole batch's masked
    mean (a dict tree like the params)."""
    from veles_tpu_torch.ops.optimizers import tree_leaves, tree_map
    from veles_tpu_torch.units.base import Context
    live = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                    ws["params"])
    out, _ = wf.forward(live, ws["state"], tree_t(batch),
                        Context(train=True))
    leaves = tree_leaves(live)
    it = iter(torch.autograd.grad(out[wf.evaluator.name], leaves))
    return tree_map(lambda _: next(it), live)


#: fsdp_rules(min_size) of the fc workflow (tests/test_parallel.py:87)
FC_MIN = 128


def clip_between(wf, ws, batch, layout, unit=None):
    """A clip norm between the largest norm one rank's blocks give (its
    stored blocks of the split leaves plus the whole replicated ones)
    and the norm over all blocks: only a norm taken across the shards
    clips."""
    from veles_tpu_torch.ops.optimizers import tree_leaves
    from veles_tpu_torch.parallel.fsdp import slice_block
    from veles_tpu_torch.parallel.mesh import Mesh
    g = whole_grads(wf, ws, batch)
    lays = layout.layouts
    if unit is not None:
        g, lays = g[unit], lays[unit]
    full = float(torch.sqrt(sum((x ** 2).sum() for x in tree_leaves(g))))
    local = []
    sizes = layout.sizes
    for r in range(math.prod(sizes.values())):
        m = Mesh(sizes, r)
        local.append(float(torch.sqrt(sum(
            (slice_block(x, lay.part, m) ** 2).sum()
            for x, lay in zip(tree_leaves(g), tree_leaves(lays))))))
    return (max(local) + full) / 2, max(local), full


def suite_fsdp8(mesh, out_dir, rank):
    """8 ranks, data=2 x fsdp=4: tests/test_parallel.py:74's fc workflow
    under fsdp_rules(min_size=128) (stored shapes, two steps, eval),
    clip norms that only the norm across the shards reaches, a NaN in
    one data rank's rows, the fused 1F1B step over pp2 x fsdp2 x dp2
    with stage arrays over (pipe, None, fsdp), and the trainer's
    snapshot, restore and continued training under
    fsdp_rules(min_size=16) (tests/_multihost_train.py:48-84)."""
    import torch.distributed as dist
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops.optimizers import HyperParams
    from veles_tpu_torch.parallel.mesh import MeshSpec, fsdp_rules, make_mesh
    out = {"coords": dict(mesh.coords)}
    rule = fsdp_rules(min_size=FC_MIN)
    wf, ws, opt = fc_workflow()
    step = wf.make_sharded_train_step(opt, mesh, rule=rule)
    ws = step.place(ws)
    rec = {"stored": stored_shapes(ws), "metrics": []}
    for seed in (9, 10):
        ws, mets = step(ws, tree_t(fc_batch(seed)))
        rec["metrics"].append({k: float(v) for k, v in mets.items()})
    rec["state"] = gathered(step, ws)
    out["fc"] = rec
    # clip norms reached only across the shards: the step's global
    # clip_norm, then a per-unit one on fc1
    for case in ("global", "per_unit"):
        wf, ws, opt = fc_workflow(lr=0.5)
        step = wf.make_sharded_train_step(opt, mesh, rule=rule)
        c, local, full = clip_between(wf, ws, fc_batch(11), step.state,
                                      None if case == "global" else "fc1")
        if case == "global":
            root.common.train.clip_norm = c
        else:
            wf, ws, opt = fc_workflow(lr=0.5, per_unit={
                "fc1": HyperParams(clip_norm=c)})
        try:
            step = wf.make_sharded_train_step(opt, mesh, rule=rule)
        finally:
            root.common.train.clip_norm = 0.0
        ws = step.place(ws)
        ws, mets = step(ws, tree_t(fc_batch(11)))
        out[f"clip_{case}"] = {"clip": c, "local": local, "full": full,
                               "metrics": {k: float(v)
                                           for k, v in mets.items()},
                               "state": gathered(step, ws)}
    # a NaN in data rank 1's rows only: every rank skips the step
    wf, ws, opt = fc_workflow()
    step = wf.make_sharded_train_step(opt, mesh, rule=rule)
    ws = step.place(ws)
    ws, mets = step(ws, tree_t(fc_batch(12, nan_rows=[40])))
    out["nan"] = {"metrics": {k: float(v) for k, v in mets.items()},
                  "state": gathered(step, ws)}
    # the fused 1F1B step, stage arrays over (pipe, None, fsdp)
    pp = make_mesh(MeshSpec(data=2, fsdp=2, pipe=2),
                   timeout_s=GROUP_TIMEOUT_S)
    wf, ws, opt = pp_fsdp_workflow()
    step = wf.make_pipeline_train_step(opt, pp, n_microbatches=2,
                                       rule=pp_fsdp_rule)
    ws = step.place(ws)
    stored = stored_shapes(ws)
    ws, mets = step(ws, tree_t(pp_fsdp_batch()))
    out["pp_fsdp"] = {"stored": stored, "coords": dict(pp.coords),
                      "metrics": {k: float(v) for k, v in mets.items()},
                      "state": gathered(step, ws)}
    out["trainer"] = fsdp_trainer(mesh, out_dir, rank)
    dist.barrier()
    return out


def pp_fsdp_rule(path, shape):
    """tests/test_pipeline_product.py:848-852: the stage axis on pipe,
    the hidden dim on fsdp."""
    if path and path[-1].startswith("stage_"):
        return ("pipe", None, "fsdp")
    return ()


PP_FSDP_LAYERS = [
    {"type": "pipeline_stack", "n_stages": 2, "d_hidden": 64,
     "n_microbatches": 2, "name": "stack"},
    {"type": "softmax", "output_size": 5, "name": "out"}]


def pp_fsdp_workflow():
    from veles_tpu_torch.models.standard import build_workflow
    from veles_tpu_torch.ops.optimizers import SGD
    from veles_tpu_torch.units.base import Spec
    wf = build_workflow("pp_fsdp", PP_FSDP_LAYERS)
    wf.build({"@input": Spec((16, 16), torch.float32),
              "@labels": Spec((16,), torch.int32),
              "@mask": Spec((16,), torch.float32)})
    opt = SGD(0.1)
    return wf, wf.init_state(1, opt, "cpu"), opt


def pp_fsdp_batch():
    rng = np.random.default_rng(13)
    return {"@input": rng.standard_normal((16, 16)).astype(np.float32),
            "@labels": rng.integers(0, 5, 16).astype(np.int32),
            "@mask": np.ones(16, np.float32)}


def mh_data():
    """tests/_multihost_train.py:36-38's task."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((512, 24)).astype(np.float32)
    y = (X[:, :4].sum(1) > 0).astype(np.int32)
    return X, y


def mh_trainer(mesh, rank, world, max_epochs, snap_dir=None):
    from veles_tpu_torch.loader.base import TRAIN, VALID, ArrayLoader
    from veles_tpu_torch.models.standard import build_workflow
    from veles_tpu_torch.ops.optimizers import SGD
    from veles_tpu_torch.parallel.mesh import fsdp_rules
    from veles_tpu_torch.runtime.decision import Decision
    from veles_tpu_torch.runtime.snapshotter import Snapshotter
    from veles_tpu_torch.runtime.trainer import Trainer
    X, y = mh_data()
    loader = ArrayLoader({TRAIN: X[:384], VALID: X[384:]},
                         {TRAIN: y[:384], VALID: y[384:]},
                         minibatch_size=32, shard_index=rank,
                         shard_count=world)
    wf = build_workflow("mh", [
        {"type": "all2all_tanh", "output_size": 16, "name": "fc1"},
        {"type": "softmax", "output_size": 2, "name": "out"}])
    snap = Snapshotter("mh", snap_dir, interval=1) if snap_dir else None
    return Trainer(wf, loader, SGD(0.1, momentum=0.9),
                   Decision(max_epochs=max_epochs), snap, device="cpu",
                   mesh=mesh, rule=fsdp_rules(min_size=16))


def fsdp_trainer(mesh, out_dir, rank):
    """tests/_multihost_train.py:48-84: train 3 epochs with snapshots
    (rank 0 writes the gathered state), restore into a new trainer under
    the same mesh, which keeps its own loader shard and trains on."""
    import torch.distributed as dist
    world = mesh.size
    snaps = os.path.join(str(out_dir), "snaps")
    tr = mh_trainer(mesh, rank, world, 3, snaps)
    tr.initialize(seed=0)
    res = tr.run()
    dist.barrier()                 # rank 0's last snapshot is written
    trained = host_t(tr.sharding.gather_state(tr.wstate)["params"])
    tr2 = mh_trainer(mesh, rank, world, 4)
    tr2.initialize(seed=1)
    tr2.restore(os.path.join(snaps, "mh_current.json"))
    restored = host_t(tr2.sharding.gather_state(tr2.wstate)["params"])
    rec = {"results": {k: v for k, v in res.items()
                       if isinstance(v, (int, float))},
           "stored": stored_shapes(tr.wstate), "trained": trained,
           "restored": restored, "shard": (tr2.loader.shard_index,
                                           tr2.loader.shard_count)}
    rec["results2"] = {k: v for k, v in tr2.run().items()
                       if isinstance(v, (int, float))}
    return rec


SUITES = {"axes8": ("data=2,seq=2,pipe=2", suite_axes8),
          "tp8": ("data=2,fsdp=2,model=2", suite_tp8),
          "fsdp8": ("data=2,fsdp=4", suite_fsdp8),
          "ring4": ("seq=4", suite_ring4),
          "schedules2": ("pipe=2", suite_schedules2),
          "schedules4": ("data=2,pipe=2", suite_schedules4),
          "dp": ("data=2", suite_dp), "hang": ("data=2", suite_hang)}


def main():
    out_dir, rank, world, port, suite = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    sys.path.insert(0, HERE)
    from veles_tpu_torch.parallel.distributed import (initialize_distributed,
                                                      shutdown_distributed)
    from veles_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    timeout = 5.0 if suite == "hang" else GROUP_TIMEOUT_S
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                           timeout_s=timeout)
    spec, fn = SUITES[suite]
    if suite == "hang":
        res = fn(None, out_dir, rank)
        torch.save(res, os.path.join(out_dir, f"{suite}_rank{rank}.pt"))
        os._exit(0)
    mesh = make_mesh(MeshSpec.parse(spec), timeout_s=timeout)
    res = (fn(mesh, out_dir, rank) if suite in ("dp", "fsdp8")
           else fn(mesh))
    torch.save(res, os.path.join(out_dir, f"{suite}_rank{rank}.pt"))
    shutdown_distributed()


if __name__ == "__main__":
    main()

