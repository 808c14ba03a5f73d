#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``veles_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:

1. device: the card's name, capability, and ``nvidia-smi`` name and power
   limit;
2. build: every CUDA kernel of the serving path, from
   ``veles_tpu_torch/csrc`` (one nvcc per source, in parallel);
3. kernels: each kernel against its plain PyTorch version on the card,
   at the serving path's shapes and at edge cases, each max error beside
   its tolerance; then each kernel's time, its plain version's time, the
   time of the one PyTorch call computing the same function (where there
   is one) and the card's bound for the same work;
4. main path: the bench_lm.py transformer LM at full width (vocab 1024,
   dim 512, 4 blocks of 8-head RoPE attention + layer_norm + ffn 2048 +
   layer_norm, per-position head, bf16 compute), random weights from a
   numpy seed in the JAX package's flattened-key layout carried in by
   ``params_from_jax``, served by ``RestfulServer`` over a paged
   ``DecodeEngine`` (8 slots, l_max 1024, page 16, paged kernel on):
   greedy and sampled ``POST /generate`` (prompt 512, 64 new tokens) and
   one ``POST /predict`` (16 x 2048 batch); both kernels' launch counts
   must rise during it; greedy tokens are compared with the port's own
   ``generate()`` (share reported in bf16; in float32 every token must
   agree);
5. the ``kernels`` JSON line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

TF32 is off for every comparison (``torch.backends.cuda.matmul`` and
``cudnn``): float32 products run in full float32.  Without a CUDA card,
or without the ``veles_tpu_torch`` package beside this file, the script
exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import time
import urllib.request

import numpy as np

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak (H100 SXM)
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores
H100_BYTES_S = 3.35e12        # HBM3 bandwidth

FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}   # max |out - plain|
LSE_TOL = 1e-3
PAGED_TOL = 1e-4

VOCAB, E, LAYERS, HEADS, FFN = 1024, 512, 4, 8, 2048
PREDICT_B, PREDICT_T = 16, 2048
SLOTS, L_MAX, PAGE = 8, 1024, 16
PROMPT, NEW = 512, 64
F32_PROMPT, F32_NEW = 64, 16    # the float32 agreement run
DEVICE = "cuda"                # the main path's device


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(obj):
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean milliseconds of ``fn`` on the card (CUDA events).  The stream
    first spins for ~0.1 s so that the host has queued every launch
    before the start event runs: a short kernel is then timed back to
    back, not at the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(flops, peak, nbytes):
    ops_ms = flops / peak * 1e3
    bytes_ms = nbytes / H100_BYTES_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


# -- phase 1 ------------------------------------------------------------------

def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}")
    if not smi:
        fail("nvidia-smi printed nothing")
    say({"phase": "device", "name": name, "capability": list(cap),
         "count": torch.cuda.device_count(), "nvidia_smi": smi[0],
         "torch": torch.__version__, "cuda": torch.version.cuda})
    if tuple(cap) != (9, 0):
        fail(f"the kernels are built for sm_90a; {name} is {cap}")
    return name, smi[0]


# -- phase 2 ------------------------------------------------------------------

def phase_build():
    from veles_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    took = build.build()
    wall = time.perf_counter() - t0
    usage = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in build.build_logs.items()}
    say({"phase": "build", "seconds": round(wall, 3),
         "per_library_s": {k: round(v, 3) for k, v in took.items()},
         "ptxas": usage})


# -- phase 3 ------------------------------------------------------------------

def _flash_case(torch, gen, B, Tq, Tk, H, Hk, D, dtype, causal, window):
    from veles_tpu_torch.ops.kernels import flash_attention as fa
    dev = "cuda"
    q = torch.randn((B, Tq, H, D), generator=gen).to(dev, dtype)
    k = torch.randn((B, Tk, Hk, D), generator=gen).to(dev, dtype)
    v = torch.randn((B, Tk, Hk, D), generator=gen).to(dev, dtype)
    out, lse = fa.flash_attention(q, k, v, causal, None, window)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    lerr = float((lse - ref_lse).abs().max())
    finite = bool(torch.isfinite(out.float()).all())
    return (q, k, v), err, lerr, finite


def _paged_inputs(torch, gen, S, H, Hk, Dh, psz, n_ptab, q_dtype, pos,
                  scratch_tail):
    rows = S * n_ptab + 1
    pk = torch.randn((rows, psz, Hk, Dh), generator=gen).cuda()
    pv = torch.randn((rows, psz, Hk, Dh), generator=gen).cuda()
    ptab = torch.randperm(rows - 1, generator=gen)[:S * n_ptab].reshape(
        S, n_ptab).to(torch.int32)
    if scratch_tail:                   # entries past each span: scratch
        for b, p in enumerate(pos):
            ptab[b, p // psz + 1:] = rows - 1
    q = torch.randn((S, H, Dh), generator=gen).cuda().to(q_dtype)
    return (q, pk, pv, ptab.cuda(),
            torch.as_tensor(pos, dtype=torch.int32).cuda())


def _corrupt_ptab_check(torch, gen, pos):
    """A live page-table entry outside the pool turns its row into NaN in
    the kernel and in the plain version alike; an out-of-range entry past
    a row's span is never read, so that row stays finite."""
    from veles_tpu_torch.ops.kernels import paged_attention as pa
    q, pk, pv, ptab, ppos = _paged_inputs(
        torch, gen, SLOTS, HEADS, HEADS, 64, PAGE, L_MAX // PAGE,
        torch.float32, pos, True)
    rows = pk.shape[0]
    ptab[2, 0] = rows + 5               # row 2 (pos 17): a live page
    ptab[3, -1] = -1                    # row 3 (pos 544): past its span
    out = pa.paged_attention_decode(q, pk, pv, ptab, ppos, page_size=PAGE,
                                    n_kv_heads=HEADS)
    ref = pa.paged_attention_decode_plain(q, pk, pv, ptab, ppos,
                                          page_size=PAGE, n_kv_heads=HEADS)
    torch.cuda.synchronize()
    nan_rows = [int(b) for b in torch.isnan(out).any(-1).any(-1)
                .nonzero().flatten()]
    ref_nan = [int(b) for b in torch.isnan(ref).any(-1).any(-1)
               .nonzero().flatten()]
    keep = [b for b in range(SLOTS) if b != 2]
    err = float((out[keep] - ref[keep]).abs().max())
    ok = (nan_rows == [2] and ref_nan == [2]
          and bool(torch.isnan(out[2]).all()) and err <= PAGED_TOL)
    return {"kernel": pa.NAME, "case": "corrupt_ptab_nan_row",
            "nan_rows": nan_rows, "plain_nan_rows": ref_nan,
            "max_abs_err": err, "tol": PAGED_TOL, "ok": ok}


def phase_kernels(torch):
    from veles_tpu_torch.ops.kernels import flash_attention as fa
    from veles_tpu_torch.ops.kernels import paged_attention as pa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    checks = []
    # flash forward: the /predict shape first, then the edges
    flash = [("main_bf16_causal_T2048", PREDICT_B, PREDICT_T, PREDICT_T,
              HEADS, HEADS, 64, bf16, True, None),
             ("gqa_bf16", 2, 512, 512, 8, 2, 64, bf16, True, None),
             ("window_bf16", 2, 1024, 1024, 8, 8, 64, bf16, True, 256),
             ("ragged_bf16", 3, 1000, 1000, 8, 8, 64, bf16, True, None),
             ("noncausal_cross_bf16", 2, 300, 700, 8, 8, 64, bf16, False,
              None),
             ("f32_causal_gqa_window", 2, 777, 777, 8, 4, 64, f32, True,
              100),
             # head dim 16: configs/induction_lm*.json (E=64, 4 heads)
             ("induction_lm_D16_f32", 4, 128, 128, 4, 4, 16, f32, True,
              None),
             ("induction_lm_D16_bf16", 4, 128, 128, 4, 4, 16, bf16, True,
              None)]
    main_flash = None
    for name, B, Tq, Tk, H, Hk, D, dt, causal, window in flash:
        args, err, lerr, finite = _flash_case(torch, gen, B, Tq, Tk, H, Hk,
                                              D, dt, causal, window)
        tol = FLASH_TOL[str(dt).split(".")[-1]]
        ok = finite and err <= tol and lerr <= LSE_TOL
        checks.append({"kernel": fa.NAME, "case": name,
                       "max_abs_err": err, "tol": tol,
                       "lse_max_abs_err": lerr, "lse_tol": LSE_TOL,
                       "ok": ok})
        say(checks[-1])
        if name.startswith("main"):
            main_flash = (args, err, causal)
    # paged decode: 8 slots at positions around 544 (the serving run's
    # prompt 512 + up to 64 generated), then the edges
    rng = np.random.default_rng(0)
    L = (L_MAX // PAGE) * PAGE
    main_pos = [int(x) for x in PROMPT + rng.integers(0, NEW, SLOTS)]
    edge_pos = [0, L - 1, 17, 544, 300, 700, 15, 16]
    paged = [("main_bf16q_f32pool", HEADS, HEADS, 64, bf16, main_pos, None,
              True),
             ("edges_f32", HEADS, HEADS, 64, f32, edge_pos, None, True),
             ("window_f32", HEADS, HEADS, 64, f32, edge_pos, 100, True),
             ("gqa_f32", HEADS, 2, 64, f32, edge_pos, None, False),
             ("gqa_window_bf16q", HEADS, 2, 64, bf16, edge_pos, 40, True),
             ("induction_lm_D16_f32", 4, 4, 16, f32, edge_pos, None, True),
             ("induction_lm_D16_bf16q", 4, 4, 16, bf16, edge_pos, None,
              True)]
    main_paged = None
    for name, H, Hk, Dh, qdt, pos, window, scratch in paged:
        args = _paged_inputs(torch, gen, SLOTS, H, Hk, Dh, PAGE,
                             L_MAX // PAGE, qdt, pos, scratch)
        out = pa.paged_attention_decode(*args, page_size=PAGE,
                                        n_kv_heads=Hk, window=window)
        ref = pa.paged_attention_decode_plain(*args, page_size=PAGE,
                                              n_kv_heads=Hk, window=window)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = bool(torch.isfinite(out).all()) and err <= PAGED_TOL
        checks.append({"kernel": pa.NAME, "case": name, "max_abs_err": err,
                       "tol": PAGED_TOL, "ok": ok})
        say(checks[-1])
        if name.startswith("main"):
            main_paged = (args, err, pos, H, Hk)
    checks.append(_corrupt_ptab_check(torch, gen, edge_pos))
    say(checks[-1])
    bad = [c for c in checks if not c["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    # timings at the main-path shapes
    import torch.nn.functional as F
    (q, k, v), ferr, causal = main_flash
    B, T, H, D = q.shape
    f_ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, causal))
    f_plain = cuda_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, causal=causal), iters=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    f_lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal))
    pairs = T * (T + 1) // 2 if causal else T * T
    f_flops = 4 * B * H * D * pairs
    f_bytes = 4 * q.numel() * q.element_size() + B * H * T * 4
    f_bound, f_by = bound(f_flops, H100_BF16_FLOPS, f_bytes)

    args, perr, pos, Hp, Hkp = main_paged
    pq, pk_, pv_, ptab, ppos = args
    p_ms = cuda_ms(torch, lambda: pa.paged_attention_decode(
        *args, page_size=PAGE, n_kv_heads=Hkp), iters=50)
    p_plain = cuda_ms(torch, lambda: pa.paged_attention_decode_plain(
        *args, page_size=PAGE, n_kv_heads=Hkp), iters=20)
    live = sum(p + 1 for p in pos)
    live_pages = sum(p // PAGE + 1 for p in pos)
    p_bytes = (2 * live * Hkp * 64 * pk_.element_size()
               + pq.numel() * pq.element_size() + SLOTS * Hp * 64 * 4
               + live_pages * 4 + SLOTS * 4)
    p_flops = 4 * Hp * 64 * live
    p_bound, p_by = bound(p_flops, H100_F32_FLOPS, p_bytes)
    timing = {
        fa.NAME: {"max_abs_err": ferr, "ms": f_ms, "plain_ms": f_plain,
                  "library_ms": f_lib, "bound_ms": f_bound,
                  "bound_by": f_by,
                  "shape": {"B": B, "T": T, "H": H, "D": D,
                            "dtype": "bfloat16", "causal": causal}},
        pa.NAME: {"max_abs_err": perr, "ms": p_ms, "plain_ms": p_plain,
                  "library_ms": None, "bound_ms": p_bound,
                  "bound_by": p_by,
                  "shape": {"S": SLOTS, "H": Hp, "Hk": Hkp, "Dh": 64,
                            "page_size": PAGE, "n_ptab": L_MAX // PAGE,
                            "q": "bfloat16", "pool": "float32",
                            "mean_pos": float(np.mean(pos))}},
    }
    say({"phase": "kernel_timing", **timing})
    return timing


# -- phase 4 ------------------------------------------------------------------

def bench_layers():
    layers = [{"type": "embedding", "vocab": VOCAB, "dim": E,
               "name": "emb"}]
    for i in range(LAYERS):
        layers += [
            {"type": "attention", "n_heads": HEADS, "rope": True,
             "residual": True, "name": f"attn{i}"},
            {"type": "layer_norm", "name": f"ln{i}a"},
            {"type": "ffn", "d_hidden": FFN, "name": f"ffn{i}"},
            {"type": "layer_norm", "name": f"ln{i}b"},
        ]
    layers.append({"type": "all2all", "output_size": VOCAB,
                   "per_position": True, "name": "head"})
    return layers


def jax_layout_weights(wf, seed):
    """Random weights as the JAX package lays them out: a flat
    ``"unit/param"`` dict of (in, out) float32 arrays, uniform in
    +-1/sqrt(fan_in) (the package's smart init), unit scale and zero
    shift/bias."""
    rng = np.random.default_rng(seed)
    flat = {}
    for unit, params in wf.param_shapes().items():
        for name, shape in params.items():
            if name == "scale":
                a = np.ones(shape, np.float32)
            elif name in ("b", "b1", "b2", "shift"):
                a = np.zeros(shape, np.float32)
            else:
                lim = 1.0 / np.sqrt(shape[0])
                a = rng.uniform(-lim, lim, shape).astype(np.float32)
            flat[f"{unit}/{name}"] = a
    return flat


def _post(port, path, body, timeout=900):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.status != 200:
            fail(f"{path} answered {r.status}")
        return json.loads(r.read())


def _workflow(torch, compute_dtype):
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.units.base import Spec
    sw = StandardWorkflow({"name": "bench_lm", "layers": bench_layers(),
                           "compute_dtype": compute_dtype,
                           "optimizer": "adam",
                           "optimizer_args": {"lr": 1e-3}})
    wf = sw.workflow
    wf.build({"@input": Spec((PREDICT_B, PREDICT_T), torch.int32),
              "@labels": Spec((PREDICT_B, PREDICT_T), torch.int32),
              "@mask": Spec((PREDICT_B,), torch.float32)})
    return wf


def phase_main_path(torch):
    from veles_tpu_torch.ops.kernels import KERNELS
    from veles_tpu_torch.runtime.engine import DecodeEngine
    from veles_tpu_torch.runtime.generate import generate
    from veles_tpu_torch.runtime.restful import RestfulServer
    from veles_tpu_torch.runtime.snapshotter import params_from_jax
    from veles_tpu_torch.units.workflow import new_state

    wf = _workflow(torch, "bfloat16")
    flat = jax_layout_weights(wf, seed=0)
    wstate = new_state(params_from_jax(flat, wf, device=DEVICE), {}, {}, 0,
                       None)
    engine = DecodeEngine(wf, wstate, slots=SLOTS, l_max=L_MAX,
                          page_size=PAGE, paged=True, paged_kernel=True,
                          window_ms=2.0, device=DEVICE).start()
    srv = RestfulServer(wf.make_predict_step(), wstate, PREDICT_B,
                        (PREDICT_T,), port=0, workflow=wf, engine=engine,
                        device=DEVICE).start()
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, VOCAB, (SLOTS, PROMPT)).astype(np.int32)
    try:
        for kern in KERNELS:
            kern.launches.reset()
        t0 = time.perf_counter()
        greedy = np.asarray(_post(srv.port, "/generate", {
            "prompt": prompts.tolist(), "steps": NEW})["tokens"])
        t_greedy = time.perf_counter() - t0
        stats_greedy = engine.stats()
        sampled = np.asarray(_post(srv.port, "/generate", {
            "prompt": prompts[:1].tolist(), "steps": NEW,
            "temperature": 0.8, "top_k": 50, "top_p": 0.95,
            "seed": 1})["tokens"])
        row = rng.integers(0, VOCAB, (1, PREDICT_T)).astype(np.int32)
        t0 = time.perf_counter()
        logits = np.asarray(_post(srv.port, "/predict", {
            "input": row.tolist()})["output"], np.float32)
        t_predict = time.perf_counter() - t0
        launches = {k.NAME: k.launches.count for k in KERNELS}
        stats = engine.stats()
        profile = phase_profile(torch, engine, prompts)
    finally:
        srv.stop()
        engine.stop()
    say({"phase": "http", "requests": {"sent": 3, "ok": 3, "failed": 0},
         "launches": launches, "greedy_request_s": t_greedy,
         "predict_request_s": t_predict, "engine": stats})
    say({"phase": "profile", **profile})

    if greedy.shape != (SLOTS, PROMPT + NEW) \
            or sampled.shape != (1, PROMPT + NEW):
        fail(f"generate shapes {greedy.shape} / {sampled.shape}")
    for toks, src in ((greedy, prompts), (sampled, prompts[:1])):
        if not np.array_equal(toks[:, :PROMPT], src):
            fail("generated rows do not start with their prompts")
        if toks.min() < 0 or toks.max() >= VOCAB:
            fail("generated token out of range")
    if logits.shape != (1, PREDICT_T, VOCAB) \
            or not np.isfinite(logits).all():
        fail(f"/predict logits shape {logits.shape} or not finite")
    missing = [n for n, c in launches.items() if c < 1]
    if missing:
        fail(f"the main path never launched {missing}")

    # greedy agreement with the port's own generate() (dense cache, no
    # kernel), bf16 model: reported
    ref = generate(wf, wstate, prompts, NEW).cpu().numpy()
    bf16_share = float(np.mean(ref[:, PROMPT:] == greedy[:, PROMPT:]))
    # float32 model on the same weights: engine (paged kernel) vs
    # generate() on a shorter prompt, must agree
    wf32 = _workflow(torch, None)
    ws32 = new_state(params_from_jax(flat, wf32, device=DEVICE), {}, {}, 0,
                     None)
    eng32 = DecodeEngine(wf32, ws32, slots=SLOTS, l_max=L_MAX,
                         page_size=PAGE, paged=True, paged_kernel=True,
                         window_ms=0.0, device=DEVICE).start()
    short = prompts[:, :F32_PROMPT]
    try:
        e32 = eng32.generate(short, F32_NEW, timeout=900)
    finally:
        eng32.stop()
    g32 = generate(wf32, ws32, short, F32_NEW).cpu().numpy()
    f32_share = float(np.mean(e32[:, F32_PROMPT:] == g32[:, F32_PROMPT:]))
    differ = np.argwhere(e32[:, F32_PROMPT:] != g32[:, F32_PROMPT:])
    agreement = {"bf16_engine_vs_generate_share": bf16_share,
                 "f32_engine_vs_generate_share": f32_share,
                 "bf16_prompt": PROMPT, "bf16_new": NEW,
                 "f32_prompt": F32_PROMPT, "f32_new": F32_NEW}
    say({"phase": "agreement", **agreement})
    if len(differ):
        r, t = (int(x) for x in differ[0])
        fail(f"float32 engine and generate() disagree at row {r}, "
             f"generated position {t} (engine {int(e32[r, F32_PROMPT + t])}"
             f", generate() {int(g32[r, F32_PROMPT + t])}): {agreement}")
    # the greedy request alone: SLOTS prompts prefilled one after
    # another, then every slot decoding together (full occupancy)
    say({"phase": "serving_metrics",
         "slots": SLOTS,
         "decode_tokens_per_s_all_slots":
             stats_greedy["decode_tokens_per_s"],
         "decode_step_s_p50": stats_greedy["decode_step_s_p50"],
         "decode_step_s_max": stats_greedy["decode_step_s_max"],
         "ttft_s_mean": stats_greedy["ttft_s_mean"],
         "ttft_s_max": stats_greedy["ttft_s_max"],
         "prefill_tokens_per_s": (stats_greedy["prefill_tokens"]
                                  / max(t_greedy - stats_greedy[
                                      "decode_seconds"], 1e-9)),
         "request_tokens_per_s": SLOTS * NEW / t_greedy})
    return launches


def phase_profile(torch, engine, prompts):
    """Device busy time by kernel over one serving window (SLOTS prompts
    of 64 tokens prefilled, 32 tokens decoded), from torch.profiler; the
    idle share is 1 - busy / wall.  Reports null when the profiler saw
    no device activity."""
    from torch.profiler import ProfilerActivity, profile
    short = prompts[:, :64]
    acts = [ProfilerActivity.CPU]
    if DEVICE == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.generate(short, 32, timeout=900)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = {}
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        t = (getattr(evt, "self_device_time_total", None)
             or getattr(evt, "self_cuda_time_total", 0) or 0)
        if t > 0:
            busy[evt.key] = busy.get(evt.key, 0.0) + t / 1e6
    total = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
    return {"window": f"{SLOTS} x (prefill 64 + decode 32)", "wall_s": wall,
            "device_busy_s": total if busy else None,
            "device_idle_share": (1.0 - total / wall) if busy else None,
            "top_kernels_s": [[k[:90], v] for k, v in top]}


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    try:
        import veles_tpu_torch  # noqa: F401
        from veles_tpu_torch.ops.kernels import KERNELS
    except ImportError as e:
        fail(f"the veles_tpu_torch package is not beside chip_smoke.py "
             f"({e})")
    t_start = time.perf_counter()
    name, smi = phase_device(torch)
    phase_build()
    timing = phase_kernels(torch)
    launches = phase_main_path(torch)
    line = []
    for kern in KERNELS:
        t = timing[kern.NAME]
        line.append({"name": kern.NAME, "route": "cuda",
                     "source": kern.SOURCE, "replaces": kern.REPLACES,
                     "launches": launches[kern.NAME],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    say({"phase": "done", "seconds": time.perf_counter() - t_start})
    say({"kernels": line})
    say(smi)
    say({"ok": True, "device": {"platform": "gpu", "kind": name,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
