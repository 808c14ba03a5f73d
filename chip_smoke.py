#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``veles_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:

1. device: the card's name, capability, and ``nvidia-smi`` name and power
   limit;
2. build: every CUDA kernel of the port, from ``veles_tpu_torch/csrc``
   (one nvcc per source, all in parallel), with each source's seconds and
   ptxas registers and spills;
3. kernels: each kernel against its plain PyTorch version on the card,
   at its path's shapes and at edge cases (for the flash kernels, the
   variant launched: tensor cores for bf16, SIMT for float32; for paged
   decode, the edges of its per-row split across a cluster of blocks, a
   corrupt page-table entry, and two runs bitwise equal),
   each error beside its tolerance (the flash backward element by
   element, see BWD_UNITS); then each kernel's time, its plain version's
   time, the time of the one PyTorch call computing the same function
   (where there is one) and the card's bound for the same work (paged
   decode also with a cold L2, 128 MiB written before each launch);
4. serving path: the bench_lm.py transformer LM at full width (vocab
   1024, dim 512, 4 blocks of 8-head RoPE attention + layer_norm + ffn
   2048 + layer_norm, per-position head, bf16 compute), random weights
   from a numpy seed in the JAX package's flattened-key layout carried in
   by ``params_from_jax``, served by ``RestfulServer`` over a paged
   ``DecodeEngine`` (8 slots, l_max 1024, page 16, paged kernel on):
   greedy and sampled ``POST /generate`` (prompt 512, 64 new tokens) and
   one ``POST /predict`` (16 x 2048 batch); the flash-forward and paged
   kernels' launch counts must rise during it, paged decode exactly once
   per layer per decode step; greedy tokens are compared
   with the port's own ``generate()`` (share reported in bf16; in float32
   every token must agree);
5. training path, full width: the same LM (bf16) trained through
   ``StandardWorkflow.make_trainer`` -> ``Trainer`` for one epoch (32
   steps of 16 x 2048 tokens, Adam lr 1e-3) and its eval, fed by an
   ``InductionLoader(per_position=True, seq_len=2048, vocab=1024)`` held
   on the card; the flash forward, both flash backward and the gather
   kernels must launch, every bf16 flash launch (forward, dQ, dK/dV) on
   the tensor-core variant, and every loss must be finite; then 8 steps on one
   fixed batch must cut its loss by 5 % (the epoch's own loss stays near
   chance, see ``_fixed_batch_descent``); step times, tokens/s and a
   torch.profiler window of 3 steps (device idle share, top kernels);
   then one float32 train step through the kernels and one
   through the plain versions from the same weights and batch, loss and
   per-parameter gradient norms compared; then the same bf16 epoch again
   with every kernel of the path replaced by its plain version, whose
   per-step losses must follow the kernels' (``_plain_epoch_witness``);
6. image kernels: fused dropout (AlexNet's drop6/drop7 shape, 512 x
   4096 float32, and the edges; forward and gradient) and mean/disp
   normalize (norm0's shape, 512 x 227 x 227 x 3, uint8 and float32)
   against their plain versions, bitwise, then their times and bounds;
7. image path, full width: ``alexnet_e2e_device_workflow`` (bf16
   compute, momentum SGD with l2) trained through
   ``StandardWorkflow.make_trainer`` -> ``Trainer`` for one epoch (8
   steps of 512) and its eval, from a 4096 + 512 image uint8 store held
   on the card (random crop 227 and mirror there); mean/disp must launch
   at least 9 times and dropout 32 (2 forward + 2 backward per step),
   every loss must be finite; step times, samples/s and a torch.profiler
   window of 3 steps; one float32 step through the kernels and one
   through the plain versions from the same weights, batch and key
   (cuDNN deterministic, TF32 off), loss, gradient norms and the drop6/
   drop7 masks compared; one ``make_predict_step("fc8")`` batch;
8. quality: ``python -m veles_tpu_torch configs/induction_lm.json
   --random-seed 1`` as a subprocess on the card (25 epochs) must reach
   <= 5 % validation error;
9. the ``kernels`` JSON line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

TF32 is off for every comparison (``torch.backends.cuda.matmul`` and
``cudnn``): float32 products run in full float32.  Without a CUDA card,
or without the ``veles_tpu_torch`` package beside this file, the script
exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time
import urllib.request
from unittest import mock

import numpy as np

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak (H100 SXM)
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores
H100_BYTES_S = 3.35e12        # HBM3 bandwidth

FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}   # max |out - plain|
LSE_TOL = 1e-3
PAGED_TOL = 1e-4
# flash backward, held element by element: |kernel - plain| <= BWD_UNITS
# units u of the dtype (bf16 2^-8, f32 2^-24) times (|plain| + its row's
# scale), the row being the D entries of one position and head and its
# scale the row's largest |plain|, or the median |plain| of the whole
# gradient where that is larger.  One bf16 rounding step of an output is
# at most one unit, so in bfloat16 (dS, P and the outputs rounded at the
# same points on both sides) each entry is held to two roundings of its
# own row's size.  The median floor serves the rows whose exact gradient
# cancels to about 0 (query 0 of a causal row attends one key, so its
# dS = P (dP - delta) is rounding noise on both sides).  In float32 the
# units (1024 u ~ 6e-5) cover the summation order over up to 2048 keys
# and the cancellation in dP - delta, which leaves a small dQ entry with
# a larger share of rounding.  A gradient whose exact value is 0 (dQ and
# dK at causal Tq = Tk = 1) has no size of its own: it is held to
# BWD_UNITS units of the terms that cancel (see _bwd_case).
BWD_UNIT = {"bfloat16": 2.0 ** -8, "float32": 2.0 ** -24}
BWD_UNITS = {"bfloat16": 2.0, "float32": 1024.0}
# full-width float32 train step, kernels vs plain versions: relative
# difference of the loss and of each parameter's gradient norm
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3
# the fixed-batch descent after the epoch: FIXED_STEPS steps on one batch
# must cut its loss by at least FIXED_MIN_DROP of the first step's
FIXED_STEPS, FIXED_MIN_DROP = 8, 0.05
# the epoch through the plain versions: per-step |loss - kernels' loss|
WITNESS_ATOL = 0.05
QUALITY_BAR = 5.0               # % validation error, configs/induction_lm
# the image path: AlexNet e2e (bench.py's timed_e2e) at minibatch 512
IMG_B, IMG_TRAIN, IMG_VALID = 512, 4096, 512
DROP_ROWS, DROP_COLS, DROP_RATE = 512, 4096, 0.5    # drop6/drop7
IMG_MIN_LAUNCHES = {"mean_disp_normalize": 9, "fused_dropout": 32}

VOCAB, E, LAYERS, HEADS, FFN = 1024, 512, 4, 8, 2048
PREDICT_B, PREDICT_T = 16, 2048
TRAIN_B, TRAIN_T, N_TRAIN, N_VALID = 16, 2048, 512, 64
GATHER_ROWS = 512               # int32 token rows held for the gather check
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


def cold_l2_ms(torch, fn, iters=20, flush_bytes=128 << 20):
    """Mean milliseconds of ``fn`` alone with a cold L2: before each
    launch the stream writes ``flush_bytes`` (2.5x the 50 MB L2) to a
    scratch buffer, and a pair of CUDA events brackets ``fn`` only.  As
    in :func:`cuda_ms`, the stream spins first so that the host has
    queued every launch before the first event runs."""
    scratch = torch.empty(flush_bytes // 4, dtype=torch.float32,
                          device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)
    for t0, t1 in events:
        scratch.fill_(1.0)
        t0.record()
        fn()
        t1.record()
    torch.cuda.synchronize()
    return sum(t0.elapsed_time(t1) for t0, t1 in events) / iters


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

def ptxas_usage(log):
    """Registers and spill bytes of each kernel instance in an nvcc -Xptxas
    -v log, keyed by its name as the toolkit's ``cu++filt -p`` demangles
    it: {"void (anonymous namespace)::flash_fwd_tc<64>": {"registers": 108,
    "spill_stores": 0, "spill_loads": 0}, ...}."""
    import re
    from veles_tpu_torch.ops.kernels import build
    usage, name, spill = {}, None, (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            usage[name] = {"registers": int(m.group(1)),
                           "spill_stores": spill[0], "spill_loads": spill[1]}
            name, spill = None, (0, 0)
    if not usage:
        return usage
    filt = os.path.join(os.path.dirname(build.nvcc_path()), "cu++filt")
    names = subprocess.run([filt, "-p"], input="\n".join(usage),
                           capture_output=True, text=True, timeout=60,
                           check=True).stdout.splitlines()
    return dict(zip(names, usage.values()))


def phase_build():
    from veles_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    took = build.build()
    wall = time.perf_counter() - t0
    usage = {n: ptxas_usage(log) for n, log in build.build_logs.items()}
    say({"phase": "build", "seconds": round(wall, 3),
         "per_library_s": {k: round(v, 3) for k, v in took.items()},
         "ptxas": usage})
    return {"seconds": wall, "per_library_s": took, "ptxas": usage}


# -- phase 3 ------------------------------------------------------------------

def _flash_case(torch, gen, B, Tq, Tk, H, Hk, D, dtype, causal, window):
    from veles_tpu_torch.ops.kernels import flash_attention as fa
    dev = "cuda"
    q = torch.randn((B, Tq, H, D), generator=gen).to(dev, dtype)
    k = torch.randn((B, Tk, Hk, D), generator=gen).to(dev, dtype)
    v = torch.randn((B, Tk, Hk, D), generator=gen).to(dev, dtype)
    before = fa.launches.by_variant()
    out, lse = fa.flash_attention(q, k, v, causal, None, window)
    ran = _variant_delta(before, fa.launches.by_variant())
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    lerr = float((lse - ref_lse).abs().max())
    finite = bool(torch.isfinite(out.float()).all())
    return (q, k, v), err, lerr, finite, ran


def _variant_delta(before, after):
    """The variants launched between two ``launches.by_variant()``."""
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def expected_variant(dtype):
    """A flash kernel's variant for a dtype: the tensor-core kernels take
    bf16, the SIMT kernels float32."""
    return {"tc": 1} if str(dtype).endswith("bfloat16") else {"simt": 1}


def _instance_usage(*libs):
    """ptxas registers and spills of every kernel instance of the
    libraries (from this run's build log)."""
    from veles_tpu_torch.ops.kernels import build
    return {k: v for lib in libs
            for k, v in ptxas_usage(build.build_logs.get(lib, "")).items()}


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
    the kernel and in the plain version alike, whichever block of the
    row's split reads it; an out-of-range entry past a row's span is
    never read, so that row stays finite."""
    from veles_tpu_torch.ops.kernels import paged_attention as pa
    q, pk, pv, ptab, ppos = _paged_inputs(
        torch, gen, SLOTS, HEADS, HEADS, 64, PAGE, L_MAX // PAGE,
        torch.float32, pos, True)
    rows = pk.shape[0]
    ptab[1, 60] = rows + 7              # row 1 (pos L-1): the last split
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
    keep = [b for b in range(SLOTS) if b not in (1, 2)]
    err = float((out[keep] - ref[keep]).abs().max())
    ok = (nan_rows == [1, 2] and ref_nan == [1, 2]
          and bool(torch.isnan(out[1:3]).all()) and err <= PAGED_TOL)
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
    # flash forward: the /predict shape first, then the edges (bf16 on
    # the tensor-core kernel, whose tiles are 128 rows by 64 keys)
    flash = [("main_bf16_causal_T2048", PREDICT_B, PREDICT_T, PREDICT_T,
              HEADS, HEADS, 64, bf16, True, None),
             ("gqa_bf16", 2, 512, 512, 8, 2, 64, bf16, True, None),
             ("gqa2_bf16", 2, 300, 300, 8, 4, 64, bf16, True, None),
             ("window_bf16", 2, 1024, 1024, 8, 8, 64, bf16, True, 256),
             ("window_below_tile_bf16", 2, 400, 400, 8, 8, 64, bf16, True,
              50),
             ("ragged_bf16", 3, 1000, 1000, 8, 8, 64, bf16, True, None),
             ("T1_bf16", 2, 1, 1, 8, 8, 64, bf16, True, None),
             ("T63_bf16", 2, 63, 63, 8, 8, 64, bf16, True, None),
             ("T65_bf16", 2, 65, 65, 8, 8, 64, bf16, True, None),
             ("T129_bf16", 2, 129, 129, 8, 8, 64, bf16, True, None),
             ("noncausal_cross_bf16", 2, 300, 700, 8, 8, 64, bf16, False,
              None),
             ("cross_Tk_below_tile_bf16", 2, 200, 40, 8, 8, 64, bf16, False,
              None),
             # rows 164.. see no key (causal, window 64, Tq > Tk)
             ("rows_without_keys_bf16", 2, 300, 100, 8, 8, 64, bf16, True,
              64),
             ("f32_causal_gqa_window", 2, 777, 777, 8, 4, 64, f32, True,
              100),
             # head dim 16: configs/induction_lm*.json (E=64, 4 heads)
             ("induction_lm_D16_f32", 4, 128, 128, 4, 4, 16, f32, True,
              None),
             ("induction_lm_D16_bf16", 4, 128, 128, 4, 4, 16, bf16, True,
              None),
             ("D16_bf16_T2048", 4, 2048, 2048, 4, 4, 16, bf16, True, None)]
    main_flash = None
    for name, B, Tq, Tk, H, Hk, D, dt, causal, window in flash:
        args, err, lerr, finite, ran = _flash_case(
            torch, gen, B, Tq, Tk, H, Hk, D, dt, causal, window)
        tol = FLASH_TOL[str(dt).split(".")[-1]]
        ok = (finite and err <= tol and lerr <= LSE_TOL
              and ran == expected_variant(dt))
        checks.append({"kernel": fa.NAME, "case": name, "variant": ran,
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
    split_pos = [127, 128, 255, 256, 511, 512, L - 1, L - 15]
    paged = [("main_bf16q_f32pool", HEADS, HEADS, 64, bf16, main_pos, None,
              True),
             ("edges_f32", HEADS, HEADS, 64, f32, edge_pos, None, True),
             ("window_f32", HEADS, HEADS, 64, f32, edge_pos, 100, True),
             ("gqa_f32", HEADS, 2, 64, f32, edge_pos, None, False),
             ("gqa_window_bf16q", HEADS, 2, 64, bf16, edge_pos, 40, True),
             # the edges of the kernel's split (8 blocks a row, 8 pages of
             # 16 a block at pos L-1)
             ("split_edges_f32", HEADS, HEADS, 64, f32, split_pos, None,
              True),
             ("window_across_splits_f32", HEADS, HEADS, 64, f32, edge_pos,
              200, True),
             ("window_1_f32", HEADS, HEADS, 64, f32, edge_pos, 1, True),
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
    # fixed splits merged in rank order: two runs give the same bits
    args = main_paged[0]
    twice = [pa.paged_attention_decode(*args, page_size=PAGE,
                                       n_kv_heads=main_paged[4])
             for _ in range(2)]
    same = bool(torch.equal(*twice))
    checks.append({"kernel": pa.NAME, "case": "main_two_runs_bitwise",
                   "equal": same, "ok": same})
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
    p_cold = cold_l2_ms(torch, lambda: pa.paged_attention_decode(
        *args, page_size=PAGE, n_kv_heads=Hkp))
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
                  "bound_by": f_by, "variant": "tc",
                  "source": fa.SOURCES["tc"],
                  "tflops": f_flops / f_ms / 1e9,
                  "bound_share": f_bound / f_ms,
                  "ptxas": _instance_usage("flash_fwd_tc", "flash_fwd"),
                  "shape": {"B": B, "T": T, "H": H, "D": D,
                            "dtype": "bfloat16", "causal": causal}},
        pa.NAME: {"max_abs_err": perr, "ms": p_ms, "plain_ms": p_plain,
                  "library_ms": None, "bound_ms": p_bound,
                  "bound_by": p_by, "cold_l2_ms": p_cold,
                  "bound_share": p_bound / p_cold,
                  "gb_per_s_cold": p_bytes / p_cold / 1e6,
                  "ptxas": _instance_usage("paged_attention"),
                  "shape": {"S": SLOTS, "H": Hp, "Hk": Hkp, "Dh": 64,
                            "page_size": PAGE, "n_ptab": L_MAX // PAGE,
                            "q": "bfloat16", "pool": "float32",
                            "mean_pos": float(np.mean(pos))}},
    }
    say({"phase": "kernel_timing", **timing})
    return timing


def _bwd_case(torch, gen, B, Tq, Tk, H, Hk, D, dtype, causal, window):
    """Both backward kernels and their plain versions on one input:
    dO random, lse from the forward kernel, delta = rowsum(dO * O)."""
    from veles_tpu_torch.ops.kernels import flash_attention as fa
    from veles_tpu_torch.ops.kernels import flash_bwd_dkv as dkv
    from veles_tpu_torch.ops.kernels import flash_bwd_dq as dq
    q, k, v, do = (torch.randn(shape, generator=gen).to("cuda", dtype)
                   for shape in ((B, Tq, H, D), (B, Tk, Hk, D),
                                 (B, Tk, Hk, D), (B, Tq, H, D)))
    out, lse = fa.flash_attention(q, k, v, causal, None, window)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    kw = dict(causal=causal, scale=D ** -0.5, window=window)
    before_dq = dq.launches.by_variant()
    got = {"dq": dq.flash_bwd_dq(*args, **kw)}
    ran_dq = _variant_delta(before_dq, dq.launches.by_variant())
    before = dkv.launches.by_variant()
    got["dk"], got["dv"] = dkv.flash_bwd_dkv(*args, **kw)
    ran = _variant_delta(before, dkv.launches.by_variant())
    ref = {"dq": dq.flash_bwd_dq_plain(*args, **kw)}
    ref["dk"], ref["dv"] = dkv.flash_bwd_dkv_plain(*args, **kw)
    torch.cuda.synchronize()
    # causal Tq = Tk = 1: P = 1 and dP = delta, so the exact dQ and dK are
    # 0 and each side holds only its own rounding of dP - delta: those two
    # are held in units of the terms that cancel, |dO| |V| scale times |K|
    # (dQ) or |Q| (dK)
    zero = {}
    if causal and Tq == Tk == 1:
        terms = float(do.float().abs().max() * v.float().abs().max()) \
            * kw["scale"]
        zero = {"dq": terms * float(k.float().abs().max()),
                "dk": terms * float(q.float().abs().max())}
    res = {name: bwd_agreement(torch, got[name], ref[name], zero.get(name))
           for name in ("dq", "dk", "dv")}
    res["variant"] = {dq.NAME: ran_dq, dkv.NAME: ran}
    return args, kw, res


def bwd_agreement(torch, got, ref, zero_terms=None):
    """The flash backward rule (BWD_UNITS above): the worst entry's
    |kernel - plain| in units u * (|plain| + its row's scale), or, for a
    gradient whose exact value is 0, in units u * ``zero_terms`` (the size
    of the terms that cancel); beside the limit, the largest absolute
    error, the relative Frobenius error and the median |plain| (the size
    of a typical entry)."""
    dt = str(ref.dtype).split(".")[-1]
    a, b = got.float(), ref.float()
    err = (a - b).abs()
    mag = b.abs()
    median = mag.flatten().median()
    row = torch.maximum(mag.amax(-1, keepdim=True), median)
    scale = BWD_UNIT[dt] * (mag + row)
    units = torch.where(scale > 0, err / scale.clamp_min(1e-38),
                        torch.where(err > 0, float("inf"), 0.0))
    if zero_terms is not None:
        units = err / (BWD_UNIT[dt] * zero_terms)
    return {"units": float(units.max()), "units_tol": BWD_UNITS[dt],
            "max_abs_err": float(err.max()),
            "frob_rel_err": float(torch.linalg.vector_norm(a - b)
                                  / torch.linalg.vector_norm(b)
                                  .clamp_min(1e-38)),
            "median_abs_plain": float(median),
            "finite": bool(torch.isfinite(a).all()),
            "dtype_ok": got.dtype == ref.dtype}


def phase_train_kernels(torch):
    """The training path's kernels (flash backward dQ and dK/dV, the row
    gather) against their plain versions, then their times and bounds at
    the training path's shapes."""
    from veles_tpu_torch.ops.kernels import flash_bwd_dkv as dkv
    from veles_tpu_torch.ops.kernels import flash_bwd_dq as dq
    from veles_tpu_torch.ops.kernels import gather_rows as gr
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("main_bf16_causal_T2048", TRAIN_B, TRAIN_T, TRAIN_T, HEADS,
              HEADS, 64, bf16, True, None),
             # configs/induction_lm.json: B=100, T=32, 4 heads of 16
             ("induction_lm_D16_f32", 100, 32, 32, 4, 4, 16, f32, True,
              None),
             ("gqa2_bf16", 2, 512, 512, 8, 4, 64, bf16, True, None),
             ("window_f32", 2, 777, 777, 8, 8, 64, f32, True, 100),
             ("gqa2_window_bf16_D16", 2, 300, 300, 4, 2, 16, bf16, True,
              50),
             ("noncausal_cross_bf16", 2, 300, 700, 8, 8, 64, bf16, False,
              None),
             ("ragged_f32", 3, 1000, 1000, 8, 8, 64, f32, True, None),
             # edges of the tensor-core dQ's and dK/dV's tiles (64 query
             # rows by 64 keys); at T=1 the exact dQ and dK are 0 (see
             # _bwd_case)
             ("T1_bf16", 2, 1, 1, 8, 8, 64, bf16, True, None),
             ("Tq1_Tk65_bf16", 2, 1, 65, 8, 8, 64, bf16, False, None),
             ("T63_bf16", 2, 63, 63, 8, 8, 64, bf16, True, None),
             ("T65_bf16", 2, 65, 65, 8, 8, 64, bf16, True, None),
             ("T129_bf16", 2, 129, 129, 8, 8, 64, bf16, True, None),
             ("cross_Tk_below_tile_bf16", 2, 200, 40, 8, 8, 64, bf16, False,
              None),
             ("gqa4_bf16", 2, 300, 300, 8, 2, 64, bf16, True, None),
             ("window_below_tile_bf16", 2, 400, 400, 8, 8, 64, bf16, True,
              50),
             ("rows_without_keys_bf16", 2, 300, 100, 8, 8, 64, bf16, True,
              64),
             ("D16_bf16_T2048", 2, 2048, 2048, 4, 4, 16, bf16, True, None)]
    checks, main = [], None
    for name, B, Tq, Tk, H, Hk, D, dt, causal, window in cases:
        args, kw, res = _bwd_case(torch, gen, B, Tq, Tk, H, Hk, D, dt,
                                  causal, window)
        for kname, grads in ((dq.NAME, ("dq",)), (dkv.NAME, ("dk", "dv"))):
            rec = {"kernel": kname, "case": name,
                   "variant": res["variant"][kname]}
            ok = res["variant"][kname] == expected_variant(dt)
            for g in grads:
                r = res[g]
                rec[g] = {k: r[k] for k in ("units", "units_tol",
                                            "max_abs_err", "frob_rel_err",
                                            "median_abs_plain")}
                ok = ok and r["finite"] and r["dtype_ok"] \
                    and r["units"] <= r["units_tol"]
            rec["ok"] = ok
            checks.append(rec)
            say(rec)
        if name.startswith("main"):
            main = (args, kw, res)
    # no float atomics: two backward runs at full width give the same bits
    args, kw, _ = main
    first = (dq.flash_bwd_dq(*args, **kw),) + dkv.flash_bwd_dkv(*args, **kw)
    second = (dq.flash_bwd_dq(*args, **kw),) + dkv.flash_bwd_dkv(*args, **kw)
    same = [bool(torch.equal(a, b)) for a, b in zip(first, second)]
    checks.append({"kernel": dkv.NAME, "case": "main_two_runs_bitwise",
                   "dq_dk_dv_equal": same, "ok": all(same)})
    say(checks[-1])
    del first, second
    # gather: the training minibatch (16 rows of 2048 int32 tokens from a
    # card-resident set) and an odd row size (21 bytes)
    rng = np.random.default_rng(3)
    tokens = torch.randint(0, VOCAB, (GATHER_ROWS, TRAIN_T),
                           dtype=torch.int32, generator=gen).cuda()
    idx = rng.integers(0, GATHER_ROWS, TRAIN_B)
    odd = torch.randint(0, 256, (101, 3, 7), dtype=torch.uint8,
                        generator=gen).cuda()
    odd_idx = rng.integers(0, 101, 37)
    for name, data, ix in (("main_int32_16x2048", tokens, idx),
                           ("odd_uint8_21_bytes", odd, odd_idx)):
        out = gr.gather_rows(data, ix)
        ref = gr.gather_rows_plain(data, torch.from_numpy(ix).cuda())
        torch.cuda.synchronize()
        same = bool(torch.equal(out, ref)) and out.is_contiguous()
        checks.append({"kernel": gr.NAME, "case": name, "bitwise": same,
                       "max_abs_err": 0.0 if same else None, "tol": 0.0,
                       "ok": same})
        say(checks[-1])
    try:
        gr.gather_rows(tokens, np.asarray([0, GATHER_ROWS]))
        refused = False
    except IndexError:
        refused = True
    checks.append({"kernel": gr.NAME, "case": "index_out_of_range_raises",
                   "ok": refused})
    say(checks[-1])
    bad = [c for c in checks if not c["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    # timings at the training path's shapes
    import torch.nn.functional as F
    args, kw, res = main
    q, k, v, do, lse, delta = args
    B, T, H, D = q.shape
    dq_ms = cuda_ms(torch, lambda: dq.flash_bwd_dq(*args, **kw))
    dkv_ms = cuda_ms(torch, lambda: dkv.flash_bwd_dkv(*args, **kw))
    dq_plain = cuda_ms(torch, lambda: dq.flash_bwd_dq_plain(*args, **kw),
                       iters=5)
    dkv_plain = cuda_ms(torch, lambda: dkv.flash_bwd_dkv_plain(*args, **kw),
                        iters=5)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    do_t = do.transpose(1, 2)
    lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do_t, retain_graph=True))
    pairs = T * (T + 1) // 2
    elt = q.element_size()
    rows = B * H * T * 4                       # one float32 per row
    dq_flops = 3 * 2 * B * H * D * pairs
    dkv_flops = 4 * 2 * B * H * D * pairs
    dq_bound = bound(dq_flops, H100_BF16_FLOPS,
                     5 * q.numel() * elt + 2 * rows)
    dkv_bound = bound(dkv_flops, H100_BF16_FLOPS,
                      6 * q.numel() * elt + 2 * rows)
    # the kernel alone on card-resident indices, as its plain version and
    # index_select are timed; the wrapper adds the host range check and
    # the indices' upload, which the loader pays per batch
    idx_t = torch.from_numpy(idx.astype(np.int32)).cuda()
    g_ms = cuda_ms(torch, lambda: gr._launch(tokens, idx_t), iters=50)
    g_wrapper = cuda_ms(torch, lambda: gr.gather_rows(tokens, idx), iters=50)
    g_plain = cuda_ms(torch, lambda: gr.gather_rows_plain(tokens, idx_t),
                      iters=50)
    g_lib = cuda_ms(torch, lambda: torch.index_select(tokens, 0, idx_t),
                    iters=50)
    row_bytes = TRAIN_T * 4
    g_bound = bound(0, H100_BF16_FLOPS,
                    2 * TRAIN_B * row_bytes + TRAIN_B * 4)
    shape = {"B": B, "T": T, "H": H, "D": D, "dtype": "bfloat16",
             "causal": True}
    timing = {
        dq.NAME: {"max_abs_err": res["dq"]["max_abs_err"], "ms": dq_ms,
                  "plain_ms": dq_plain, "library_ms": lib_ms,
                  "bound_ms": dq_bound[0], "bound_by": dq_bound[1],
                  "variant": "tc", "source": dq.SOURCES["tc"],
                  "tflops": dq_flops / dq_ms / 1e9,
                  "bound_share": dq_bound[0] / dq_ms,
                  "ptxas": _instance_usage("flash_bwd_dq_tc",
                                           "flash_bwd_dq"),
                  "shape": shape},
        dkv.NAME: {"max_abs_err": max(res["dk"]["max_abs_err"],
                                      res["dv"]["max_abs_err"]),
                   "ms": dkv_ms, "plain_ms": dkv_plain, "library_ms": lib_ms,
                   "bound_ms": dkv_bound[0], "bound_by": dkv_bound[1],
                   "variant": "tc", "source": dkv.SOURCES["tc"],
                   "tflops": dkv_flops / dkv_ms / 1e9,
                   "bound_share": dkv_bound[0] / dkv_ms,
                   "ptxas": _instance_usage("flash_bwd_dkv_tc",
                                            "flash_bwd_dkv"),
                   "shape": shape},
        gr.NAME: {"max_abs_err": 0.0, "ms": g_ms, "plain_ms": g_plain,
                  "library_ms": g_lib, "bound_ms": g_bound[0],
                  "bound_by": g_bound[1], "wrapper_ms": g_wrapper,
                  "shape": {"rows": GATHER_ROWS, "m": TRAIN_B,
                            "row_bytes": row_bytes, "dtype": "int32"}},
    }
    say({"phase": "train_kernel_timing",
         "library_note": "library_ms of both flash backward kernels is one "
                         "SDPA backward (dQ, dK and dV together)",
         **timing})
    return timing


def phase_image_kernels(torch):
    """The image path's kernels (fused dropout, mean/disp normalize)
    against their plain versions, bitwise, at the path's shapes and the
    edges; then their times and bounds at the path's shapes."""
    import torch.nn.functional as F
    from veles_tpu_torch.ops.kernels import fused_dropout as fd
    from veles_tpu_torch.ops.kernels import mean_disp as md
    gen = torch.Generator().manual_seed(6)
    checks = []
    drop = [("main_f32_512x4096", (DROP_ROWS, DROP_COLS), torch.float32,
             DROP_RATE, 2769742244),
            ("r0.1_1d", (100003,), torch.float32, 0.1, 3),
            ("r0.9_cols_300", (5, 7, 300), torch.float32, 0.9, 99),
            ("cols_8320", (3, 8320), torch.float32, 0.5, 0xC0FFEE),
            ("bf16_odd", (16, 203), torch.bfloat16, 0.3, 11),
            ("nhwc_f32", (64, 13, 13, 256), torch.float32, 0.5, 5)]
    main_drop = None
    for name, shape, dt, rate, seed in drop:
        x = torch.randn(shape, generator=gen).to("cuda", dt)
        g = torch.randn(shape, generator=gen).to("cuda", dt)
        xr = x.detach().requires_grad_(True)
        y = fd.fused_dropout(xr, seed, rate)
        (gx,) = torch.autograd.grad(y, xr, g)
        y = y.detach()
        ref = fd.fused_dropout_plain(x, seed, rate)
        ref_g = fd.fused_dropout_plain(g, seed, rate)
        torch.cuda.synchronize()
        err = max(float((y.float() - ref.float()).abs().max()),
                  float((gx.float() - ref_g.float()).abs().max()))
        bitwise = torch.equal(y, ref) and torch.equal(gx, ref_g)
        kept = float((ref != 0).float().mean())
        checks.append({"kernel": fd.NAME, "case": name, "rate": rate,
                       "forward_and_grad_bitwise": bitwise,
                       "max_abs_err": err, "tol": 0.0, "kept_share": kept,
                       "ok": bitwise and err == 0.0})
        say(checks[-1])
        if name.startswith("main"):
            main_drop = (x, seed, rate, err)
    md_cases = [("main_uint8_512x227x227x3", (IMG_B, 227, 227, 3),
                 torch.uint8),
                ("main_f32_512x227x227x3", (IMG_B, 227, 227, 3),
                 torch.float32),
                ("odd_uint8_4x13x13x3", (4, 13, 13, 3), torch.uint8),
                ("tiny_f32_3x5", (3, 5), torch.float32)]
    main_md = None
    for name, shape, dt in md_cases:
        x = (torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
             if dt == torch.uint8
             else torch.randn(shape, generator=gen) * 50 + 100).to("cuda")
        feat = shape[1:]
        mean = (torch.rand(feat, generator=gen) * 50 + 100).cuda()
        rdisp = (torch.rand(feat, generator=gen) * 0.01 + 0.01).cuda()
        out = md.mean_disp_normalize(x, mean, rdisp)
        ref = md.mean_disp_normalize_plain(x, mean, rdisp)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        bitwise = torch.equal(out, ref)
        checks.append({"kernel": md.NAME, "case": name, "bitwise": bitwise,
                       "max_abs_err": err, "tol": 0.0,
                       "ok": bitwise and err == 0.0})
        say(checks[-1])
        if name == "main_uint8_512x227x227x3":
            main_md = (x, mean, rdisp, err)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    x, seed, rate, d_err = main_drop
    d_ms = cuda_ms(torch, lambda: fd._launch(x, seed, rate), iters=100)
    d_plain = cuda_ms(torch, lambda: fd.fused_dropout_plain(x, seed, rate))
    d_lib = cuda_ms(torch, lambda: F.dropout(x, rate, training=True),
                    iters=100)
    d_bound = bound(0, H100_F32_FLOPS, 2 * x.numel() * x.element_size())
    xm, mean, rdisp, m_err = main_md
    m_ms = cuda_ms(torch, lambda: md._launch(xm, mean, rdisp), iters=50)
    m_plain = cuda_ms(torch, lambda: md.mean_disp_normalize_plain(
        xm, mean, rdisp))
    m_bytes = xm.numel() * xm.element_size() + xm.numel() * 4 \
        + 2 * mean.numel() * 4
    m_bound = bound(2 * xm.numel(), H100_F32_FLOPS, m_bytes)
    timing = {
        fd.NAME: {"max_abs_err": d_err, "ms": d_ms, "plain_ms": d_plain,
                  "library_ms": d_lib, "bound_ms": d_bound[0],
                  "bound_by": d_bound[1],
                  "library_note": "F.dropout at the same shape and rate: "
                                  "another mask stream",
                  "shape": {"rows": DROP_ROWS, "cols": DROP_COLS,
                            "dtype": "float32", "rate": rate}},
        md.NAME: {"max_abs_err": m_err, "ms": m_ms, "plain_ms": m_plain,
                  "library_ms": None, "bound_ms": m_bound[0],
                  "bound_by": m_bound[1], "bytes": m_bytes,
                  "shape": {"N": IMG_B, "features": [227, 227, 3],
                            "dtype": "uint8"}},
    }
    say({"phase": "image_kernel_timing", **timing})
    return timing


def _image_epoch(torch):
    """One epoch and its eval of the full-width AlexNet e2e workflow
    through ``make_trainer`` -> ``Trainer`` over its card-resident
    augmented loader (init seed 0), launches counted (``_counted_run``);
    the store's synthesis and upload timed apart."""
    from veles_tpu_torch.models.alexnet import alexnet_e2e_device_workflow
    from veles_tpu_torch.runtime.decision import Decision
    t_data = time.perf_counter()
    sw = alexnet_e2e_device_workflow(minibatch_size=IMG_B, n_train=IMG_TRAIN,
                                     n_valid=IMG_VALID, device=DEVICE)
    sw.loader.initialize()
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t_data
    if not sw.loader.on_device:
        fail("the AlexNet store is not on the card")
    return _counted_run(torch, sw.make_trainer(
        sw.loader, Decision(max_epochs=1), device=DEVICE), t_data)


def phase_image(torch):
    """The image path at full width: AlexNet e2e through the Trainer for
    one epoch over the card-resident store, launches counted over it;
    then a profiled window, the float32 kernels-vs-plain step and one
    predict batch."""
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.ops.kernels import (fused_dropout, gather_rows,
                                             mean_disp)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = _image_epoch(torch)
    trainer, step_s, losses = run["trainer"], run["step_s"], run["losses"]
    launches, wall = run["launches"], run["wall"]
    hist = trainer.decision.history
    steps = len(step_s)
    med = float(np.median(step_s)) if step_s else float("nan")
    rec = {"phase": "image_train", "steps": steps, "epochs": len(hist),
           "store": list(trainer.loader._data[TRAIN].shape[1:]),
           "store_bytes": sum(int(a.nbytes)
                              for a in trainer.loader._data.values()),
           "data_s": run["data_s"], "run_s": wall,
           "step_ms_median": med * 1e3,
           "step_ms_max": max(step_s) * 1e3 if step_s else None,
           "first_step_ms": step_s[0] * 1e3 if step_s else None,
           "train_samples_per_s": IMG_B / med,
           "epoch_samples_per_s": steps * IMG_B / wall,
           "losses": losses,
           "train": hist[0]["train"] if hist else None,
           "valid": hist[0]["valid"] if hist else None,
           "launches": launches}
    say(rec)
    low = {k: launches[k] for k, n in IMG_MIN_LAUNCHES.items()
           if launches[k] < n}
    if low or launches[gather_rows.NAME] < 1:
        fail(f"the image path launched too few kernels: {launches} (at "
             f"least {IMG_MIN_LAUNCHES} and a gather)")
    if steps != IMG_TRAIN // IMG_B or not all(np.isfinite(losses)):
        fail(f"the image epoch ran {steps} steps or a loss is not finite: "
             f"{losses}")
    profile = _train_profile(torch, trainer,
                             f"3 AlexNet train steps, {IMG_B} images each")
    say({"phase": "image_profile", **profile})
    agreement = _image_step_f32_check(torch, trainer, (fused_dropout,
                                                       mean_disp))
    say({"phase": "image_f32_kernel_vs_plain", **agreement})
    if not agreement["ok"]:
        fail(f"float32 AlexNet step: kernels and plain versions disagree: "
             f"{agreement}")
    pred = _image_predict(torch, trainer, fused_dropout, mean_disp)
    say({"phase": "image_predict", **pred})
    if not pred["ok"]:
        fail(f"AlexNet predict: {pred}")
    return launches


def _image_step_f32_check(torch, trainer, kernels):
    """One float32 forward/backward of the full-width AlexNet through the
    kernels and one through the plain versions (both wrappers' routes
    patched), from the trainer's weights and unit state, its first train
    batch and one key; cuDNN deterministic and TF32 off."""
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.models.alexnet import _e2e_config
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.units.workflow import seed_key, split_state_key
    wf = StandardWorkflow(_e2e_config(compute_dtype=None)).workflow
    wf.build({k: v for k, v in trainer.workflow.specs.items()
              if k.startswith("@")})
    ws = trainer.wstate
    batch = next(trainer.loader.iter_epoch(TRAIN, 0))
    _, sub = split_state_key(seed_key(0))
    drops = ("drop6", "drop7")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        before = [m.launches.count for m in kernels]
        k_loss, k_norms, k_zero = _loss_and_grad_norms(
            torch, wf, ws["params"], batch, ws["state"], sub, drops)
        mid = [m.launches.count for m in kernels]
        with plain_routes(kernels):
            p_loss, p_norms, p_zero = _loss_and_grad_norms(
                torch, wf, ws["params"], batch, ws["state"], sub, drops)
        after = [m.launches.count for m in kernels]
    finally:
        torch.backends.cudnn.deterministic = prev
    launched = all(m > b for m, b in zip(mid, before)) and after == mid
    masks = {n: bool(torch.equal(k_zero[n], p_zero[n])) for n in drops}
    dropped = {n: float(p_zero[n].float().mean()) for n in drops}
    loss_rel = abs(k_loss - p_loss) / max(abs(p_loss), 1e-12)
    grad_rel = {n: abs(k_norms[n] - p_norms[n]) / max(p_norms[n], 1e-12)
                for n in p_norms}
    worst = max(grad_rel, key=grad_rel.get)
    return {"loss_kernels": k_loss, "loss_plain": p_loss,
            "loss_rel_diff": loss_rel, "loss_rtol": STEP_LOSS_RTOL,
            "grad_norm_max_rel_diff": grad_rel[worst], "worst": worst,
            "grad_rtol": STEP_GRAD_RTOL, "masks_identical": masks,
            "zero_share": dropped, "kernels_launched": launched,
            "ok": (launched and all(masks.values())
                   and np.isfinite(k_loss)
                   and loss_rel <= STEP_LOSS_RTOL
                   and grad_rel[worst] <= STEP_GRAD_RTOL
                   and all(v > 0 for v in p_norms.values()))}


def _image_predict(torch, trainer, dropout, mean_disp):
    """One ``make_predict_step("fc8")`` batch: finite logits of (512,
    1000); dropout is the identity (no launch), mean/disp launches."""
    from veles_tpu_torch.loader.base import VALID
    step = trainer.workflow.make_predict_step("fc8")
    batch = next(trainer.loader.iter_epoch(VALID, 0))
    before = (dropout.launches.count, mean_disp.launches.count)
    y = step(trainer.wstate, batch)
    torch.cuda.synchronize()
    after = (dropout.launches.count, mean_disp.launches.count)
    return {"shape": list(y.shape), "finite": bool(torch.isfinite(y).all()),
            "dropout_launches": after[0] - before[0],
            "mean_disp_launches": after[1] - before[1],
            "ok": (tuple(y.shape) == (IMG_B, 1000)
                   and bool(torch.isfinite(y).all())
                   and after[0] == before[0] and after[1] == before[1] + 1)}


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
        variants = {k.NAME: k.launches.by_variant() for k in KERNELS
                    if k.launches.by_variant()}
        stats = engine.stats()
        profile = phase_profile(torch, engine, prompts)
    finally:
        srv.stop()
        engine.stop()
    say({"phase": "http", "requests": {"sent": 3, "ok": 3, "failed": 0},
         "launches": launches, "variants": variants,
         "greedy_request_s": t_greedy,
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
    from veles_tpu_torch.ops.kernels import flash_attention, paged_attention
    missing = [k.NAME for k in (flash_attention, paged_attention)
               if launches[k.NAME] < 1]
    if missing:
        fail(f"the serving path never launched {missing}")
    per_step = LAYERS * stats["decode_steps"]
    if launches[paged_attention.NAME] != per_step:
        fail(f"paged decode launched {launches[paged_attention.NAME]} "
             f"times over {stats['decode_steps']} decode steps of "
             f"{LAYERS} layers (want one a layer a step: {per_step})")

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


def _train_workflow(torch, compute_dtype):
    from veles_tpu_torch.models.standard import StandardWorkflow
    return StandardWorkflow({"name": "bench_lm", "layers": bench_layers(),
                             "compute_dtype": compute_dtype,
                             "optimizer": "adam",
                             "optimizer_args": {"lr": 1e-3},
                             "max_epochs": 1})


def _loss_and_grad_norms(torch, wf, params, batch, state=None, key=None,
                         zeros_of=()):
    """Loss and each parameter's gradient norm of one forward/backward
    (the train step's core) on ``params``, with the unit ``state`` and
    the step ``key``; and the zero pattern of each unit in ``zeros_of``."""
    from veles_tpu_torch.ops.optimizers import tree_leaves, tree_map
    from veles_tpu_torch.units.base import Context
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    outputs, _ = wf.forward(live, state or {}, batch,
                            Context(train=True, key=key))
    loss = outputs[wf.evaluator.name]
    names = [f"{u}/{k}" for u in sorted(live) for k in sorted(live[u])]
    grads = torch.autograd.grad(loss, tree_leaves(live))
    zeros = {n: (outputs[n] == 0).detach() for n in zeros_of}
    return float(loss.detach()), {n: float(g.float().norm())
                                  for n, g in zip(names, grads)}, zeros


def _train_epoch(torch):
    """One epoch and its eval of the full-width bf16 LM through
    ``StandardWorkflow.make_trainer`` -> ``Trainer`` over a card-resident
    InductionLoader (init seed 0), launches counted (``_counted_run``)."""
    from veles_tpu_torch.models.lm import InductionLoader
    t_data = time.perf_counter()
    loader = InductionLoader(minibatch_size=TRAIN_B, n_train=N_TRAIN,
                             n_valid=N_VALID, seq_len=TRAIN_T, vocab=VOCAB,
                             per_position=True, device=DEVICE)
    t_data = time.perf_counter() - t_data
    sw = _train_workflow(torch, "bfloat16")
    return _counted_run(torch, sw.make_trainer(loader, device=DEVICE),
                        t_data)


def _counted_run(torch, trainer, t_data):
    """``trainer.initialize(seed=0)`` and ``run()``, every kernel's count
    set to 0 just before and read just after; per-step wall and loss
    recorded."""
    from veles_tpu_torch.ops.kernels import KERNELS
    step_s, losses = [], []
    for kern in KERNELS:
        kern.launches.reset()
    trainer.initialize(seed=0)
    inner = trainer._train_step

    def timed_step(wstate, batch):      # per-step wall and loss
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wstate, mets = inner(wstate, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(mets["loss"])
        return wstate, mets

    trainer._train_step = timed_step
    try:
        t0 = time.perf_counter()
        results = trainer.run()
        wall = time.perf_counter() - t0
    finally:
        trainer._train_step = inner
    return {"trainer": trainer, "results": results, "wall": wall,
            "data_s": t_data, "step_s": step_s,
            "losses": [float(x) for x in losses],
            "launches": {k.NAME: k.launches.count for k in KERNELS},
            "variants": {k.NAME: k.launches.by_variant() for k in KERNELS
                         if k.launches.by_variant()}}


def phase_train(torch):
    """The training path at full width: Trainer over a card-resident
    InductionLoader for one epoch, kernel launches counted over it; then
    the same epoch through the plain versions as a witness of the loss
    curve."""
    from veles_tpu_torch.ops.kernels import (flash_attention, flash_bwd_dkv,
                                             flash_bwd_dq, gather_rows)
    from veles_tpu_torch.runtime.snapshotter import params_from_jax
    from veles_tpu_torch.units.workflow import new_state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = _train_epoch(torch)
    trainer, step_s, losses = run["trainer"], run["step_s"], run["losses"]
    launches, wall = run["launches"], run["wall"]
    hist = trainer.decision.history
    train_loss = hist[0]["train"]["loss"] if hist else float("nan")
    valid = hist[0]["valid"] if hist else {}
    steps = len(step_s)
    med = float(np.median(step_s)) if step_s else float("nan")
    rec = {"phase": "train", "steps": steps, "epochs": len(hist),
           "data_s": run["data_s"], "run_s": wall,
           "step_ms_median": med * 1e3,
           "step_ms_max": max(step_s) * 1e3 if step_s else None,
           "first_step_ms": step_s[0] * 1e3 if step_s else None,
           "train_tokens_per_s": TRAIN_B * TRAIN_T / med,
           "epoch_tokens_per_s": steps * TRAIN_B * TRAIN_T / wall,
           "loss_first8": losses[:8], "loss_last8": losses[-8:],
           "train_loss": train_loss, "valid": valid,
           "results": run["results"], "launches": launches,
           "variants": run["variants"]}
    say(rec)
    path_kernels = (flash_attention, flash_bwd_dq, flash_bwd_dkv,
                    gather_rows)
    missing = [k.NAME for k in path_kernels if launches[k.NAME] < 1]
    if missing:
        fail(f"the training path never launched {missing}")
    # every bf16 flash launch (forward, dQ, dK/dV) on the tensor cores
    off_tc = {k.NAME: run["variants"].get(k.NAME) for k in
              (flash_attention, flash_bwd_dq, flash_bwd_dkv)
              if run["variants"].get(k.NAME) != {"tc": launches[k.NAME]}}
    if off_tc:
        fail(f"bf16 flash launches outside the tensor-core variant: "
             f"{off_tc}")
    if steps != N_TRAIN // TRAIN_B or not all(np.isfinite(losses)):
        fail(f"training ran {steps} steps or a loss is not finite: "
             f"{losses}")
    descent = _fixed_batch_descent(trainer)
    say({"phase": "train_fixed_batch", **descent})
    if not descent["ok"]:
        fail(f"the training loss did not fall on a fixed batch: {descent}")
    profile = _train_profile(torch, trainer)
    say({"phase": "train_profile", **profile})
    agreement = _train_step_f32_check(torch, trainer, params_from_jax,
                                      new_state)
    say({"phase": "train_f32_kernel_vs_plain", **agreement})
    if not agreement["ok"]:
        fail(f"float32 train step: kernels and plain versions disagree: "
             f"{agreement}")
    witness = _plain_epoch_witness(torch, losses, path_kernels)
    say({"phase": "train_plain_witness", **witness})
    if not witness["ok"]:
        fail(f"the epoch through the plain versions does not follow the "
             f"kernels' loss curve: {witness}")
    return launches


def _plain_epoch_witness(torch, kernel_losses, path_kernels):
    """The same epoch (same init, batches and order) with every kernel of
    the path replaced by its plain version: its per-step losses beside
    the kernels', and no kernel launched."""
    with plain_routes(path_kernels):
        run = _train_epoch(torch)
    plain = run["losses"]
    launched = {k.NAME: run["launches"][k.NAME] for k in path_kernels}
    diff = [abs(a - b) for a, b in zip(kernel_losses, plain)]

    def mean(xs):
        return float(np.mean(xs)) if xs else float("nan")

    return {"steps": len(plain), "losses_plain": plain,
            "losses_kernels": kernel_losses,
            "max_abs_diff": max(diff) if diff else None,
            "atol": WITNESS_ATOL,
            "first8_mean": [mean(kernel_losses[:8]), mean(plain[:8])],
            "last8_mean": [mean(kernel_losses[-8:]), mean(plain[-8:])],
            "plain_step_ms_median": float(np.median(run["step_s"])) * 1e3,
            "kernel_launches": launched,
            "ok": (len(plain) == len(kernel_losses) == N_TRAIN // TRAIN_B
                   and all(np.isfinite(plain))
                   and not any(launched.values())
                   and max(diff) <= WITNESS_ATOL)}


def _fixed_batch_descent(trainer):
    """bench_lm.py's check: train steps repeated on one constant batch
    (the next epoch's first) must drive its loss down.  Over the epoch
    itself the loss stays near chance (ln 1024 = 6.93): only the second
    copy of each repeated segment and the trigger's last position, ~80
    of a minibatch's 32768 positions, carry a learnable target, and the
    induction circuit that predicts them takes far more than 32 steps to
    form."""
    from veles_tpu_torch.loader.base import TRAIN
    batch = next(trainer.loader.iter_epoch(TRAIN, 1))
    losses = []
    for _ in range(FIXED_STEPS):
        trainer.wstate, mets = trainer._train_step(trainer.wstate, batch)
        losses.append(mets["loss"])
    losses = [float(x) for x in losses]
    return {"steps": FIXED_STEPS, "losses": losses,
            "min_drop": FIXED_MIN_DROP,
            "ok": bool(np.all(np.isfinite(losses))
                       and losses[-1] <= (1 - FIXED_MIN_DROP) * losses[0])}


def _train_profile(torch, trainer,
                   window="3 train steps, 16 x 2048 tokens each"):
    """Device busy time by kernel over 3 train steps (torch.profiler);
    the idle share is 1 - busy / wall; the flash kernels' device ms a
    step."""
    from torch.profiler import ProfilerActivity, profile
    from veles_tpu_torch.loader.base import TRAIN
    batches = [b for _, b in zip(range(3),
                                 trainer.loader.iter_epoch(TRAIN, 0))]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            trainer.wstate, _ = trainer._train_step(trainer.wstate, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _busy(prof, wall, window, steps=len(batches))


#: kernel-name pieces whose device time a profiled step reports apart
FLASH_KERNELS = ("flash_fwd_tc", "flash_fwd_kernel", "flash_bwd_dkv_tc",
                 "flash_bwd_dkv_kernel", "flash_bwd_dq_tc",
                 "flash_bwd_dq_kernel")


def _busy(prof, wall, window, steps=None):
    busy = {}
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        t = (getattr(evt, "self_device_time_total", None)
             or getattr(evt, "self_cuda_time_total", 0) or 0)
        if t > 0:
            busy[evt.key] = busy.get(evt.key, 0.0) + t / 1e6
    total = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:10]
    rec = {"window": window, "wall_s": wall,
           "device_busy_s": total if busy else None,
           "device_idle_share": (1.0 - total / wall) if busy else None,
           "top_kernels_s": [[k[:90], v] for k, v in top]}
    if steps:
        rec["flash_device_ms_per_step"] = {
            part: sum(v for k, v in busy.items() if part in k) / steps * 1e3
            for part in FLASH_KERNELS}
    return rec


def plain_routes(modules):
    """Context in which each kernel module's wrapper takes its plain
    version on the card (its ``kernel_route`` patched to False)."""
    import contextlib
    stack = contextlib.ExitStack()
    for mod in modules:
        stack.enter_context(mock.patch.object(mod, "kernel_route",
                                              lambda x, name: False))
    return stack


def _train_step_f32_check(torch, trainer, params_from_jax, new_state):
    """One float32 forward/backward of the full-width LM through the
    kernels and one through the plain versions (the flash wrappers'
    routing patched to the plain path), same weights and batch."""
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.ops.kernels import flash_attention as fa
    from veles_tpu_torch.ops.kernels import flash_bwd_dkv as dkv
    from veles_tpu_torch.ops.kernels import flash_bwd_dq as dq
    wf = _train_workflow(torch, None).workflow
    wf.build({k: v for k, v in trainer.workflow.specs.items()
              if k.startswith("@")})
    params = params_from_jax(jax_layout_weights(wf, seed=0), wf,
                             device=DEVICE)
    batch = next(trainer.loader.iter_epoch(TRAIN, 0))
    flash = (fa, dq, dkv)
    before = [m.launches.count for m in flash]
    k_loss, k_norms, _ = _loss_and_grad_norms(torch, wf, params, batch)
    mid = [m.launches.count for m in flash]
    with plain_routes(flash):
        p_loss, p_norms, _ = _loss_and_grad_norms(torch, wf, params, batch)
    after = [m.launches.count for m in flash]
    # every flash kernel ran on the kernel side and none on the plain side
    launched = all(m > b for m, b in zip(mid, before)) and after == mid
    loss_rel = abs(k_loss - p_loss) / max(abs(p_loss), 1e-12)
    grad_rel = {n: abs(k_norms[n] - p_norms[n]) / max(p_norms[n], 1e-12)
                for n in p_norms}
    worst = max(grad_rel, key=grad_rel.get)
    attn = {n: [k_norms[n], p_norms[n]] for n in p_norms
            if n.startswith("attn0/")}
    return {"loss_kernels": k_loss, "loss_plain": p_loss,
            "loss_rel_diff": loss_rel, "loss_rtol": STEP_LOSS_RTOL,
            "grad_norm_max_rel_diff": grad_rel[worst], "worst": worst,
            "grad_rtol": STEP_GRAD_RTOL, "attn0_grad_norms": attn,
            "kernels_launched": launched,
            "ok": (launched and loss_rel <= STEP_LOSS_RTOL
                   and grad_rel[worst] <= STEP_GRAD_RTOL
                   and all(v > 0 for v in p_norms.values()))}


def phase_quality(torch):
    """The family's quality bar through the CLI, on the card."""
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "veles_tpu_torch",
           os.path.join(here, "configs", "induction_lm.json"),
           "--random-seed", "1"]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                           timeout=600)
    except subprocess.TimeoutExpired:
        fail("the induction_lm CLI run exceeded 600 s")
    took = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"the induction_lm CLI run exited {r.returncode}: "
             f"{r.stderr[-2000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    epochs = [ln for ln in r.stderr.splitlines() if "error_pct=" in ln]
    rec = {"phase": "quality", "config": "configs/induction_lm.json",
           "best_error_pct": res["best_value"],
           "best_epoch": res["best_epoch"], "epochs": res["epochs"],
           "seconds": took, "train_samples_per_s":
               res["train_samples_per_s"], "bar": QUALITY_BAR,
           "per_epoch": [ln.split("Decision: ")[-1] for ln in epochs]}
    say(rec)
    if not res["best_value"] <= QUALITY_BAR:
        fail(f"induction_lm reached {res['best_value']} % validation "
             f"error, above the {QUALITY_BAR} % bar")
    return rec


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
    return _busy(prof, wall, f"{SLOTS} x (prefill 64 + decode 32)")


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
    timing.update(phase_train_kernels(torch))
    timing.update(phase_image_kernels(torch))
    serve_launches = phase_main_path(torch)
    train_launches = phase_train(torch)
    image_launches = phase_image(torch)
    phase_quality(torch)
    # each kernel's launches on its own path: paged decode on the serving
    # path, dropout and mean/disp on the image path, the rest on the LM
    # training path (flash forward runs on both LM paths, the gather on
    # both training paths; the other counts are in the phase lines)
    launches = dict(train_launches)
    launches["paged_attention_decode"] = serve_launches[
        "paged_attention_decode"]
    for kname in IMG_MIN_LAUNCHES:
        launches[kname] = image_launches[kname]
    line = []
    for kern in KERNELS:
        t = timing[kern.NAME]
        extra = {"variant": t["variant"]} if "variant" in t else {}
        line.append({"name": kern.NAME, "route": "cuda",
                     "source": t.get("source", kern.SOURCE),
                     "replaces": kern.REPLACES, **extra,
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
