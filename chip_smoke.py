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
   element, see BWD_UNITS; the row gather in both its entries, one array
   with its host check and the loaders' batch of every array of a class
   in one launch); then each kernel's time, its plain version's time,
   the time of the one PyTorch call computing the same function (where
   there is one) and the card's bound for the same work (paged
   decode also with a cold L2, 128 MiB written before each launch);
4. serving path: the bench_lm.py transformer LM at full width (vocab
   1024, dim 512, 4 blocks of 8-head RoPE attention + layer_norm + ffn
   2048 + layer_norm, per-position head, bf16 compute), random weights
   from a numpy seed in the JAX package's flattened-key layout carried in
   by ``params_from_jax``, served by ``RestfulServer`` over a paged
   ``DecodeEngine`` (8 slots, l_max 1024, page 16, paged kernel on) whose
   decode (sampling and greedy-only) and prefill steps are captured as
   CUDA graphs when it is built:
   greedy and sampled ``POST /generate`` (prompt 512, 64 new tokens), one
   ``POST /predict`` (16 x 2048 batch), then 8 requests sharing a
   256-token system prompt (prefix hits and copy-on-write admissions),
   a 960-token prompt submitted while they decode (4 prefill slices of
   256) and a streamed request stopped by a stop sequence taken from its
   own greedy continuation; the flash-forward and paged kernels' launch
   counts must rise during it, paged decode exactly once per layer per
   decode step, replays counted, and the three programs captured once
   each with no recapture; a window of 8 x (64 + 32) timed, and a
   profiled one (8 x (16 + 8)) holding the counted launches against the
   trace, on this engine and on one with ``capture=False`` (its metrics
   printed beside the captured ones, its tokens equal); 32 scheduler iterations
   with admissions and retirements on a captured and an eager engine,
   tokens and KV pool equal bit for bit; greedy tokens compared with
   the port's own ``generate()`` (share reported in bf16, with the first
   position where row 0 parts from it through the paged kernel and
   through the gather path; in float32 every token must agree), and a
   float32 engine whose 64-page pool cannot hold both of two requests,
   where a class-0 request preempts a class-2 one whose tokens must
   equal its uninterrupted run (the same request alone on that engine);
   then the greedy request on a megastep (N=8) engine and on a fresh
   N=1 engine, in bf16 and in float32, whose tokens must equal the N=1
   engine's, with a profiled
   decode window of one megastep replay beside one of N=1 steps; 8
   prompts of a repeated 32-token phrase (one row sampled) on a
   speculative (k=4) engine under its own policy, then timed under a
   fixed policy of a verify dispatch every iteration and of decode steps
   alone, whose tokens must equal the non-spec engine's, with a
   profiled window of one verify replay (every
   replay's paged launches held against the trace: 4 a decode, 32 a
   megastep, 20 a verify); each graph's device time and the sampler's
   alone; and a VTKV1 round trip over REST (``GET /kv/pages``, ``PUT
   /kv/pages``) into a fresh engine that must then hit every imported
   page, prefill only the new tail and give the exporter's tokens, a
   corrupted blob answered 400 with the pool unchanged;
5. training path, full width: the same LM (bf16) trained through
   ``StandardWorkflow.make_trainer`` -> ``Trainer`` for one epoch (32
   steps of 16 x 2048 tokens, Adam lr 1e-3) and its eval, fed by an
   ``InductionLoader(per_position=True, seq_len=2048, vocab=1024)`` held
   on the card; the train and eval steps come from the trainer's
   ``StepCache`` captured as CUDA graphs (2 captures, no recapture), the
   launch counts include every replay's; the flash forward, both flash
   backward and the gather kernels must launch, every bf16 flash launch
   (forward, dQ, dK/dV) on the tensor-core variant, the gather exactly
   once per batch (36 over the epoch and its eval), and every loss must
   be finite; then 8 steps on one fixed batch must cut its loss by 5 %
   (the epoch's own loss stays near chance, see
   ``_fixed_batch_descent``); step times, tokens/s and a torch.profiler
   window of 3 steps (device idle share, top kernels); the host time a
   batch costs (``make_batch`` and its one gather launch, beside the
   former path of one gather call per array); then one float32 train step
   through the kernels and one through the plain versions from the same
   weights and batch, loss and per-parameter gradient norms compared;
   then the same bf16 epoch again with every kernel of the path replaced
   by its plain version, whose per-step losses must follow the kernels'
   (``_plain_epoch_witness``); then, in bf16 and in float32, 8 steps and
   an eval through the eager step (``StepCache(capture=False)``) and the
   captured one from one init and batch order, which must leave the same
   parameters, optimizer state and epoch sums bit for bit (each side's
   median step and, bf16, its idle share printed); then a Decision
   rollback through a captured trainer's loop (Adam at lr 0, so epoch 1
   repeats epoch 0), which must halve the lr multiplier in the captured
   state and recapture nothing;
6. image kernels: fused dropout (AlexNet's drop6/drop7 shape, 512 x
   4096 float32, and the edges; forward and gradient) and mean/disp
   normalize (norm0's shape, 512 x 227 x 227 x 3, uint8 and float32)
   against their plain versions, bitwise, then their times and bounds;
7. image path, full width: ``alexnet_e2e_device_workflow`` (bf16
   compute, momentum SGD with l2) trained through
   ``StandardWorkflow.make_trainer`` -> ``Trainer`` for one epoch (8
   steps of 512) and its eval, from a 4096 + 512 image uint8 store held
   on the card (random crop 227 and mirror there); the train step runs
   eagerly (dropout takes its seed by value each step, which the
   ``StepCache`` states as its reason) and the eval step is captured;
   mean/disp must launch at least 9 times and dropout 32 (2 forward + 2
   backward per step), every loss must be finite; step times, samples/s and a torch.profiler
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

import hashlib
import json
import os
import re
import subprocess
import sys
import time
import urllib.error
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
WITNESS_STEPS = 8               # eager vs captured steps, bitwise
GATHER_ROWS = 512               # int32 token rows held for the gather check
SLOTS, L_MAX, PAGE = 8, 1024, 16
PROMPT, NEW = 512, 64
F32_PROMPT, F32_NEW = 64, 16    # the float32 agreement run
# the scheduler traffic: SHARED_N requests of a shared system prompt and
# their own tails; one long prompt cut into prefill_chunk (256) slices
SHARED_N, SHARED_PREFIX, SHARED_TAIL = 8, 256, 256
CHUNKED_PROMPT, CHUNKED_NEW = 960, 64
# the float32 preemption: a pool of PREEMPT_POOL pages (the least that
# holds one l_max request) hosts the class-2 victim (48 pages) or the
# class-0 arrival (36), never both
PREEMPT_POOL, PREEMPT_PROMPT, PREEMPT_VICTIM_NEW = 64, 512, 256
WITNESS_ITERS = 32              # scheduler iterations, eager vs captured
WINDOW_PROMPT, WINDOW_NEW = 64, 32      # the eager-vs-captured window
PROFILE_PROMPT, PROFILE_NEW = 16, 8     # the profiled serving window
MEGASTEP_N = 8                  # decode micro-steps a megastep dispatch
# speculative verify: SLOTS prompts, each a random SPEC_PHRASE-token
# phrase repeated to SPEC_PROMPT tokens, SPEC_NEW new tokens (the last
# row sampled), drafts of SPEC_K tokens
SPEC_K, SPEC_PHRASE, SPEC_PROMPT, SPEC_NEW = 4, 32, 256, 64
KV_PROMPT, KV_TAIL, KV_NEW = 256, 64, 32   # the VTKV1 round trip
DEVICE = "cuda"                # the main path's device


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_START = time.perf_counter()


def say(obj):
    if isinstance(obj, dict) and "phase" in obj:
        # when the line was printed, in seconds since the script started
        obj = {**obj, "at_s": round(time.perf_counter() - _START, 3)}
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
    # gather, single array (the wrapper with its host check): the training
    # minibatch (16 rows of 2048 int32 tokens from a card-resident set) and
    # an odd row size (21 bytes)
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
    # the loaders' batch gather (every array of a class and the mask in
    # one launch): one, two, three and four arrays, every copy unit, a
    # padded tail, the last batch of an epoch
    batch_cases = [
        ("batch_lm_train_3_arrays_epoch_end",
         [((TRAIN_T,), torch.int32), ((TRAIN_T,), torch.int32),
          ((TRAIN_T,), torch.float32)], GATHER_ROWS, TRAIN_B, TRAIN_B,
         GATHER_ROWS - TRAIN_B),
        ("batch_one_array", [((TRAIN_T,), torch.int32)], GATHER_ROWS,
         TRAIN_B, TRAIN_B, 0),
        ("batch_two_padded_tail", [((TRAIN_T,), torch.int32),
                                   ((TRAIN_T,), torch.int32)], 500,
         TRAIN_B, 4, 496),
        ("batch_odd_rows_every_unit", [((3, 7), torch.uint8),
                                       ((5,), torch.int16),
                                       ((3,), torch.float32),
                                       ((2,), torch.float64)], 101, 37, 30,
         64)]
    for name, specs, n, m, count, offset in batch_cases:
        arrays = [torch.randint(0, 1 << 14, (n,) + shp, generator=gen)
                  .to(dt).cuda() for shp, dt in specs]
        order = rng.permutation(n)[:offset + count]
        perm = gr.index_tensor(order, n, offset + m, "cuda")
        outs = [torch.empty((m,) + a.shape[1:], dtype=a.dtype,
                            device="cuda") for a in arrays]
        refs = [torch.empty_like(o) for o in outs]
        mask = torch.empty(m, device="cuda")
        ref_mask = torch.empty(m, device="cuda")
        gr.gather_batch(arrays, outs, perm, offset, count, mask)
        gr.gather_batch_plain(arrays, refs, perm, offset, count, ref_mask)
        torch.cuda.synchronize()
        same = (all(torch.equal(o, r) for o, r in zip(outs, refs))
                and bool(torch.equal(mask, ref_mask)))
        checks.append({"kernel": gr.NAME, "case": name, "arrays": len(specs),
                       "bitwise": same, "max_abs_err": 0.0 if same else None,
                       "tol": 0.0, "ok": same})
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
    # the batch gather at the LM train class's shape (tokens, labels and
    # per-position masks, 16 rows of 2048 each, from a card-resident set):
    # the kernel on the epoch's order as the loader launches it; the plain
    # version; no single PyTorch call gathers several arrays, so no
    # library time.  The single-array wrapper alone, beside it: its kernel,
    # index_select, and the wrapper with its host check and upload
    lm_arrays = [tokens, torch.randint(0, VOCAB, tokens.shape,
                                       dtype=torch.int32,
                                       generator=gen).cuda(),
                 torch.rand(tokens.shape, generator=gen).cuda()]
    perm = gr.index_tensor(rng.permutation(GATHER_ROWS), GATHER_ROWS,
                           GATHER_ROWS, "cuda")
    outs = [torch.empty((TRAIN_B,) + a.shape[1:], dtype=a.dtype,
                        device="cuda") for a in lm_arrays]
    mask = torch.empty(TRAIN_B, device="cuda")
    g_ms = cuda_ms(torch, lambda: gr.gather_batch(
        lm_arrays, outs, perm, 0, TRAIN_B, mask), iters=50)
    g_plain = cuda_ms(torch, lambda: gr.gather_batch_plain(
        lm_arrays, outs, perm, 0, TRAIN_B, mask), iters=50)
    row_bytes = TRAIN_T * 4
    g_bound = bound(0, H100_BF16_FLOPS,
                    2 * len(lm_arrays) * TRAIN_B * row_bytes
                    + 2 * TRAIN_B * 4)
    idx_t = torch.from_numpy(idx.astype(np.int32)).cuda()
    rows_ms = cuda_ms(torch, lambda: gr._launch(tokens, idx_t), iters=50)
    rows_wrapper = cuda_ms(torch, lambda: gr.gather_rows(tokens, idx),
                           iters=50)
    rows_lib = cuda_ms(torch, lambda: torch.index_select(tokens, 0, idx_t),
                       iters=50)
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
                  "library_ms": None, "bound_ms": g_bound[0],
                  "bound_by": g_bound[1], "variant": "batch",
                  "rows_kernel_ms": rows_ms, "rows_wrapper_ms": rows_wrapper,
                  "rows_index_select_ms": rows_lib,
                  "shape": {"rows": GATHER_ROWS, "m": TRAIN_B,
                            "arrays": ["int32", "int32", "float32"],
                            "row_bytes": row_bytes}},
    }
    say({"phase": "train_kernel_timing",
         "library_note": "library_ms of both flash backward kernels is one "
                         "SDPA backward (dQ, dK and dV together); the batch "
                         "gather has no single PyTorch call",
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
           "launches": launches, "step_cache": run["step_cache"]}
    say(rec)
    low = {k: launches[k] for k, n in IMG_MIN_LAUNCHES.items()
           if launches[k] < n}
    if low or launches[gather_rows.NAME] < 1:
        fail(f"the image path launched too few kernels: {launches} (at "
             f"least {IMG_MIN_LAUNCHES} and a gather)")
    if steps != IMG_TRAIN // IMG_B or not all(np.isfinite(losses)):
        fail(f"the image epoch ran {steps} steps or a loss is not finite: "
             f"{losses}")
    # dropout takes its seed by value each step: the train step runs
    # eagerly and says why; the eval step is captured
    st = run["step_cache"]
    if st["train"] != {"captured": False, "reason": "dropout seed"} \
            or not st["eval"]["captured"]:
        fail(f"AlexNet's steps: {st}")
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


def _serve_metrics(stats, wall):
    """The serving metrics of one traffic run, from ``engine.stats()``
    deltas over it and its wall seconds."""
    return {"decode_tokens_per_s_all_slots": stats["decode_tokens_per_s"],
            "decode_step_s_p50": stats["decode_step_s_p50"],
            "decode_step_s_max": stats["decode_step_s_max"],
            "ttft_s_mean": stats["ttft_s_mean"],
            "ttft_s_max": stats["ttft_s_max"],
            "prefill_tokens_per_s": (stats["prefill_tokens"]
                                     / max(wall - stats["decode_seconds"],
                                           1e-9)),
            "request_tokens_per_s": SLOTS * NEW / wall}


def _novel_pair(gen):
    """The first k whose pair gen[k:k+2] does not occur earlier: a stop
    sequence on it ends a stream at exactly k + 2 tokens."""
    return next(k for k in range(len(gen) - 1)
                if list(gen[k:k + 2]) not in
                [list(gen[j:j + 2]) for j in range(k)])


def _stream(port, body, timeout=900):
    """POST /generate with ``"stream": true``: the NDJSON frames."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.headers["Content-Type"] != "application/x-ndjson":
            fail(f"a streamed /generate answered {r.headers['Content-Type']}")
        return [json.loads(line) for line in r if line.strip()]


def _scheduler_traffic(torch, engine, port, rng, greedy):
    """The scheduler's features on the serving engine, through HTTP:
    SHARED_N requests sharing a SHARED_PREFIX-token system prompt (one
    first, then the rest together: they map its pages copy-on-write),
    one CHUNKED_PROMPT-token prompt submitted while they decode (cut into
    slices of the engine's prefill_chunk), and one streamed request
    whose stop sequence comes from its own greedy continuation."""
    import threading
    sysp = rng.integers(0, VOCAB, SHARED_PREFIX)
    shared = [np.concatenate([sysp, rng.integers(0, VOCAB, SHARED_TAIL)])
              for _ in range(SHARED_N)]
    long_p = rng.integers(0, VOCAB, CHUNKED_PROMPT)
    out, errors = {}, []

    def post(i, prompt, steps):
        try:
            out[i] = np.asarray(_post(port, "/generate", {
                "prompt": [prompt.tolist()], "steps": steps})["tokens"])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    s0 = engine.stats()
    t0 = time.perf_counter()
    post(0, shared[0], NEW)             # warms the system prompt's pages
    threads = [threading.Thread(target=post, args=(i, shared[i], NEW))
               for i in range(1, SHARED_N)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 600
    while engine.stats()["occupancy"] < 2 and time.monotonic() < deadline:
        time.sleep(0.001)
    decoding_at_submit = engine.stats()["occupancy"]
    lt = threading.Thread(target=post, args=("long", long_p, CHUNKED_NEW))
    lt.start()
    for t in threads + [lt]:
        t.join(900)
    wall = time.perf_counter() - t0
    s1 = engine.stats()
    g0 = greedy[0, PROMPT:]
    k = _novel_pair(g0)
    frames = _stream(port, {"prompt": greedy[:1, :PROMPT].tolist(),
                            "steps": NEW, "stop": [g0[k:k + 2].tolist()]})
    pages0, pages1 = s0["pages"], s1["pages"]
    rec = {"shared_requests": SHARED_N, "shared_prefix": SHARED_PREFIX,
           "shared_tail": SHARED_TAIL, "new": NEW, "wall_s": wall,
           "prefix_hit_pages": (pages1["prefix_hit_pages"]
                                - pages0["prefix_hit_pages"]),
           "cow_admissions": (pages1["cow_admissions"]
                              - pages0["cow_admissions"]),
           "evictions": pages1["evictions"] - pages0["evictions"],
           "chunked_prompt": CHUNKED_PROMPT,
           "prefill_chunk": engine.prefill_chunk,
           "slots_decoding_at_its_submit": decoding_at_submit,
           "prefill_calls": s1["prefill_calls"] - s0["prefill_calls"],
           "admitted": s1["admitted"] - s0["admitted"],
           "stream_stop_at": k + 2,
           "stream_finish": frames[-1],
           "errors": errors}
    # prefill calls: the first request's whole prompt, the others' tails
    # past the shared pages, the long prompt, each in chunk slices
    chunk = engine.prefill_chunk
    want_calls = (-(-(SHARED_PREFIX + SHARED_TAIL) // chunk)
                  + (SHARED_N - 1) * -(-SHARED_TAIL // chunk)
                  + -(-CHUNKED_PROMPT // chunk))
    rec["prefill_calls_expected"] = want_calls
    stream_toks = [f["token"] for f in frames[:-1]]
    rec["ok"] = (not errors and len(out) == SHARED_N + 1
                 and rec["prefix_hit_pages"] > 0
                 and rec["cow_admissions"] > 0
                 and decoding_at_submit >= 1
                 and rec["prefill_calls"] == want_calls
                 and out["long"].shape == (1, CHUNKED_PROMPT + CHUNKED_NEW)
                 and frames[-1].get("finish_reason") == "stop"
                 and stream_toks == g0[:k + 2].tolist())
    return rec


def phase_main_path(torch):
    from veles_tpu_torch.ops.kernels import KERNELS
    from veles_tpu_torch.runtime.engine import DecodeEngine
    from veles_tpu_torch.runtime.restful import RestfulServer
    from veles_tpu_torch.runtime.snapshotter import params_from_jax
    from veles_tpu_torch.units.workflow import new_state

    wf = _workflow(torch, "bfloat16")
    flat = jax_layout_weights(wf, seed=0)
    wstate = new_state(params_from_jax(flat, wf, device=DEVICE), {}, {}, 0,
                       None)
    # the decode and prefill steps are captured when the engine is built
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
        scheduler = _scheduler_traffic(torch, engine, srv.port, rng, greedy)
        window_metrics, window = serving_window(torch, engine)
        profile = phase_profile(torch, engine)
        main_device_ms = _replay_ms(torch, engine)   # idle: slots retired
        mega, mega_engines = _megastep_phase(torch, wf, wstate, flat,
                                             prompts, greedy)
        spec, spec_engine = _spec_phase(torch, wf, wstate, engine)
        kv, kv_engine = _kv_phase(torch, wf, wstate, engine, srv.port)
        launches = {k.NAME: k.launches.count for k in KERNELS}
        variants = {k.NAME: k.launches.by_variant() for k in KERNELS
                    if k.launches.by_variant()}
        stats = engine.stats()
    finally:
        srv.stop()
        engine.stop()
    say({"phase": "http", "requests": {"sent": 3, "ok": 3, "failed": 0},
         "greedy_sha256": hashlib.sha256(greedy.astype(np.int32)
                                         .tobytes()).hexdigest(),
         "launches": launches, "variants": variants,
         "greedy_request_s": t_greedy,
         "predict_request_s": t_predict, "engine": stats})
    say({"phase": "serving_scheduler", **scheduler})
    say({"phase": "profile", **profile})
    say({"phase": "serving_megastep", **mega})
    say({"phase": "serving_spec", **spec})
    say({"phase": "serving_kv_transfer", **kv})

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
    if not scheduler["ok"]:
        fail(f"the scheduler traffic failed its checks: {scheduler}")
    from veles_tpu_torch.ops.kernels import flash_attention, paged_attention
    missing = [k.NAME for k in (flash_attention, paged_attention)
               if launches[k.NAME] < 1]
    if missing:
        fail(f"the serving path never launched {missing}")
    # one launch a layer a decode micro-step (a megastep dispatch runs
    # N, a verify dispatch K + 1), every engine of the serving phase, and
    # the eager warm-ups of each capture of the engines built after the
    # counters were reset
    per_step = _micro_steps(stats, False) + sum(
        _micro_steps(st, True) for st in [spec_engine, kv_engine]
        + mega_engines)
    if launches[paged_attention.NAME] != LAYERS * per_step:
        fail(f"paged decode launched {launches[paged_attention.NAME]} "
             f"times over the serving engines' {per_step} micro-steps of "
             f"{LAYERS} layers (want one a layer a micro-step)")
    comp = stats["compile"]
    if not (all(stats["capture"][k]["captured"]
                for k in ("decode", "decode_greedy", "prefill"))
            and comp["captures"] == comp["compiles"] == 3
            and comp["recompiles"] == 0):
        fail(f"decode (sampling and greedy-only) and prefill must be "
             f"captured once each, with no recapture: {stats['capture']} "
             f"{comp}")
    trace = profile["launch_trace"]
    if not (trace["ok"] and trace["captured"]
            and trace["per_replay"].get(paged_attention.NAME) == LAYERS):
        fail(f"the serving graphs' counted launches are not the kernels "
             f"the trace shows: {trace}")
    # the greedy request (SLOTS prompts of PROMPT, NEW new tokens) on the
    # captured engine; the profiled window on it and on an eager one
    say({"phase": "serving_metrics", "slots": SLOTS,
         "greedy_request": {"prompt": PROMPT, "new": NEW,
                            **_serve_metrics(stats_greedy, t_greedy)},
         "device_ms": main_device_ms,
         "window": {"prompt": WINDOW_PROMPT, "new": WINDOW_NEW,
                    "captured": {**window_metrics,
                                 "idle_share": profile["device_idle_share"]},
                    "eager": _eager_serving(torch, wf, wstate, window)}})
    say({"phase": "serving_capture_witness",
         **_serving_witness(torch, wf, wstate)})
    _serving_agreement(torch, wf, wstate, flat, prompts, greedy)
    return launches


def _micro_steps(st, warmups):
    """Decode micro-steps an engine ran (its ``stats()``): N a megastep
    dispatch, K + 1 a verify dispatch, and with ``warmups`` the eager
    warm-up steps ``StepCache`` runs before each capture."""
    from veles_tpu_torch.runtime.step_cache import WARMUP_STEPS
    k1 = st["spec"]["k"] + 1 if "spec" in st else 0
    n = st["decode_steps"] + k1 * (st["spec"]["verify_steps"] if k1 else 0)
    if warmups:
        per = {"decode": 1, "megastep": st.get("megastep", {}).get("n", 0),
               "verify": k1}
        n += WARMUP_STEPS * sum(
            per[name.removesuffix("_greedy")]
            for name, cap in st["capture"].items()
            if name != "prefill" and cap.get("captured"))
    return n


def _engine_metrics(engine, s0, s1, wall):
    """Serving metrics between two ``stats()`` of one engine."""
    steps = _step_times(engine, s0, s1)
    decode_s = s1["decode_seconds"] - s0["decode_seconds"]
    c0, c1 = _dispatch_counts(s0), _dispatch_counts(s1)
    return {"decode_tokens_per_s_all_slots":
                (s1["decode_tokens"] - s0["decode_tokens"]) / decode_s,
            "decode_step_s_p50": float(np.median(steps)),
            "decode_step_s_max": float(np.max(steps)),
            "decode_steps": s1["decode_steps"] - s0["decode_steps"],
            "dispatches": {k: c1[k] - c0[k] for k in c1},
            "wall_s": wall}


def _timed_generate(engine, prompts, new, **kw):
    s0 = engine.stats()
    t0 = time.perf_counter()
    toks = engine.generate(prompts, new, timeout=900, **kw)
    wall = time.perf_counter() - t0
    return toks, _engine_metrics(engine, s0, engine.stats(), wall)


def _decode_window(torch, engine, prompts, advance):
    """A profiled window of decode dispatches alone, on a stopped engine
    driven on this thread: ``prompts`` (SLOTS rows, PROFILE_NEW new
    tokens each) are admitted and prefilled before the window; in it,
    ``advance(engine, i)`` runs until every slot retired.  Device busy
    share and top kernels as :func:`phase_profile`'s; every counted
    launch held against the trace, the replays of each graph counted."""
    import threading
    from torch.profiler import ProfilerActivity, profile, schedule
    from veles_tpu_torch.ops.kernels import KERNELS
    engine._thread = threading.current_thread()    # submit() wants one
    try:
        reqs = [engine.submit(row, PROFILE_NEW) for row in prompts]
        engine._admit()
        while engine._chunking:
            engine._advance_prefills()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            torch.ones(1, device=engine.device).sum()
            torch.cuda.synchronize()
            prof.step()
            _settle(torch)
            counted0 = {k.NAME: k.launches.state() for k in KERNELS}
            s0 = engine.stats()
            t0 = time.perf_counter()
            i = 0
            while engine._active.any():
                advance(engine, i)
                i += 1
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            s1 = engine.stats()
    finally:
        engine._thread = None
    if not all(r.done.is_set() and r.error is None for r in reqs):
        fail("a profiled decode window's request did not finish")
    c0, c1 = _dispatch_counts(s0), _dispatch_counts(s1)
    rec = _busy(prof, wall, f"{len(prompts)} x decode {PROFILE_NEW - 1} "
                            "after the prefill")
    rec["replays"] = {k: c1[k] - c0[k] for k in engine._fns}
    rec["launch_trace"] = _launch_trace_check(prof, counted0, [
        (engine._fns[k], n) for k, n in rec["replays"].items()])
    return rec


def _replay_ms(torch, engine):
    """Device milliseconds of one replay of each captured token-step
    graph of an idle engine (sampling and greedy-only) (CUDA events over back-to-back replays; the
    kernels are the same whatever the slots hold, and the launch
    counters do not move), the host wall of one replay launched on an
    idle card, and the device milliseconds of the sampler alone at the
    decode step's shape, captured the same way."""
    from veles_tpu_torch.runtime.generate import (gumbel_noise,
                                                  sample_slots)
    out = {}
    for kind in engine._fns:
        if kind == "prefill":
            continue
        graph = engine._fns[kind].graph
        out[f"{kind}_replay_ms"] = cuda_ms(torch, graph.replay)
        # one replay from an idle card, as a dispatch runs it: host wall
        # from the launch to the end of its work
        walls = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph.replay()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[f"{kind}_replay_wall_ms"] = float(np.median(walls)) * 1e3
    dev = engine.device
    logits = torch.randn(SLOTS, VOCAB, device=dev)
    temp = torch.full((SLOTS,), 0.8, device=dev)
    topk = torch.full((SLOTS,), 50, dtype=torch.int64, device=dev)
    topp = torch.full((SLOTS,), 0.95, device=dev)
    keys = torch.arange(SLOTS, dtype=torch.int64, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sample_slots(logits, temp, topk, topp, gumbel_noise(keys, VOCAB))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sample_slots(logits, temp, topk, topp, gumbel_noise(keys, VOCAB))
    out["sampler_ms"] = cuda_ms(torch, graph.replay)
    return out


def _megastep_phase(torch, wf, wstate, flat, prompts, greedy):
    """Megastep N=MEGASTEP_N: the greedy SLOTS x (PROMPT + NEW) request
    on a fresh captured megastep engine, its tokens bitwise the N=1
    engine's (``greedy``), then the profiled window on it (its
    megastep replays' paged launches held against the trace), and on a
    fresh N=1 engine built the same way; the same request in float32 on
    an N=1 and an N=MEGASTEP_N engine, tokens bitwise.  Returns the
    record and the engines' last stats."""
    from veles_tpu_torch.ops.kernels import paged_attention
    from veles_tpu_torch.runtime.engine import DecodeEngine
    from veles_tpu_torch.runtime.snapshotter import params_from_jax
    from veles_tpu_torch.units.workflow import new_state

    def build(wf_, ws_, n):
        return DecodeEngine(wf_, ws_, slots=SLOTS, l_max=L_MAX,
                            page_size=PAGE, paged=True, paged_kernel=True,
                            window_ms=2.0, megastep=n, device=DEVICE)

    eng = build(wf, wstate, MEGASTEP_N)
    window = np.random.default_rng(12).integers(
        0, VOCAB, (SLOTS, PROFILE_PROMPT)).astype(np.int32)
    # the same decode window as N=1 steps and as one megastep
    profile_n1 = _decode_window(torch, eng, window,
                                lambda e, i: e._step_once())
    profile = _decode_window(torch, eng, window,
                             lambda e, i: e._advance_once())
    eng.start()
    try:
        toks, metrics = _timed_generate(eng, prompts, NEW)
        st = eng.stats()
    finally:
        eng.stop()
    replays = _replay_ms(torch, eng)
    # the same request on a fresh N=1 engine, built as this one was
    n1 = build(wf, wstate, 1).start()
    try:
        n1_toks, n1_metrics = _timed_generate(n1, prompts, NEW)
        n1_stats = n1.stats()
    finally:
        n1.stop()
    wf32 = _workflow(torch, None)
    ws32 = new_state(params_from_jax(flat, wf32, device=DEVICE), {}, {}, 0,
                     None)
    f32, f32_stats = {}, []
    for n in (1, MEGASTEP_N):
        e = build(wf32, ws32, n).start()
        try:
            f32[n] = _timed_generate(e, prompts, NEW)
            f32_stats.append(e.stats())
        finally:
            e.stop()
    trace = profile["launch_trace"]
    paged = paged_attention.NAME
    rec = {"n": MEGASTEP_N, "prompt": PROMPT, "new": NEW,
           "bf16": metrics, "bf16_n1": n1_metrics, "mega_dispatches":
               st["megastep"]["mega_dispatches"],
           "tokens_equal_n1_bf16": bool(np.array_equal(toks, greedy)
                                        and np.array_equal(n1_toks, greedy)),
           "f32": {"n1": f32[1][1], "megastep": f32[MEGASTEP_N][1]},
           "tokens_equal_n1_f32": bool(np.array_equal(
               f32[1][0], f32[MEGASTEP_N][0])),
           "idle_share": profile["device_idle_share"],
           "idle_share_n1": profile_n1["device_idle_share"],
           "device_ms": replays,
           "profile": profile, "profile_n1": profile_n1,
           "compile": st["compile"]}
    rec["ok"] = (rec["tokens_equal_n1_bf16"] and rec["tokens_equal_n1_f32"]
                 and rec["mega_dispatches"] > 0
                 and st["capture"]["megastep"]["captured"]
                 and st["capture"]["megastep_greedy"]["captured"]
                 and st["compile"]["captures"] == 5
                 and st["compile"]["recompiles"] == 0
                 and trace["ok"] and trace["captured"]
                 and profile["replays"]["megastep_greedy"] == 1
                 and trace["per_replay_by_kind"]["megastep"].get(paged)
                 == LAYERS * MEGASTEP_N
                 and trace["replayed"].get(paged)
                 == trace["counted"].get(paged)
                 and profile_n1["launch_trace"]["ok"]
                 and profile_n1["replays"]["decode_greedy"]
                 == PROFILE_NEW - 1)
    if not rec["ok"]:
        fail(f"the megastep checks failed: {rec}")
    return rec, [st, n1_stats] + f32_stats


def _driven_run(torch, engine, prompts, new, kws, advance):
    """``prompts`` submitted together to a stopped engine and driven on
    this thread: admitted and prefilled, then ``advance(engine, i)``
    until every slot retired (the timed part).  Returns the tokens, the
    engine's stats before and after the timed part, and its wall."""
    import threading
    engine._thread = threading.current_thread()    # submit() wants one
    try:
        reqs = [engine.submit(p, new, **kw) for p, kw in zip(prompts, kws)]
        engine._admit()
        while engine._chunking:
            engine._advance_prefills()
        torch.cuda.synchronize()
        s0 = engine.stats()
        t0 = time.perf_counter()
        i = 0
        while engine._active.any():
            advance(engine, i)
            i += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s1 = engine.stats()
    finally:
        engine._thread = None
    if not all(r.done.is_set() and r.error is None for r in reqs):
        fail("a driven run's request did not finish")
    return np.stack([r.result for r in reqs]), s0, s1, wall


def _verify_always(e, i):
    """A verify dispatch of the drafter's proposals where it has any (an
    empty draft advances every slot by its bonus token)."""
    draft = e._spec_drafts()
    e._verify_once(draft if draft is not None else
                   np.full((e.slots, e.spec_k), -1, np.int32))


def _spec_phase(torch, wf, wstate, engine):
    """Speculative verify k=SPEC_K on a fresh captured engine: SLOTS
    prompts of a repeated SPEC_PHRASE-token phrase, SPEC_NEW tokens each
    (the last row sampled), first under the engine's own policy from
    cold (random weights do not follow the phrase, so the policy parks
    after its first verify), then timed under a fixed policy of one
    verify dispatch every iteration and of decode steps alone; every
    run's tokens must be bitwise the non-spec ``engine``'s on the same
    requests.  Then a profiled window driven on this thread with one
    verify dispatch, its paged launches held against the trace."""
    from veles_tpu_torch.ops.kernels import paged_attention
    from veles_tpu_torch.runtime.engine import DecodeEngine
    rng = np.random.default_rng(21)
    phrases = rng.integers(0, VOCAB, (SLOTS, SPEC_PHRASE))
    prompts = np.stack([np.resize(p, SPEC_PROMPT) for p in phrases]
                       ).astype(np.int32)
    kws = [{}] * (SLOTS - 1) + [dict(temperature=0.8, top_k=50, seed=7)]

    def run(eng):
        t0 = time.perf_counter()
        reqs = [eng.submit(p, SPEC_NEW, **kw) for p, kw in zip(prompts, kws)]
        for r in reqs:
            if not r.done.wait(900) or r.error is not None:
                fail(f"a speculative-phase request failed: {r.error}")
        return np.stack([r.result for r in reqs]), time.perf_counter() - t0

    def verify_first(e, i):
        # one verify dispatch, then decode steps
        if i == 0:
            _verify_always(e, i)
        else:
            e._step_once()

    eng = DecodeEngine(wf, wstate, slots=SLOTS, l_max=L_MAX,
                       page_size=PAGE, paged=True, paged_kernel=True,
                       window_ms=2.0, spec=True, spec_k=SPEC_K,
                       device=DEVICE).start()
    try:
        s0 = eng.stats()
        toks, wall = run(eng)
        s1 = eng.stats()
        ratio = eng._verify_wall_ewma / max(eng._step_wall_ewma, 1e-12)
    finally:
        eng.stop()
    # the timed part: the same requests under a fixed policy, every
    # dispatch a verify, then every dispatch a decode step
    vtoks, v0, v1, vwall = _driven_run(torch, eng, prompts, SPEC_NEW, kws,
                                       _verify_always)
    dtoks, d0, d1, dwall = _driven_run(torch, eng, prompts, SPEC_NEW, kws,
                                       lambda e, i: e._step_once())
    # the profiled window, driven on this thread
    profile = _decode_window(
        torch, eng, np.stack([np.resize(p, 2 * SPEC_PHRASE)
                              for p in phrases]).astype(np.int32),
        verify_first)
    s2 = eng.stats()
    replays = _replay_ms(torch, eng)
    ref, ref_wall = run(engine)
    sp0, sp1 = v0["spec"], v1["spec"]
    verify = sp1["verify_steps"] - sp0["verify_steps"]
    proposed = sp1["proposed"] - sp0["proposed"]
    accepted = sp1["accepted"] - sp0["accepted"]
    vsec = sp1["verify_seconds"] - sp0["verify_seconds"]
    decode_n = (_kind_count(_dispatch_counts(d1), "decode")
                - _kind_count(_dispatch_counts(d0), "decode"))
    decode_s = d1["decode_seconds"] - d0["decode_seconds"]
    pol0, pol1 = s0["spec"], s1["spec"]
    trace = profile["launch_trace"]
    paged = paged_attention.NAME
    rec = {"k": SPEC_K, "prompt": SPEC_PROMPT, "phrase": SPEC_PHRASE,
           "new": SPEC_NEW, "sampled_rows": 1,
           "policy": {
               "verify_steps": pol1["verify_steps"] - pol0["verify_steps"],
               "proposed": pol1["proposed"] - pol0["proposed"],
               "accepted": pol1["accepted"] - pol0["accepted"],
               "verify_over_decode_wall_ewma": ratio,
               "wall_s": wall, "non_spec_wall_s": ref_wall,
               "decode_tokens_per_s_all_slots":
                   ((s1["decode_tokens"] - s0["decode_tokens"])
                    / (s1["decode_seconds"] - s0["decode_seconds"])),
               "tokens_equal_non_spec": bool(np.array_equal(toks, ref))},
           "verify_steps": verify, "decode_steps": decode_n,
           "proposed": proposed, "accepted": accepted,
           "accept_rate": accepted / proposed if proposed else None,
           "tokens_per_verify": ((sp1["emitted"] - sp0["emitted"]) / verify
                                 if verify else None),
           "verify_wall_ms_mean": vsec / verify * 1e3 if verify else None,
           "decode_wall_ms_mean": (decode_s / decode_n * 1e3
                                   if decode_n else None),
           "verify_over_decode_wall": ((vsec / verify) / (decode_s / decode_n)
                                       if verify and decode_n else None),
           "verify_run_wall_s": vwall, "decode_run_wall_s": dwall,
           "verify_run_replays": {k: v - v0["replays"][k]
                                  for k, v in v1["replays"].items()},
           "tokens_equal_non_spec": bool(np.array_equal(toks, ref)
                                         and np.array_equal(vtoks, ref)
                                         and np.array_equal(dtoks, ref)),
           "device_ms": replays,
           "profile": profile, "compile": s2["compile"]}
    rec["ok"] = (rec["tokens_equal_non_spec"]
                 and profile["replays"]["verify_greedy"] == 1
                 and s2["capture"]["verify"]["captured"]
                 and s2["capture"]["verify_greedy"]["captured"]
                 and s2["compile"]["captures"] == 5
                 and s2["compile"]["recompiles"] == 0
                 and trace["ok"] and trace["captured"]
                 and trace["per_replay_by_kind"]["verify"].get(paged)
                 == LAYERS * (SPEC_K + 1)
                 and trace["replayed"].get(paged)
                 == trace["counted"].get(paged)
                 and rec["policy"]["verify_steps"] > 0
                 and verify >= SPEC_NEW // (SPEC_K + 1)
                 and v1["dispatches"] - v0["dispatches"] == verify
                 and _kind_count(rec["verify_run_replays"], "verify")
                 == verify
                 and decode_n == d1["dispatches"] - d0["dispatches"])
    if not rec["ok"]:
        fail(f"the speculative checks failed: {rec}")
    return rec, s2


def _http_bytes(port, path, data=None, method=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read()


def _kv_phase(torch, wf, wstate, engine, port):
    """VTKV1 over REST: ``engine`` (A) prefills a KV_PROMPT-token prompt,
    ``GET /kv/pages?hashes=`` exports its pages and ``PUT /kv/pages``
    imports them into a fresh captured engine B on the same weights; a
    request of that prompt and a KV_TAIL-token tail must hit every
    shared page on B, prefill only the tail there, and give A's greedy
    tokens bit for bit (float32 pools); a corrupted blob must get 400
    with B's pool unchanged."""
    from veles_tpu_torch.runtime.engine import (DecodeEngine,
                                                prefix_page_hashes)
    from veles_tpu_torch.runtime.restful import RestfulServer
    rng = np.random.default_rng(31)
    shared = rng.integers(0, VOCAB, KV_PROMPT).astype(np.int32)
    full = np.concatenate([shared, rng.integers(0, VOCAB, KV_TAIL)
                           ]).astype(np.int32)[None]
    engine.generate(shared[None], 2, timeout=900)
    hashes = prefix_page_hashes(shared, PAGE)
    t0 = time.perf_counter()
    code, blob = _http_bytes(port, "/kv/pages?hashes="
                             + ",".join(h.hex() for h in hashes))
    t_export = time.perf_counter() - t0
    if code != 200:
        fail(f"GET /kv/pages answered {code}: {blob[:300]}")
    ref = engine.generate(full, KV_NEW, timeout=900)
    b = DecodeEngine(wf, wstate, slots=SLOTS, l_max=L_MAX, page_size=PAGE,
                     paged=True, paged_kernel=True, window_ms=2.0,
                     device=DEVICE)
    srv = RestfulServer(wf.make_predict_step(), wstate, PREDICT_B,
                        (PREDICT_T,), port=0, workflow=wf, engine=b,
                        device=DEVICE)
    b.start()
    srv.start()
    try:
        pools = {(n, k): t.clone() for n, c in b._caches.items()
                 for k, t in c.items()}
        bad = bytearray(blob)
        bad[-1] ^= 0xFF
        bad_code, bad_body = _http_bytes(srv.port, "/kv/pages", bytes(bad),
                                         "PUT")
        torch.cuda.synchronize()
        untouched = all(torch.equal(b._caches[n][k], t)
                        for (n, k), t in pools.items())
        del pools
        t0 = time.perf_counter()
        code, body = _http_bytes(srv.port, "/kv/pages", blob, "PUT")
        t_import = time.perf_counter() - t0
        if code != 200:
            fail(f"PUT /kv/pages answered {code}: {body[:300]}")
        s0 = b.stats()
        got = b.generate(full, KV_NEW, timeout=900)
        s1 = b.stats()
    finally:
        srv.stop()
        b.stop()
    n = len(hashes)
    rec = {"prompt": KV_PROMPT, "tail": KV_TAIL, "new": KV_NEW,
           "pages": n, "blob_bytes": len(blob),
           "bytes_per_page": len(blob) / n,
           "export_ms_per_page": t_export / n * 1e3,
           "import_ms_per_page": t_import / n * 1e3,
           "imported": json.loads(body)["imported"],
           "prefix_hit_pages": (s1["pages"]["prefix_hit_pages"]
                                - s0["pages"]["prefix_hit_pages"]),
           "remote_hit_pages": s1["kv_transfer"]["remote_hit_pages"],
           "prefill_tokens": s1["prefill_tokens"] - s0["prefill_tokens"],
           "tokens_equal_a": bool(np.array_equal(got, ref)),
           "corrupt_status": bad_code,
           "corrupt_pool_unchanged": untouched,
           "compile": s1["compile"]}
    rec["ok"] = (rec["imported"] == n == KV_PROMPT // PAGE
                 and rec["prefix_hit_pages"] == n
                 and rec["remote_hit_pages"] == n
                 and rec["prefill_tokens"] == KV_TAIL
                 and rec["tokens_equal_a"] and bad_code == 400
                 and b"integrity" in bad_body and untouched
                 and s1["compile"]["recompiles"] == 0)
    if not rec["ok"]:
        fail(f"the VTKV1 round trip failed its checks: {rec}")
    return rec, s1


def _eager_serving(torch, wf, wstate, window):
    """The serving window and the profiled one again on an engine whose
    steps run eagerly (``capture=False``): its metrics and idle share,
    and its tokens against the captured engine's."""
    from veles_tpu_torch.runtime.engine import DecodeEngine
    eng = DecodeEngine(wf, wstate, slots=SLOTS, l_max=L_MAX,
                       page_size=PAGE, paged=True, paged_kernel=True,
                       window_ms=2.0, capture=False, device=DEVICE).start()
    try:
        metrics, tokens = serving_window(torch, eng)
        profile = phase_profile(torch, eng)
    finally:
        eng.stop()
    if eng.stats()["capture"]["decode"]["reason"] != "capture=False":
        fail(f"the eager engine captured: {eng.stats()['capture']}")
    if not np.array_equal(tokens, window):
        r, t = (int(x) for x in np.argwhere(tokens != window)[0])
        fail(f"the eager and the captured engine disagree at row {r}, "
             f"position {t}")
    # reported, not held: the trace of the eager window has dropped a
    # kernel launch of the scheduler thread (27 of 28 in one run)
    return {"mode": "eager", **metrics,
            "idle_share": profile["device_idle_share"],
            "tokens_equal_captured": True,
            "launch_trace": profile["launch_trace"]}


def _drive(torch, engine, script, iters):
    """The scheduler's iteration (admit, one chunk slice, one decode
    step) run on this thread ``iters`` times, ``script[i]``'s requests
    submitted before iteration i: the same calls in the same order on
    every engine, so page allocation and every input repeat exactly."""
    import threading
    engine._thread = threading.current_thread()    # submit() wants one
    reqs = []
    try:
        for i in range(iters):
            for prompt, n, kw in script.get(i, ()):
                reqs.append(engine.submit(prompt, n, **kw))
            engine._admit()
            engine._advance_prefills()
            if engine._active.any():
                engine._step_once()
    finally:
        engine._thread = None
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return reqs


def _serving_witness(torch, wf, wstate):
    """Captured against eager serving, bit for bit: WITNESS_ITERS
    scheduler iterations on two fresh engines, with admissions (a prefix
    hit, a chunked prompt, a sampled row) and retirements mid-flight;
    every request's tokens, the token rows and the KV pool must be
    equal."""
    from veles_tpu_torch.runtime.engine import DecodeEngine
    rng = np.random.default_rng(5)
    sysp = rng.integers(0, VOCAB, 64)
    script = {0: [(rng.integers(0, VOCAB, 40), 24, {}),
                  (np.concatenate([sysp, rng.integers(0, VOCAB, 9)]), 40,
                   {})],
              3: [(rng.integers(0, VOCAB, 20), 8,
                   dict(temperature=0.8, top_k=50, seed=3))],
              9: [(np.concatenate([sysp, rng.integers(0, VOCAB, 5)]), 16,
                   {})],
              12: [(rng.integers(0, VOCAB, 300), 12, {})]}
    runs = {}
    for capture in (True, False):
        eng = DecodeEngine(wf, wstate, slots=SLOTS, l_max=L_MAX,
                           page_size=PAGE, paged=True, paged_kernel=True,
                           window_ms=0.0, capture=capture, device=DEVICE)
        t0 = time.perf_counter()
        reqs = _drive(torch, eng, script, WITNESS_ITERS)
        runs[capture] = (eng, reqs, time.perf_counter() - t0)
    (cap, creqs, cwall), (eag, ereqs, ewall) = runs[True], runs[False]
    done = [a.done.is_set() and b.done.is_set() for a, b in zip(creqs,
                                                                ereqs)]
    tokens_equal = all(np.array_equal(a.result, b.result)
                       for a, b, d in zip(creqs, ereqs, done) if d)
    pools_equal = all(torch.equal(cap._caches[n][k], eag._caches[n][k])
                      for n in cap._caches for k in ("k", "v"))
    st = cap.stats()
    rec = {"iterations": WITNESS_ITERS, "requests": len(creqs),
           "retired": sum(done),
           "decode_steps": st["decode_steps"],
           "prefill_calls": st["prefill_calls"],
           "prefix_hit_pages": st["pages"]["prefix_hit_pages"],
           "captured": st["capture"],
           "eager_reason": eag.stats()["capture"]["decode"]["reason"],
           "tokens_equal": tokens_equal,
           "token_rows_equal": bool(np.array_equal(cap._toks, eag._toks)),
           "pools_equal": pools_equal,
           "captured_wall_s": cwall, "eager_wall_s": ewall}
    rec["ok"] = (tokens_equal and pools_equal and rec["token_rows_equal"]
                 and sum(done) >= 2 and rec["prefix_hit_pages"] > 0
                 and st["prefill_calls"] > st["admitted"]
                 and st["capture"]["decode"]["captured"]
                 and st["capture"]["prefill"]["captured"])
    if not rec["ok"]:
        fail(f"captured serving is not eager serving bit for bit: {rec}")
    return rec


def _first_diff(a, b):
    d = np.argwhere(a != b)
    return None if not len(d) else int(d[0][0])


def _serving_agreement(torch, wf, wstate, flat, prompts, greedy):
    """Greedy agreement with the port's generate() (dense cache, no
    kernel): bf16 reported, with the first position where row 0 parts
    from generate() through the paged kernel and through the gather read
    path; float32 required token for token; and a float32 engine whose
    pool is too small for its queue, where a class-0 request preempts a
    class-2 one whose tokens must equal its uninterrupted run (the same
    request alone on that engine)."""
    from veles_tpu_torch.runtime.engine import DecodeEngine
    from veles_tpu_torch.runtime.generate import generate
    from veles_tpu_torch.runtime.snapshotter import params_from_jax
    from veles_tpu_torch.units.workflow import new_state
    ref = generate(wf, wstate, prompts, NEW).cpu().numpy()
    bf16_share = float(np.mean(ref[:, PROMPT:] == greedy[:, PROMPT:]))
    gather = DecodeEngine(wf, wstate, slots=SLOTS, l_max=L_MAX,
                          page_size=PAGE, paged=True, paged_kernel=False,
                          window_ms=2.0, device=DEVICE).start()
    try:
        g_gather = gather.generate(prompts, NEW, timeout=900)
    finally:
        gather.stop()
    gather_share = float(np.mean(ref[:, PROMPT:] == g_gather[:, PROMPT:]))
    # where one row parts: through the kernel or the gather read path,
    # and against generate() of that row alone (batch 1, as the engine's
    # prefill), which separates the read path from the batch shape
    parting = [r for r in range(SLOTS)
               if _first_diff(greedy[r, PROMPT:], ref[r, PROMPT:])
               is not None]
    r = parting[0] if parting else 0
    ref1 = generate(wf, wstate, prompts[r:r + 1], NEW).cpu().numpy()[0]
    parts = {"rows_parting": parting, "row": r,
             "kernel_vs_generate": _first_diff(greedy[r, PROMPT:],
                                               ref[r, PROMPT:]),
             "gather_vs_generate": _first_diff(g_gather[r, PROMPT:],
                                               ref[r, PROMPT:]),
             "kernel_vs_gather": _first_diff(greedy[r, PROMPT:],
                                             g_gather[r, PROMPT:]),
             "kernel_vs_generate_row_alone": _first_diff(
                 greedy[r, PROMPT:], ref1[PROMPT:]),
             "generate_batch_vs_row_alone": _first_diff(ref[r, PROMPT:],
                                                        ref1[PROMPT:])}
    # float32 model on the same weights: engine (paged kernel) vs
    # generate() on a shorter prompt, must agree
    wf32 = _workflow(torch, None)
    ws32 = new_state(params_from_jax(flat, wf32, device=DEVICE), {}, {}, 0,
                     None)
    eng32 = DecodeEngine(wf32, ws32, slots=SLOTS, l_max=L_MAX,
                         page_size=PAGE, paged=True, paged_kernel=True,
                         pages=PREEMPT_POOL, window_ms=0.0,
                         device=DEVICE).start()
    short = prompts[:, :F32_PROMPT]
    rng = np.random.default_rng(9)
    vic_p = rng.integers(0, VOCAB, PREEMPT_PROMPT).astype(np.int32)
    hi_p = rng.integers(0, VOCAB, PREEMPT_PROMPT).astype(np.int32)
    try:
        e32 = eng32.generate(short, F32_NEW, timeout=900)
        victim = eng32.submit(vic_p, PREEMPT_VICTIM_NEW, priority=2)
        deadline = time.monotonic() + 300
        while victim.first_token_at is None and time.monotonic() < deadline:
            time.sleep(0.001)
        high = eng32.submit(hi_p, NEW, priority=0)
        if not (victim.done.wait(900) and high.done.wait(900)):
            fail("the preemption requests did not finish")
        pre = eng32.stats()
        # the victim's uninterrupted run: the same request alone
        alone = eng32.submit(vic_p, PREEMPT_VICTIM_NEW, priority=2)
        if not alone.done.wait(900) or alone.error is not None:
            fail(f"the victim's uninterrupted run failed: {alone.error}")
        vic_ref = alone.result
    finally:
        eng32.stop()
    g32 = generate(wf32, ws32, short, F32_NEW).cpu().numpy()
    f32_share = float(np.mean(e32[:, F32_PROMPT:] == g32[:, F32_PROMPT:]))
    differ = np.argwhere(e32[:, F32_PROMPT:] != g32[:, F32_PROMPT:])
    preempt = {"pool_pages": PREEMPT_POOL, "victim_class": 2,
               "victim_prompt": PREEMPT_PROMPT,
               "victim_new": PREEMPT_VICTIM_NEW,
               "preemptions": pre["admission"]["preemptions"],
               "victim_preemptions": victim.preemptions,
               "victim_error": repr(victim.error),
               "high_error": repr(high.error),
               "victim_equals_uninterrupted": bool(
                   victim.error is None
                   and np.array_equal(victim.result, vic_ref)),
               "victim_first_diff": (None if victim.error is not None
                                     else _first_diff(victim.result,
                                                      vic_ref)),
               "captures": pre["compile"]["captures"],
               "recompiles": pre["compile"]["recompiles"]}
    agreement = {"bf16_engine_vs_generate_share": bf16_share,
                 "bf16_gather_engine_vs_generate_share": gather_share,
                 "bf16_first_differing_position": parts,
                 "f32_engine_vs_generate_share": f32_share,
                 "bf16_prompt": PROMPT, "bf16_new": NEW,
                 "f32_prompt": F32_PROMPT, "f32_new": F32_NEW,
                 "f32_preemption": preempt}
    say({"phase": "agreement", **agreement})
    if len(differ):
        r, t = (int(x) for x in differ[0])
        fail(f"float32 engine and generate() disagree at row {r}, "
             f"generated position {t} (engine {int(e32[r, F32_PROMPT + t])}"
             f", generate() {int(g32[r, F32_PROMPT + t])}): {agreement}")
    if not (preempt["victim_preemptions"] >= 1
            and preempt["victim_equals_uninterrupted"]
            and high.error is None and preempt["recompiles"] == 0):
        fail(f"the float32 preemption check failed: {preempt}")


def _train_workflow(torch, compute_dtype, lr=1e-3):
    from veles_tpu_torch.models.standard import StandardWorkflow
    return StandardWorkflow({"name": "bench_lm", "layers": bench_layers(),
                             "compute_dtype": compute_dtype,
                             "optimizer": "adam",
                             "optimizer_args": {"lr": lr},
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
        # a captured step's metrics are its graph's outputs: read now
        losses.append(float(mets["loss"]))
        return wstate, mets

    # the trainer stages batches for a captured step (see Trainer._batches)
    timed_step.captured = getattr(inner, "captured", False)
    trainer._train_step = timed_step
    try:
        t0 = time.perf_counter()
        results = trainer.run()
        wall = time.perf_counter() - t0
    finally:
        trainer._train_step = inner
    return {"trainer": trainer, "results": results, "wall": wall,
            "data_s": t_data, "step_s": step_s, "losses": losses,
            "launches": {k.NAME: k.launches.count for k in KERNELS},
            "variants": {k.NAME: k.launches.by_variant() for k in KERNELS
                         if k.launches.by_variant()},
            "step_cache": trainer.step_cache.stats()}


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
           "variants": run["variants"], "step_cache": run["step_cache"]}
    say(rec)
    path_kernels = (flash_attention, flash_bwd_dq, flash_bwd_dkv,
                    gather_rows)
    missing = [k.NAME for k in path_kernels if launches[k.NAME] < 1]
    if missing:
        fail(f"the training path never launched {missing}")
    st = run["step_cache"]
    if not (st["train"]["captured"] and st["eval"]["captured"]
            and st["captures"] == st["compiles"] == 2
            and st["recompiles"] == 0):
        fail(f"the LM steps were not captured once each: {st}")
    # one batch gather a train step and an eval batch, nothing else
    batches = steps + N_VALID // TRAIN_B
    if run["variants"].get(gather_rows.NAME) != {"batch": batches}:
        fail(f"the LM epoch launched {run['variants'].get(gather_rows.NAME)}"
             f" gathers, not one batch gather for each of {batches} "
             "batches")
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
    trace = profile["launch_trace"]
    if not (trace["ok"] and trace["captured"] and trace["per_replay"]):
        fail(f"the captured steps' counted launches are not the kernels "
             f"the trace shows: {trace}")
    host = _gather_host_time(torch, trainer)
    say({"phase": "train_gather_host", **host})
    say({"phase": "train_relu_backward", **_relu_backward_timing(torch)})
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
    del trainer, run
    torch.cuda.empty_cache()
    for dtype in ("bfloat16", None):
        eager = _capture_witness(torch, dtype)
        say({"phase": "train_capture_witness", **eager})
        if not eager["ok"]:
            fail(f"the captured steps differ from the eager ones: {eager}")
    rollback = _rollback_check(torch)
    say({"phase": "train_rollback", **rollback})
    if not rollback["ok"]:
        fail(f"a Decision rollback recaptured or did not roll back: "
             f"{rollback}")
    return launches


def _witness_trainer(torch, dtype, capture, n_steps, lr=1e-3,
                     decision=None):
    """A full-width LM trainer over a card-resident loader of ``n_steps``
    train batches and one valid batch, Adam at ``lr``, capture on or
    off."""
    from veles_tpu_torch.models.lm import InductionLoader
    from veles_tpu_torch.runtime.decision import Decision
    from veles_tpu_torch.runtime.step_cache import StepCache
    loader = InductionLoader(minibatch_size=TRAIN_B,
                             n_train=n_steps * TRAIN_B, n_valid=TRAIN_B,
                             seq_len=TRAIN_T, vocab=VOCAB, per_position=True,
                             device=DEVICE)
    sw = _train_workflow(torch, dtype, lr)
    return sw.make_trainer(loader, decision or Decision(max_epochs=1),
                           device=DEVICE,
                           step_cache=StepCache(capture=capture))


def _state_diff(torch, a, b):
    """Names of the state leaves (params, optimizer state, unit state)
    where two workflow states differ in any bit."""
    from veles_tpu_torch.runtime.snapshotter import _flatten
    fa = _flatten({k: a[k] for k in ("params", "opt_state", "state")})
    fb = _flatten({k: b[k] for k in ("params", "opt_state", "state")})
    return sorted(k for k in set(fa) | set(fb)
                  if k not in fa or k not in fb
                  or fa[k].tobytes() != fb[k].tobytes())


def _capture_witness(torch, dtype):
    """WITNESS_STEPS steps and an eval from one init and one batch order,
    through the eager step (``StepCache(capture=False)``) and the captured
    one: parameters, optimizer and unit state, and the epoch sums, bit
    for bit; each side's median step, and (bf16) its idle share over 3
    profiled steps.  Where the two differ, a second eager run says whether
    the eager step itself repeats."""
    from veles_tpu_torch.runtime.snapshotter import wstate_to_numpy
    runs, states = {}, {}
    for capture in (False, True):
        run = _counted_run(torch, _witness_trainer(
            torch, dtype, capture, WITNESS_STEPS), 0.0)
        trainer = run["trainer"]
        states[capture] = wstate_to_numpy(trainer.wstate)
        runs[capture] = {
            "step_ms_median": float(np.median(run["step_s"])) * 1e3,
            "step_ms": [x * 1e3 for x in run["step_s"]],
            "epoch": trainer.decision.history[0],
            "step_cache": run["step_cache"]}
        if dtype == "bfloat16":
            prof = _train_profile(torch, trainer)
            runs[capture]["idle_share"] = prof["device_idle_share"]
            runs[capture]["launch_trace_ok"] = prof["launch_trace"]["ok"]
            runs[capture]["device_busy_ms_per_step"] = (
                prof["device_busy_s"] / 3 * 1e3
                if prof["device_busy_s"] is not None else None)
        del trainer, run
        torch.cuda.empty_cache()
    diff = _state_diff(torch, states[False], states[True])
    sums_equal = runs[False]["epoch"] == runs[True]["epoch"]
    rec = {"dtype": dtype or "float32", "steps": WITNESS_STEPS,
           "eager": runs[False], "captured": runs[True],
           "state_leaves_differing": diff, "epoch_sums_equal": sums_equal,
           "captured_ok": runs[True]["step_cache"]["train"]["captured"]
           and runs[True]["step_cache"]["eval"]["captured"]}
    if diff or not sums_equal:
        again = _counted_run(torch, _witness_trainer(
            torch, dtype, False, WITNESS_STEPS), 0.0)
        rec["eager_repeat_leaves_differing"] = _state_diff(
            torch, states[False], wstate_to_numpy(again["trainer"].wstate))
        del again
        torch.cuda.empty_cache()
    rec["ok"] = (rec["captured_ok"] and not diff and sums_equal
                 and all(r.get("launch_trace_ok", True)
                         for r in runs.values()))
    return rec


def _rollback_check(torch):
    """The Decision's rollback through the loop of a captured full-width
    trainer: Adam at lr 0 over 2 epochs of 2 steps, ``rollback_after=1``,
    so epoch 1 repeats epoch 0's validation error and rolls back; the lr
    multiplier lands in the captured state's opt_state scalar, and the
    cache shows 2 captures, no hit and no recapture."""
    from veles_tpu_torch.ops.optimizers import LR_MULT_KEY
    from veles_tpu_torch.runtime.decision import Decision
    dec = Decision(max_epochs=2, fail_iterations=10, rollback_after=1)
    trainer = _witness_trainer(torch, "bfloat16", True, 2, lr=0.0,
                               decision=dec)
    trainer.initialize(seed=0)
    mult = trainer.wstate["opt_state"][LR_MULT_KEY]
    trainer.run()
    st = trainer.step_cache.stats()
    rec = {"step_cache": st, "lr_multiplier": dec.lr_multiplier,
           "opt_state_lr_mult": float(mult),
           "same_tensor": trainer.wstate["opt_state"][LR_MULT_KEY] is mult,
           "history": [h["valid"] for h in dec.history]}
    rec["ok"] = (st["captures"] == st["compiles"] == 2
                 and st["recompiles"] == 0
                 and st["hits"] == 0 and st["train"]["captured"]
                 and st["eval"]["captured"] and dec.lr_multiplier == 0.5
                 and rec["opt_state_lr_mult"] == 0.5 and rec["same_tensor"])
    del trainer
    torch.cuda.empty_cache()
    return rec


def _relu_backward_timing(torch):
    """What ReLU's JAX tie gradient (0.5 at exactly 0: ``heaviside`` and
    a product) costs beside ``clamp_min``'s own backward (one
    ``threshold_backward``), each a forward and backward at one FFN
    hidden layer of a train step (16 x 2048 rows of FFN, float32); the
    difference times LAYERS is the step's share."""
    from veles_tpu_torch.ops.activations import relu
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.randn(TRAIN_B * TRAIN_T, FFN, device=DEVICE, generator=gen,
                    requires_grad=True)
    g = torch.randn(x.shape, device=DEVICE, generator=gen)
    tie = cuda_ms(torch, lambda: torch.autograd.grad(relu(x), x, g))
    lib = cuda_ms(torch, lambda: torch.autograd.grad(
        torch.clamp_min(x, 0), x, g))
    return {"shape": list(x.shape), "tie_gradient_ms": tie,
            "clamp_min_ms": lib, "step_ms_added": (tie - lib) * LAYERS}


def _gather_host_time(torch, trainer, n=32):
    """Host time a train batch costs: ``make_batch`` (a DeviceBatch over
    the epoch's order, uploaded with the first) and its gather into the
    captured step's static inputs (one launch, and the per-position mask's
    product), each per batch, no synchronisation; beside it the former
    composition, one ``gather_rows`` call per array (host range check,
    int32 cast, pageable upload of the indices) and the arange mask."""
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.ops.kernels import gather_rows as gr
    loader = trainer.loader
    inputs = trainer._train_step.inputs
    n = min(n, loader.n_minibatches(TRAIN))
    torch.cuda.synchronize()
    it = loader.iter_epoch(TRAIN, 0)
    make, gather = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        b = next(it)
        t1 = time.perf_counter()
        b.gather(inputs)
        gather.append(time.perf_counter() - t1)
        make.append(t1 - t0)
    torch.cuda.synchronize()
    order = loader.epoch_order(TRAIN, 0)
    arrays = loader._dev_data[TRAIN]
    legacy = []
    for i in range(n):
        chunk = loader.chunk(order, i)
        t0 = time.perf_counter()
        idx = loader.padded_index(chunk)
        rows = {k: gr.gather_rows(a, idx) for k, a in arrays.items()}
        pad = (torch.arange(TRAIN_B, device=DEVICE) < len(chunk)).float()
        rows["@mask"] = pad[:, None] * rows.pop("@rowmask")
        legacy.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return {"batches": n, "make_batch_us_median": float(np.median(make))
            * 1e6, "make_batch_us_first": make[0] * 1e6,
            "gather_us_median": float(np.median(gather)) * 1e6,
            "per_batch_us_median": float(np.median(
                [a + b for a, b in zip(make[1:], gather[1:])])) * 1e6,
            "per_array_path_us_median": float(np.median(legacy)) * 1e6,
            "gather_launches_per_batch": {"now": 1,
                                          "per_array_path": len(arrays)}}


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
        losses.append(float(mets["loss"]))
    return {"steps": FIXED_STEPS, "losses": losses,
            "min_drop": FIXED_MIN_DROP,
            "ok": bool(np.all(np.isfinite(losses))
                       and losses[-1] <= (1 - FIXED_MIN_DROP) * losses[0])}


def _train_profile(torch, trainer,
                   window="3 train steps, 16 x 2048 tokens each"):
    """Device busy time by kernel over 3 train steps (torch.profiler);
    the idle share is 1 - busy / wall; the flash kernels' device ms a
    step; the launch counters held against the trace.  A fourth step
    runs first as the profiler's warm-up, traced and discarded: the
    trace can miss a kernel launched right after it starts."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.ops.kernels import KERNELS
    warm, *batches = [b for _, b in zip(range(4),
                                        trainer.loader.iter_epoch(TRAIN, 0))]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        trainer.wstate, _ = trainer._train_step(trainer.wstate, warm)
        torch.cuda.synchronize()
        prof.step()
        _settle(torch)
        counted0 = {k.NAME: k.launches.state() for k in KERNELS}
        t0 = time.perf_counter()
        for b in batches:
            trainer.wstate, _ = trainer._train_step(trainer.wstate, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rec = _busy(prof, wall, window, steps=len(batches))
    rec["launch_trace"] = _launch_trace_check(
        prof, counted0, [(trainer._train_step, len(batches))])
    return rec


def _settle(torch):
    """A pause after the profiler's step into its active window: kernels
    launched right after ``prof.step()`` have been missing from the
    trace (the window's first gather and flash forward, in one run of
    each kind), so the window starts once the profiler has."""
    time.sleep(0.1)
    torch.cuda.synchronize()


#: the ``__global__`` function each wrapper launches, by the variant its
#: launch counter names (None: a kernel built in one variant)
KERNEL_SYMBOLS = {
    "flash_attention": {"tc": "flash_fwd_tc", "simt": "flash_fwd_kernel"},
    "flash_bwd_dq": {"tc": "flash_bwd_dq_tc", "simt": "flash_bwd_dq_kernel"},
    "flash_bwd_dkv": {"tc": "flash_bwd_dkv_tc",
                      "simt": "flash_bwd_dkv_kernel"},
    "gather_rows": {"batch": "gather_batch_kernel",
                    "rows": "gather_rows_kernel"},
    "fused_dropout": {None: "dropout_kernel"},
    "mean_disp_normalize": {None: "mean_disp_kernel"},
    "paged_attention_decode": {None: "paged_decode_kernel"},
}


def _launch_trace_check(prof, counted0, replays):
    """The launch counts of a profiled window held against the kernels
    the device ran: for every wrapper and variant, the kernels of its
    ``__global__`` name in the trace must equal the counter's change over
    the window, and each captured step's share of that change must be at
    least its replays in the window (``replays``: ``[(step, n)]``) times
    what the cache recorded at capture (``per_replay`` sums one replay
    of each program the window replayed).  So a replayed graph that no
    longer runs a kernel it counts, or runs one it does not count,
    fails."""
    from veles_tpu_torch.ops.kernels import KERNELS
    traced = {}
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            traced[evt.key] = traced.get(evt.key, 0) + int(evt.count)
    seen, counted, bad = {}, {}, []
    for k in KERNELS:
        (n0, v0), (n1, v1) = counted0[k.NAME], k.launches.state()
        for variant, sym in KERNEL_SYMBOLS[k.NAME].items():
            label = k.NAME if variant is None else f"{k.NAME}/{variant}"
            # the symbol as a whole name: PyTorch's own
            # fused_dropout_kernel_vec is not our dropout_kernel
            pat = re.compile(rf"(?<!\w){sym}(?!\w)")
            seen[label] = sum(c for name, c in traced.items()
                              if pat.search(name))
            counted[label] = (n1 - n0 if variant is None
                              else v1.get(variant, 0) - v0.get(variant, 0))
            if seen[label] != counted[label]:
                bad.append(f"{label}: traced {seen[label]}, counted "
                           f"{counted[label]}")
    replay, by_kind, replayed = {}, {}, {}
    for step, steps in replays:
        if not steps:       # a program the window did not replay
            continue
        kind = getattr(getattr(step, "step", None), "kind", None)
        for counter, (n, variants) in getattr(step, "launches", ()):
            k = next(k for k in KERNELS if k.launches is counter)
            for variant, c in (variants or {None: n}).items():
                label = k.NAME if variant is None else f"{k.NAME}/{variant}"
                replay[label] = replay.get(label, 0) + c
                by_kind.setdefault(kind, {})[label] = c
                replayed[label] = replayed.get(label, 0) + steps * c
                if counted.get(label, 0) < steps * c:
                    bad.append(f"{label}: counted {counted.get(label, 0)}, "
                               f"under {steps} replays of {c}")
    return {"traced": {k: v for k, v in seen.items() if v},
            "counted": {k: v for k, v in counted.items() if v},
            "per_replay": replay, "per_replay_by_kind": by_kind,
            "replayed": replayed, "steps": [n for _, n in replays],
            "captured": all(getattr(step, "captured", False)
                            for step, _ in replays),
            "mismatch": bad, "ok": not bad}


#: kernel-name pieces whose device time a profiled step reports apart
FLASH_KERNELS = ("flash_fwd_tc", "flash_fwd_kernel", "flash_bwd_dkv_tc",
                 "flash_bwd_dkv_kernel", "flash_bwd_dq_tc",
                 "flash_bwd_dq_kernel")


def _busy(prof, wall, window, steps=None):
    busy = {}
    for evt in prof.key_averages():
        # the schedule's step range also shows on the device's timeline,
        # as a span over the step's kernels, not as a kernel
        if not str(getattr(evt, "device_type", "")).endswith("CUDA") \
                or evt.key.startswith("ProfilerStep"):
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
        # ReLU's tie gradient's own kernel (its product is one of many)
        rec["heaviside_device_ms_per_step"] = sum(
            v for k, v in busy.items() if "heaviside" in k) / steps * 1e3
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


def _dispatch_counts(st):
    """Replays of each program in ``engine.stats()``: the token programs
    by name (``decode``, ``megastep_greedy``, ...) and prefill."""
    return {**st["replays"], "prefill": st["prefill_tokens"]}


def _kind_count(counts, kind):
    """Dispatches of a program kind, sampling and greedy-only."""
    return counts.get(kind, 0) + counts.get(kind + "_greedy", 0)


def _step_times(engine, s0, s1):
    """The per-token step walls of the decode and megastep dispatches
    between two ``stats()`` (the engine keeps one a dispatch)."""
    c0, c1 = _dispatch_counts(s0), _dispatch_counts(s1)
    n = sum(_kind_count(c1, k) - _kind_count(c0, k)
            for k in ("decode", "megastep"))
    return list(engine._step_s)[-n:] if n else []


def serving_window(torch, engine):
    """One serving window, SLOTS fresh prompts of WINDOW_PROMPT tokens
    submitted together and WINDOW_NEW tokens decoded: its metrics (TTFT
    of its requests, its decode steps, its prefill rate) and tokens."""
    prompts = np.random.default_rng(11).integers(
        0, VOCAB, (SLOTS, WINDOW_PROMPT)).astype(np.int32)
    s0 = engine.stats()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, WINDOW_NEW) for p in prompts]
    for r in reqs:
        if not r.done.wait(900) or r.error is not None:
            fail(f"a serving window request failed: {r.error}")
    wall = time.perf_counter() - t0
    s1 = engine.stats()
    step_s = _step_times(engine, s0, s1)
    ttft = [r.first_token_at - r.submitted_at for r in reqs]
    decode_s = s1["decode_seconds"] - s0["decode_seconds"]
    return {"decode_tokens_per_s_all_slots":
                (s1["decode_tokens"] - s0["decode_tokens"]) / decode_s,
            "decode_step_s_p50": float(np.median(step_s)),
            "decode_step_s_max": float(np.max(step_s)),
            "ttft_s_mean": float(np.mean(ttft)),
            "ttft_s_max": float(max(ttft)),
            "prefill_tokens_per_s":
                ((s1["prefill_tokens"] - s0["prefill_tokens"])
                 / max(wall - decode_s, 1e-9)),
            "wall_s": wall}, np.stack([r.result for r in reqs])


def phase_profile(torch, engine):
    """Device busy time by kernel over a short serving window (SLOTS
    fresh prompts of PROFILE_PROMPT tokens, PROFILE_NEW decoded) from
    torch.profiler, device activity only; the idle share is 1 - busy /
    wall; the launch counters held against the trace, each graph's
    replays counted (one decode step a replay, one prompt position a
    prefill replay).  The window is short because the profiler's
    processing of its trace takes about 1 ms a kernel on the host.  A
    shorter warm-up request runs first, traced and discarded: the trace
    can miss a kernel launched right after it starts."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from veles_tpu_torch.ops.kernels import KERNELS
    prompts = np.random.default_rng(12).integers(
        0, VOCAB, (SLOTS, PROFILE_PROMPT)).astype(np.int32)
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        engine.generate(prompts[:, :4], 2, timeout=900)
        torch.cuda.synchronize()
        prof.step()
        _settle(torch)
        counted0 = {k.NAME: k.launches.state() for k in KERNELS}
        s0 = engine.stats()
        t0 = time.perf_counter()
        engine.generate(prompts, PROFILE_NEW, timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s1 = engine.stats()
    rec = _busy(prof, wall, f"{SLOTS} x (prefill {PROFILE_PROMPT} + "
                            f"decode {PROFILE_NEW})")
    c0, c1 = _dispatch_counts(s0), _dispatch_counts(s1)
    rec["replays"] = {k: c1[k] - c0[k] for k in engine._fns}
    rec["launch_trace"] = _launch_trace_check(prof, counted0, [
        (engine._fns[k], n) for k, n in rec["replays"].items()])
    return rec


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
    seconds = {}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[phase] = time.perf_counter() - t0
        return out

    name, smi = timed("device", phase_device, torch)
    timed("build", phase_build)
    timing = timed("kernels", phase_kernels, torch)
    timing.update(timed("train_kernels", phase_train_kernels, torch))
    timing.update(timed("image_kernels", phase_image_kernels, torch))
    serve_launches = timed("serving", phase_main_path, torch)
    train_launches = timed("train", phase_train, torch)
    image_launches = timed("image", phase_image, torch)
    timed("quality", phase_quality, torch)
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
    say({"phase": "done", "seconds": time.perf_counter() - t_start,
         "by_phase": seconds})
    say({"kernels": line})
    say(smi)
    say({"ok": True, "device": {"platform": "gpu", "kind": name,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
