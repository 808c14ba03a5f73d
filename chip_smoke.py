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
   variant launched: tensor cores for bf16, for float32 the 3xTF32
   tensor-core forward, dQ and dK/dV, each float32 forward case's error
   against a float64 evaluation reported beside; for paged
   decode, the edges of its per-row split across a cluster of blocks, a
   corrupt page-table entry, and two runs bitwise equal, on float32,
   bfloat16 and float16 pools),
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
   corrupted blob answered 400 with the pool unchanged; then, each with
   the launch counts set to 0 at its start, the bf16 KV cache (the
   greedy request on bf16-cache and f32-pool engines in turns, captured
   against eager on a bf16 pool bit for bit, float32 agreement with
   ``generate(cache_dtype=bfloat16)`` 1.0, the bf16-pool launches one a
   layer a micro-step) and the lifecycle in float32 through
   ``RestfulServer`` with a ``DeployController`` (a hot swap under load
   of 32 clients by ``POST /admin/reload`` of a seed-1 snapshot: at
   least 16 requests in the engine at the flip by its own count, no
   request failed, captures flat, one staged copy of the weights at the
   swap's allocation peak, the tokens after it a fresh engine's
   on those weights bit for bit, prefix hits restarted, a VTKV1 blob from
   before it refused; stage then abort; ``/memory.json`` against the
   allocator; ``/trace.json``'s request spans; a 1 s ``/debug/profile``
   whose trace holds the paged kernel, a second one 409; beams 4 and 1
   on ``/generate``; a drain with requests in flight); then the float16
   KV cache (the greedy request on a captured f16-cache engine, timed;
   in float32 compute its greedy tokens equal to an f32-pool engine's
   and to ``generate(cache_dtype=float16)``'s, the f16-pool launches one
   a layer a micro-step);
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
   median step and, bf16, its idle share printed; the float32 captured
   run's flash launches, counted from 0, all on float32's variants); then
   the f32 flash forward, dQ and dK/dV at the full width (B=16, T=2048,
   H=8, D=64, causal, path ``lm_f32``) against their plain versions
   (each twice, bit for bit) and timed beside them, SDPA in
   float32 and their bound at the f32 tensor-core rate; then a Decision
   rollback through a captured trainer's loop (Adam at lr 0, so epoch 1
   repeats epoch 0), which must halve the lr multiplier in the captured
   state and recapture nothing;
6. image kernels: fused dropout (AlexNet's drop6/drop7 shape, 512 x
   4096 float32, synthdigits_conv's drop3, 100 x 256, and the edges;
   forward and gradient; the seed in a one-element int32 tensor on the
   card, and two seeds written into one slot giving their two masks) and
   mean/disp normalize (norm0's shape, 512 x 227 x 227 x 3, uint8 and
   float32) against their plain versions, bitwise, then their times and
   bounds;
7. image path, full width: ``alexnet_e2e_device_workflow`` (bf16
   compute, momentum SGD with l2) trained through
   ``StandardWorkflow.make_trainer`` -> ``Trainer`` for one epoch (8
   steps of 512) and its eval, from a 4096 + 512 image uint8 store held
   on the card (random crop 227 and mirror there); the train and eval
   steps are captured (each dropout reads its seed from a slot the
   step's host part fills); mean/disp must launch at least 9 times and
   dropout 4 a step plus the capture's warm-ups (2 forward + 2
   backward), every loss must be finite; step times, samples/s and a
   torch.profiler window of 3 steps; 4 captured steps and an eval
   bitwise 4 eager ones from one init (cuDNN deterministic), each side's
   step time; one float32 step through the kernels and one through the
   plain versions from the same weights, batch and key (cuDNN
   deterministic, TF32 off), loss, gradient norms and the drop6/drop7
   masks compared; one ``make_predict_step("fc8")`` batch;
8. the curriculum path: one captured epoch of configs/induction_lm64.json
   (float32, B=100, T=64, 4 heads of 16) with the launch counts set to 0
   before it, the f32 flash forward, dQ and dK/dV at that shape
   against their plain versions and timed beside them, SDPA and the bound
   of their ``cost()``, and the batch gather at that shape; then
   ``python -m veles_tpu_torch configs/induction_lm64.json --curriculum``
   over configs/induction_lm64_curriculum.json cut to its first two
   phases (budgets 170 and 320 epochs; the whole chain of ~3,190 epochs
   would not fit the script's time limit, see ``curriculum_two_phases``;
   each phase's best value, epochs, wall and median step; every phase
   must run to its budget, phase 2 start from phase 1's best snapshot
   and the summary be whole; the bar is reported, see
   ``phase_curriculum``), while the image family's SynthDigits render on
   the host in the background; then ``--generate 64`` over 8 prompts of
   64 through the CLI from the curriculum's best snapshot, greedy and
   ``--beams 4``, token for token an in-process ``generate()`` /
   ``generate_beam()``;
9. the image/conv family: ``configs/synthdigits_conv.json`` at its
   published widths and minibatch (100) through the ``Trainer`` for one
   epoch (600 steps) and its eval over the mnist loader's 60k + 10k
   SynthDigits held on the card (the synthesis or cache read and the
   upload timed apart); train and eval steps captured, dropout launches
   2 a step plus the warm-ups and one batch gather a batch, held against
   a profiled window's trace (idle share); step times and samples/s; 8
   captured steps bitwise 8 eager ones, a new dropout seed each step;
   one float32 step through the kernels and one through the plain
   versions (loss, gradient norms, the drop3 mask); then the config
   through ``python -m veles_tpu_torch`` (its 20 epochs) to <= 0.73 %
   validation error; then ``configs/synthdigits_ae.json`` for one epoch
   and the conv autoencoder (reshape, conv, pool, depool, deconv,
   flatten) for 5 steps, each rmse finite and falling;
10. quality: ``python -m veles_tpu_torch configs/induction_lm.json
   --random-seed 1`` as a subprocess on the card (25 epochs) must reach
   <= 5 % validation error;
11. the recurrent family and the host image path, each with the launch
   counts set to 0 at its start: ``recurrent_serving`` (after the
   lifecycle) serves the mixed chain of tests/test_generate.py:149-156 at
   bench_lm.py's width (the 4 attention blocks of phase 4, then gru 512,
   seq_last and a softmax head; bf16; numpy-seed weights) on captured
   paged engines: the greedy 8 x (512 + 64) request on an engine with
   whole prefills, bitwise on an eager engine (prompts cut to 128), a
   megastep (N=8) one, a
   speculative (k=4) one driven with a verify dispatch every iteration
   and a chunked-prefill (128) one; a shared-prefix pair takes no prefix
   hit and ``GET /kv/pages`` answers 400; profiled decode, megastep and
   verify windows hold the paged launches of each replay against the
   trace (4, 32, 20); in float32 the engine's tokens equal
   ``generate()``'s and a preempted request (re-prefilled from token 0)
   equals its uninterrupted run; decode tokens/s, step p50 and TTFT;
   ``recurrent_train`` (after the LM training path) trains the GRU+LSTM
   LM of BASELINE.md:115 (embedding 64, gru 64, lstm 64, seq_last,
   softmax; float32) 5 captured epochs over the LM64 loader's data
   (vocab 32, T 64, minibatch 100, n_train 2000): losses finite and
   falling, one batch gather a batch, 8 captured steps bitwise 8 eager
   ones, then ``generate`` 8 x (64 + 64) greedy, its tokens the argmax
   of the full forward at every position and a captured engine's tokens
   equal to it; ``image_host`` (after the image path) trains
   ``alexnet_e2e_workflow`` (host crop and mirror by
   ``ImagenetHostLoader``, the uint8 batch normalized on the card by the
   mean/disp kernel, prefetch 2) one captured epoch and its eval, 4
   captured steps bitwise 4 eager ones (cuDNN deterministic), samples/s
   and idle share beside the card-resident variant's, the host crop's ms
   a batch;
12. the pipeline stack and the MoE layer, each phase with the launch
   counts set to 0 where it drives its path: ``pipeline_train`` trains
   the four ``configs/induction_lm_pp*.json`` through ``python -m
   veles_tpu_torch`` for their 25 published epochs, the four runs at
   once (no mesh: the stack runs its stages one after the other;
   captured), ``induction_lm_pp``
   and ``induction_lm_pp_moe`` to <= 5 % (the ``_sp`` configs report
   theirs), then each config in-process for PP_BATCHES captured steps
   and an eval (f32 flash launches, two dropout launches a stage
   dropout a replay: forward and backward, one gather a batch), held
   against a profiled window's trace (idle share), the pp_moe step
   through the kernels against the plain versions in float32, and the
   path's kernels timed at its shape (flash at B=80 T=32 H=4 D=16,
   dropout 80 x 32 x 64);
   ``distributed_one_rank`` starts a one-rank NCCL process group
   (``initialize_distributed``, the mesh's groups) and holds DIST_STEPS
   data-parallel pp_moe steps through it bit for bit against the
   no-mesh step; ``moe_serving`` serves pp_moe's stack (three attention
   stages without dropout, the MoE stage decoded dropless inside the
   graphs) with an LM head on captured paged engines, greedy 8 x (64 +
   64): tokens equal ``generate()``'s, bitwise on an eager, a megastep
   and a speculative engine, paged launches 3 a decode micro-step held
   against a profiled window's trace;
13. ``artifact`` (last, the launch counts set to 0 where it drives its
   path): the serving phase's bf16 LM sealed by ``export_compiled``
   (megastep 8, spec k 4, the paged kernel; in a child the script starts
   after the build, beside the phases up to this one; the export's
   seconds and every blob's size) and served by ``python -m
   veles_tpu_torch --serve 0 --artifact DIR`` in a child with no config:
   the greedy 8 x (512 + 64) request equal to the live engine's tokens,
   nothing recaptured after load, ``POST /predict`` within the flash
   forward's bf16 limit of the live predict, tokens/s and TTFT beside
   the live engine's; in this process an ``ArtifactRunner`` whose
   megastep and verify runs are bitwise its plain decode, profiled
   windows holding the paged launches of each replay to the trace (4 a
   decode, 32 a megastep, 20 a verify), the sealed forward launching the
   flash kernel once a layer; a float32 artifact's runner hot-swapped
   under the lifecycle's load from the bf16 artifact, an export package
   and a ``forge://`` store (no request failed, captures flat, tokens a
   live engine's on the swapped weights) and a preempted request equal
   to its uninterrupted run; ``--serve --artifact DIR --fleet 2``
   answering ``generate()``'s tokens and a rolling drain under load
   rebooting both replicas with none dropped; AlexNet's two
   ``LRN(method="auto")`` units measured on the card into a fresh DB
   and read back by a second build that measures nothing, its forward
   sealed as a forward-only artifact (one mean/disp launch) within the
   bf16 limit of the live predict;
14. the ``kernels`` JSON line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Goodput: ``runtime.benchmark.benchmark_device()`` runs once after the
kernel checks (its DB under ``.veles_tpu`` beside this file, where the
CLI runs read it too); the LM train phase's counted ``train_step_flops``
must equal the analytic count of its step within 5 %, with its
``train_mfu`` against the measured peak; the serving phase samples the
decode bandwidth, MBU (against 3350 GB/s) and headroom gauges under the
greedy request, and the bandwidth must fall to 0 within 10 s of idling;
the lifecycle also hot-swaps from a ``sqlite://...#best`` row and an
``http://127.0.0.1`` manifest under load (no request failed, captures
flat, tokens those of an engine booted from the same file snapshot).

Datasets the image family renders are cached under
``$VELES_TORCH_CACHE`` (default here: ``.veles_tpu/cache`` beside this
file), so the CLI runs find them warm.

TF32 is off for every comparison (``torch.backends.cuda.matmul`` and
``cudnn``): float32 products run in full float32.  Without a CUDA card,
or without the ``veles_tpu_torch`` package beside this file, the script
exits non-zero and prints no result.
"""

import contextlib
import hashlib
import json
import os
import re
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request
from unittest import mock

import numpy as np

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak (H100 SXM)
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores
# float32-accurate products on the tensor cores: a 3xTF32 product is three
# TF32 products (495 TFLOP/s dense), so 165 TFLOP/s of float32 work.  The
# f32 flash rows are bound by the faster of the card's two float32-accurate
# routes, whatever variant runs, so every share counts the same work.
H100_F32_TC_FLOPS = 495e12 / 3
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
# BWD_UNITS units of the terms that cancel (see _bwd_case).  A float32
# gradient is also held to its float64 evaluation from the same lse and
# delta (bwd_float64): the plain version's own float32 rounding takes up
# to ~900 of the 1024 units at T=2048 and has been read above them on
# other inputs, so there the kernel within BWD_UNITS of float64 and no
# further from it than the plain version is right even where it is more
# than BWD_UNITS from the plain version (bwd_within).
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
IMG_WITNESS_STEPS = 4           # AlexNet eager vs captured steps, bitwise
# the image/conv family: configs/synthdigits_conv.json at its published
# widths and minibatch over the mnist loader's 60k + 10k SynthDigits held
# on the card (drop3 is 100 x 256 float32); its bar (BASELINE.md:138)
FAMILY_CONFIG = os.path.join("configs", "synthdigits_conv.json")
AE_CONFIG = os.path.join("configs", "synthdigits_ae.json")
DROP3 = (100, 256)
FAMILY_WITNESS_STEPS = 8        # eager vs captured steps, bitwise
FAMILY_BAR = 0.73               # % validation error
AE_CONV_TRAIN, AE_CONV_VALID = 500, 100   # the conv autoencoder's steps

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
# the lifecycle: LIFE_THREADS clients looping greedy (LIFE_PROMPT +
# LIFE_NEW) requests across the swap, at least LIFE_IN_FLIGHT of them
# held by the engine (queued, prefilling or decoding) at the flip; the
# drain's in-flight requests run DRAIN_NEW
LIFE_THREADS, LIFE_IN_FLIGHT, LIFE_PROMPT, LIFE_NEW = 32, 16, 64, 32
DRAIN_NEW = 128
TRACE_CHECKED = 64             # the newest request spans held to nesting
DEVICE = "cuda"                # the main path's device
# the curriculum path: configs/induction_lm64.json (2 blocks, dim 64, 4
# heads of 16, T 64, minibatch 100, float32) through the published
# configs/induction_lm64_curriculum.json (n_train 2000, n_valid 1000) to
# its bar (BASELINE.md:145-147); the JAX package's trajectory from the
# spec's __doc__
CURRICULUM_CONFIG = os.path.join("configs", "induction_lm64.json")
CURRICULUM_SPEC = os.path.join("configs", "induction_lm64_curriculum.json")
CURRICULUM_BAR = 5.0
CURRICULUM_TIMEOUT = 900
JAX_TRAJECTORY = [96.7, 36.7, 10.6, 7.1, 5.6, 4.3]
CUR_B, CUR_T, CUR_H, CUR_D = 100, 64, 4, 16
CUR_TRAIN, CUR_VALID = 2000, 1000
# decode from the CLI at BASELINE.md:113's shape: 8 prompts of 64, 64 new
GEN_ROWS, GEN_PROMPT, GEN_NEW, GEN_BEAMS = 8, 64, 64, 4
# the serving phase's MBU denominator: H100 SXM HBM3, as H100_BYTES_S
# the recurrent family: the GRU+LSTM LM (BASELINE.md:115, d=64) at the
# LM64 loader's data, float32, REC_EPOCHS captured epochs; its greedy
# decode of REC_GEN_ROWS x (REC_GEN_PROMPT + REC_GEN_NEW)
REC_V, REC_DIM, REC_T, REC_B = 32, 64, 64, 100
REC_TRAIN, REC_VALID, REC_EPOCHS = 2000, 1000, 5
REC_WITNESS_STEPS = 8           # eager vs captured steps, bitwise
REC_GEN_ROWS, REC_GEN_PROMPT, REC_GEN_NEW, REC_L_MAX = 8, 64, 64, 256
# the mixed attention + GRU chain served: the chunked engine's slice and
# the decode steps before the class-0 arrival that preempts
REC_SERVE_CHUNK, REC_PREEMPT_AFTER = 128, 16
# the eager mixed-chain engine's prompt (a 512-token prefill, one
# position at a time, took 42 s of the script)
REC_EAGER_PROMPT = 128
PEAK_HBM_GBPS = 3350.0
# the analytic train step: within this share of the counted one
FLOPS_RTOL = 0.05


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


def cost_bound(cost, peak):
    """:func:`bound` of a kernel module's ``cost()`` (the count the
    gauges use too)."""
    return bound(cost["flops"], peak, cost["bytes"])


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
    f64 = {}
    if dtype == torch.float32:
        exact = fwd_float64(torch, q, k, v, causal=causal, window=window)
        f64 = {"f64_err": float((out.double() - exact).abs().max()),
               "plain_f64_err": float((ref.double() - exact).abs().max())}
    return (q, k, v), err, lerr, finite, ran, f64


def fwd_float64(torch, q, k, v, *, causal, window):
    """The flash forward's output evaluated in float64 from the same
    inputs (a row with no live key 0, as the kernels write it): the
    answer the kernel and its plain version both round; a report beside
    FLASH_TOL, not a second limit."""
    B, Tq, H, D = q.shape
    Tk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    q_pos = torch.arange(Tq, device=q.device)[:, None]
    k_pos = torch.arange(Tk, device=q.device)[None, :]
    keep = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        keep = k_pos <= q_pos
        if window is not None:
            keep = keep & (k_pos > q_pos - window)
    out = torch.empty((B, H, Tq, D), dtype=torch.float64, device=q.device)
    for b in range(B):      # one sequence's (H, Tq, Tk) at a time
        qh = q[b].transpose(0, 1).double()
        kh, vh = (x[b].transpose(0, 1).double().repeat_interleave(G, dim=0)
                  for x in (k, v))
        s = (qh @ kh.transpose(-1, -2) * D ** -0.5).masked_fill(
            ~keep, float("-inf"))
        p = torch.softmax(s, -1).nan_to_num(0.0)
        out[b] = p @ vh
    return out.transpose(1, 2)


def _variant_delta(before, after):
    """The variants launched between two ``launches.by_variant()``."""
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


#: the flash kernels: forward, dQ and dK/dV
FLASH_NAMES = ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv")
#: float32's variant of every flash kernel: 3xTF32 on the tensor cores
F32_VARIANT = "tf32x3"


def expected_variant(dtype):
    """A flash kernel's variant for a dtype, one launch: the tensor-core
    kernels take bf16, :data:`F32_VARIANT` float32."""
    return ({"tc": 1} if str(dtype).endswith("bfloat16")
            else {F32_VARIANT: 1})


def _instance_usage(*libs):
    """ptxas registers and spills of every kernel instance of the
    libraries (from this run's build log)."""
    from veles_tpu_torch.ops.kernels import build
    return {k: v for lib in libs
            for k, v in ptxas_usage(build.build_logs.get(lib, "")).items()}


def _paged_inputs(torch, gen, S, H, Hk, Dh, psz, n_ptab, q_dtype, pos,
                  scratch_tail, pool_dtype=None):
    rows = S * n_ptab + 1
    pool_dtype = pool_dtype or torch.float32
    pk = torch.randn((rows, psz, Hk, Dh), generator=gen).cuda().to(
        pool_dtype)
    pv = torch.randn((rows, psz, Hk, Dh), generator=gen).cuda().to(
        pool_dtype)
    ptab = torch.randperm(rows - 1, generator=gen)[:S * n_ptab].reshape(
        S, n_ptab).to(torch.int32)
    if scratch_tail:                   # entries past each span: scratch
        for b, p in enumerate(pos):
            ptab[b, p // psz + 1:] = rows - 1
    q = torch.randn((S, H, Dh), generator=gen).cuda().to(q_dtype)
    return (q, pk, pv, ptab.cuda(),
            torch.as_tensor(pos, dtype=torch.int32).cuda())


def _corrupt_ptab_check(torch, gen, pos, pool_dtype):
    """A live page-table entry outside the pool turns its row into NaN in
    the kernel and in the plain version alike, whichever block of the
    row's split reads it; an out-of-range entry past a row's span is
    never read, so that row stays finite."""
    from veles_tpu_torch.ops.kernels import paged_attention as pa
    q, pk, pv, ptab, ppos = _paged_inputs(
        torch, gen, SLOTS, HEADS, HEADS, 64, PAGE, L_MAX // PAGE,
        torch.float32, pos, True, pool_dtype)
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
            "variant": POOL_VARIANTS[str(pool_dtype).split(".")[-1]],
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
             # the edges of the 3xTF32 forward's tiles (16-64 query rows
             # by 32 keys)
             ("T1_f32", 2, 1, 1, 8, 8, 64, f32, True, None),
             ("T63_f32", 2, 63, 63, 8, 8, 64, f32, True, None),
             ("T65_f32", 2, 65, 65, 8, 8, 64, f32, True, None),
             ("T129_f32", 2, 129, 129, 8, 8, 64, f32, True, None),
             ("cross_Tk_below_tile_f32", 2, 200, 20, 8, 8, 64, f32, False,
              None),
             ("gqa4_f32", 2, 300, 300, 8, 2, 64, f32, True, None),
             ("window_below_tile_f32", 2, 400, 400, 8, 8, 64, f32, True,
              20),
             ("rows_without_keys_f32", 2, 300, 100, 8, 8, 64, f32, True,
              64),
             ("D16_cross_f32", 2, 150, 90, 4, 4, 16, f32, False, None),
             # head dim 16: configs/induction_lm*.json (E=64, 4 heads)
             ("induction_lm_D16_f32", 4, 128, 128, 4, 4, 16, f32, True,
              None),
             ("induction_lm_D16_bf16", 4, 128, 128, 4, 4, 16, bf16, True,
              None),
             ("D16_bf16_T2048", 4, 2048, 2048, 4, 4, 16, bf16, True, None)]
    main_flash = None
    for name, B, Tq, Tk, H, Hk, D, dt, causal, window in flash:
        args, err, lerr, finite, ran, f64 = _flash_case(
            torch, gen, B, Tq, Tk, H, Hk, D, dt, causal, window)
        tol = FLASH_TOL[str(dt).split(".")[-1]]
        ok = (finite and err <= tol and lerr <= LSE_TOL
              and ran == expected_variant(dt))
        checks.append({"kernel": fa.NAME, "case": name, "variant": ran,
                       "max_abs_err": err, "tol": tol,
                       "lse_max_abs_err": lerr, "lse_tol": LSE_TOL, **f64,
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
    # (name, H, Hk, Dh, q dtype, positions, window, scratch tail, pool
    # dtype): the f32 pool first, then the bf16 pool of an engine with
    # cache_dtype=torch.bfloat16 (its main shape and the split edges)
    paged = [("main_bf16q_f32pool", HEADS, HEADS, 64, bf16, main_pos, None,
              True),
             ("edges_f32", HEADS, HEADS, 64, f32, edge_pos, None, True),
             ("window_f32", HEADS, HEADS, 64, f32, edge_pos, 100, True),
             ("gqa_f32", HEADS, 2, 64, f32, edge_pos, None, False),
             ("gqa_window_bf16q", HEADS, 2, 64, bf16, edge_pos, 40, True),
             # the edges of the kernel's split (4 blocks a row, 16 pages
             # of 16 a block at pos L-1)
             ("split_edges_f32", HEADS, HEADS, 64, f32, split_pos, None,
              True),
             ("window_across_splits_f32", HEADS, HEADS, 64, f32, edge_pos,
              200, True),
             ("window_1_f32", HEADS, HEADS, 64, f32, edge_pos, 1, True),
             ("induction_lm_D16_f32", 4, 4, 16, f32, edge_pos, None, True),
             ("induction_lm_D16_bf16q", 4, 4, 16, bf16, edge_pos, None,
              True)]
    paged = [c + (f32,) for c in paged] + [
        ("main_bf16q_bf16pool", HEADS, HEADS, 64, bf16, main_pos, None,
         True, bf16),
        ("bf16pool_edges_f32q", HEADS, HEADS, 64, f32, edge_pos, None, True,
         bf16),
        ("bf16pool_split_edges", HEADS, HEADS, 64, bf16, split_pos, None,
         True, bf16),
        ("bf16pool_window_across_splits", HEADS, HEADS, 64, f32, edge_pos,
         200, True, bf16),
        ("bf16pool_gqa_window", HEADS, 2, 64, bf16, edge_pos, 40, True,
         bf16),
        ("bf16pool_D16", 4, 4, 16, f32, edge_pos, None, True, bf16),
        # the redesign's edges: G = 8 and 4 at both head widths (blocks
        # with no key at positions 0-16), a window starting inside a page
        ("bf16pool_gqa8", HEADS, 1, 64, bf16, edge_pos, None, True, bf16),
        ("bf16pool_gqa8_D16_window", HEADS, 1, 16, f32, edge_pos, 20, True,
         bf16),
        ("bf16pool_gqa4_D16", 4, 1, 16, bf16, edge_pos, None, True, bf16),
        ("bf16pool_window_inside_a_page", HEADS, HEADS, 64, f32, split_pos,
         37, True, bf16)]
    # the f16 pool of an engine with cache_dtype=torch.float16: the bf16
    # pool's cases
    f16 = torch.float16
    paged += [(c[0].replace("bf16pool", "f16pool"),) + c[1:-1] + (f16,)
              for c in paged if c[-1] == bf16]
    main_paged = {}
    for name, H, Hk, Dh, qdt, pos, window, scratch, pdt in paged:
        args = _paged_inputs(torch, gen, SLOTS, H, Hk, Dh, PAGE,
                             L_MAX // PAGE, qdt, pos, scratch, pdt)
        variant = POOL_VARIANTS[str(pdt).split(".")[-1]]
        before = pa.launches.by_variant().get(variant, 0)
        out = pa.paged_attention_decode(*args, page_size=PAGE,
                                        n_kv_heads=Hk, window=window)
        ref = pa.paged_attention_decode_plain(*args, page_size=PAGE,
                                              n_kv_heads=Hk, window=window)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        launched = pa.launches.by_variant().get(variant, 0) - before
        ok = (bool(torch.isfinite(out).all()) and err <= PAGED_TOL
              and launched == 1)
        checks.append({"kernel": pa.NAME, "case": name, "variant": variant,
                       "max_abs_err": err, "tol": PAGED_TOL, "ok": ok})
        say(checks[-1])
        if name.startswith("main"):
            main_paged[variant] = (args, err, pos, H, Hk)
    for pdt in (f32, bf16, f16):
        checks.append(_corrupt_ptab_check(torch, gen, edge_pos, pdt))
        say(checks[-1])
    # fixed splits merged in rank order: two runs give the same bits
    for variant, (args, *_rest, Hk_) in main_paged.items():
        twice = [pa.paged_attention_decode(*args, page_size=PAGE,
                                           n_kv_heads=Hk_)
                 for _ in range(2)]
        same = bool(torch.equal(*twice))
        checks.append({"kernel": pa.NAME, "variant": variant,
                       "case": "main_two_runs_bitwise", "equal": same,
                       "ok": same})
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
    f_cost = fa.cost(q, k, v, causal)
    f_flops = f_cost["flops"]
    f_bound, f_by = cost_bound(f_cost, H100_BF16_FLOPS)

    paged_timing = {variant: _paged_timing(torch, pa, *main)
                    for variant, main in main_paged.items()}
    timing = {
        fa.NAME: {"max_abs_err": ferr, "ms": f_ms, "plain_ms": f_plain,
                  "library_ms": f_lib, "bound_ms": f_bound,
                  "bound_by": f_by, "variant": "tc",
                  "source": fa.SOURCES["tc"],
                  "tflops": f_flops / f_ms / 1e9,
                  "bound_share": f_bound / f_ms,
                  "ptxas": _instance_usage("flash_fwd_tc", "flash_fwd_tf32x3"),
                  "shape": {"B": B, "T": T, "H": H, "D": D,
                            "dtype": "bfloat16", "causal": causal}},
        pa.NAME: paged_timing["f32_pool"],
        pa.NAME + "/bf16_pool": paged_timing["bf16_pool"],
        pa.NAME + "/f16_pool": paged_timing["f16_pool"],
    }
    say({"phase": "kernel_timing", **timing})
    return timing


def _paged_timing(torch, pa, args, perr, pos, Hp, Hkp):
    """Hot and cold-L2 times of the paged kernel at a path's shape, its
    plain version's, the byte bound of this pool's dtype and the share of
    it each time reaches, and ``floor_ms``: the hot time at the same grid
    with every row at position 0 (one key a row), the kernel's fixed
    cost."""
    pq, pk_, pv_, ptab, ppos = args
    p_ms = cuda_ms(torch, lambda: pa.paged_attention_decode(
        *args, page_size=PAGE, n_kv_heads=Hkp), iters=50)
    p_cold = cold_l2_ms(torch, lambda: pa.paged_attention_decode(
        *args, page_size=PAGE, n_kv_heads=Hkp))
    p_plain = cuda_ms(torch, lambda: pa.paged_attention_decode_plain(
        *args, page_size=PAGE, n_kv_heads=Hkp), iters=20)
    S, _, Dh = pq.shape
    zero = (pq, pk_, pv_, ptab, torch.zeros_like(ppos))
    p_floor = cuda_ms(torch, lambda: pa.paged_attention_decode(
        *zero, page_size=PAGE, n_kv_heads=Hkp), iters=50)
    p_cost = pa.cost(pq, pk_, pos, page_size=PAGE)
    p_bytes = p_cost["bytes"]
    p_bound, p_by = cost_bound(p_cost, H100_F32_FLOPS)
    pool = str(pk_.dtype).split(".")[-1]
    variant = POOL_VARIANTS[pool]
    symbol = KERNEL_SYMBOLS["paged_attention_decode"][variant]
    return {"max_abs_err": perr, "ms": p_ms, "plain_ms": p_plain,
            "library_ms": None, "bound_ms": p_bound, "bound_by": p_by,
            "cold_l2_ms": p_cold, "floor_ms": p_floor,
            "bound_share_hot": p_bound / p_ms,
            "bound_share_cold": p_bound / p_cold,
            "gb_per_s_cold": p_bytes / p_cold / 1e6, "bytes": p_bytes,
            "variant": variant,
            "ptxas": {k: v for k, v in _instance_usage(
                "paged_attention").items()
                if re.search(rf"(?<!\w){symbol}(?!\w)", k)},
            "shape": {"S": S, "H": Hp, "Hk": Hkp, "Dh": Dh,
                      "page_size": PAGE, "n_ptab": ptab.shape[1],
                      "q": str(pq.dtype).split(".")[-1], "pool": pool,
                      "mean_pos": float(np.mean(pos))}}


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
    if dtype == torch.float32:
        exact = dict(zip(("dq", "dk", "dv"), bwd_float64(torch, *args, **kw)))
        for name in ("dq", "dk", "dv"):
            res[name]["f64_units"] = bwd_agreement(
                torch, got[name], exact[name], zero.get(name))["units"]
            res[name]["plain_f64_units"] = bwd_agreement(
                torch, ref[name], exact[name], zero.get(name))["units"]
    res["variant"] = {dq.NAME: ran_dq, dkv.NAME: ran}
    return args, kw, res


def bwd_float64(torch, q, k, v, do, lse, delta, *, causal, scale, window):
    """dQ, dK and dV of the flash backward evaluated in float64 from the
    same inputs, lse and delta (the mask of ``key_blocks``: causal keys at
    or before the query, within the window), rounded to the inputs'
    dtype: the answer both the kernel and its plain version round."""
    B, Tq, H, D = q.shape
    Tk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    qh, doh = (x.transpose(1, 2).double() for x in (q, do))
    kh, vh = (x.transpose(1, 2).double().repeat_interleave(G, dim=1)
              for x in (k, v))
    q_pos = torch.arange(Tq, device=q.device)[:, None]
    k_pos = torch.arange(Tk, device=q.device)[None, :]
    keep = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        keep = k_pos <= q_pos
        if window is not None:
            keep = keep & (k_pos > q_pos - window)
    dq, dk, dv = (torch.empty_like(x) for x in (qh, kh, vh))
    for b in range(B):      # one sequence's (H, Tq, Tk) at a time
        p = torch.where(keep, torch.exp(qh[b] @ kh[b].transpose(-1, -2)
                                        * scale
                                        - lse[b].double()[..., None]), 0.0)
        ds = p * (doh[b] @ vh[b].transpose(-1, -2)
                  - delta[b].double()[..., None]) * scale
        dq[b] = ds @ kh[b]
        dk[b] = ds.transpose(-1, -2) @ qh[b]
        dv[b] = p.transpose(-1, -2) @ doh[b]
    dk, dv = (x.reshape(B, Hk, G, Tk, D).sum(2) for x in (dk, dv))
    return tuple(x.transpose(1, 2).to(t.dtype).contiguous()
                 for x, t in ((dq, q), (dk, k), (dv, v)))


def bwd_within(r):
    """The flash backward rule on one gradient's :func:`bwd_agreement`
    (BWD_UNITS above): within BWD_UNITS of the plain version, and in
    float32 within BWD_UNITS of the float64 evaluation as well; a float32
    kernel further than BWD_UNITS from the plain version passes only where
    the plain version is itself at least as far from float64."""
    within = r["units"] <= r["units_tol"]
    if "f64_units" not in r:
        return within
    return r["f64_units"] <= r["units_tol"] and (
        within or r["plain_f64_units"] >= r["f64_units"])


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
                rec[g] = {k: r[k] for k in (
                    "units", "units_tol", "f64_units", "plain_f64_units",
                    "max_abs_err", "frob_rel_err", "median_abs_plain")
                    if k in r}
                ok = ok and r["finite"] and r["dtype_ok"] and bwd_within(r)
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
    dq_flops = dq.cost(q, k, v, True)["flops"]
    dkv_flops = dkv.cost(q, k, v, True)["flops"]
    dq_bound = cost_bound(dq.cost(q, k, v, True), H100_BF16_FLOPS)
    dkv_bound = cost_bound(dkv.cost(q, k, v, True), H100_BF16_FLOPS)
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
    g_bound = cost_bound(gr.cost(lm_arrays, TRAIN_B, mask=True),
                         H100_BF16_FLOPS)
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
                                           "flash_bwd_dq_tf32x3"),
                  "shape": shape},
        dkv.NAME: {"max_abs_err": max(res["dk"]["max_abs_err"],
                                      res["dv"]["max_abs_err"]),
                   "ms": dkv_ms, "plain_ms": dkv_plain, "library_ms": lib_ms,
                   "bound_ms": dkv_bound[0], "bound_by": dkv_bound[1],
                   "variant": "tc", "source": dkv.SOURCES["tc"],
                   "tflops": dkv_flops / dkv_ms / 1e9,
                   "bound_share": dkv_bound[0] / dkv_ms,
                   "ptxas": _instance_usage("flash_bwd_dkv_tc",
                                            "flash_bwd_dkv_tf32x3"),
                   "shape": shape},
        gr.NAME: {"max_abs_err": 0.0, "ms": g_ms, "plain_ms": g_plain,
                  "library_ms": None, "bound_ms": g_bound[0],
                  "bound_by": g_bound[1], "variant": "batch",
                  "rows_kernel_ms": rows_ms, "rows_wrapper_ms": rows_wrapper,
                  "rows_index_select_ms": rows_lib,
                  "shape": {"rows": GATHER_ROWS, "m": TRAIN_B,
                            "arrays": ["int32", "int32", "float32"],
                            "row_bytes": TRAIN_T * 4}},
    }
    say({"phase": "train_kernel_timing",
         "library_note": "library_ms of both flash backward kernels is one "
                         "SDPA backward (dQ, dK and dV together); the batch "
                         "gather has no single PyTorch call",
         **timing})
    return timing


def phase_image_kernels(torch):
    """The image paths' kernels (fused dropout, mean/disp normalize)
    against their plain versions, bitwise, at the paths' shapes and the
    edges, the dropout seed in a one-element int32 tensor on the card (a
    seed slot: two seeds written into one slot give their two masks);
    then their times and bounds at the paths' shapes (dropout at
    AlexNet's drop6/drop7 and at synthdigits_conv's drop3)."""
    import torch.nn.functional as F
    from veles_tpu_torch.ops.kernels import fused_dropout as fd
    from veles_tpu_torch.ops.kernels import mean_disp as md
    gen = torch.Generator().manual_seed(6)
    checks = []
    drop = [("main_f32_512x4096", (DROP_ROWS, DROP_COLS), torch.float32,
             DROP_RATE, 2769742244),
            ("drop3_f32_100x256", DROP3, torch.float32, DROP_RATE,
             0xDEADBEEF),
            ("r0.1_1d", (100003,), torch.float32, 0.1, 3),
            ("r0.9_cols_300", (5, 7, 300), torch.float32, 0.9, 99),
            ("cols_8320", (3, 8320), torch.float32, 0.5, 0xC0FFEE),
            ("bf16_odd", (16, 203), torch.bfloat16, 0.3, 11),
            ("nhwc_f32", (64, 13, 13, 256), torch.float32, 0.5, 5)]
    main_drop = {}
    for name, shape, dt, rate, seed in drop:
        x = torch.randn(shape, generator=gen).to("cuda", dt)
        g = torch.randn(shape, generator=gen).to("cuda", dt)
        xr = x.detach().requires_grad_(True)
        seed = fd.seed_tensor(seed, "cuda")
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
        if name.startswith(("main", "drop3")):
            main_drop[name.split("_")[0]] = (x, seed, rate, err)
    # one seed slot, two seeds written into it by the host: the two masks
    x = main_drop["drop3"][0]
    slot = torch.zeros(1, dtype=torch.int32, device="cuda")
    outs = []
    for seed in (7, 2 ** 32 - 7):
        slot.fill_(fd.seed_bits(seed))
        outs.append((fd.fused_dropout(x, slot, DROP_RATE),
                     fd.fused_dropout_plain(x, seed, DROP_RATE)))
    torch.cuda.synchronize()
    same = all(torch.equal(y, ref) for y, ref in outs)
    differ = not torch.equal(outs[0][0] == 0, outs[1][0] == 0)
    checks.append({"kernel": fd.NAME, "case": "one_slot_two_seeds",
                   "each_bitwise_its_seed": same, "masks_differ": differ,
                   "max_abs_err": 0.0 if same else None, "tol": 0.0,
                   "ok": same and differ})
    say(checks[-1])
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

    drop_t = {}
    for path, (x, seed, rate, d_err) in main_drop.items():
        d_bound = cost_bound(fd.cost(x), H100_F32_FLOPS)
        drop_t[path] = {
            "max_abs_err": d_err,
            "ms": cuda_ms(torch, lambda: fd._launch(x, seed, rate),
                          iters=100),
            "plain_ms": cuda_ms(torch, lambda: fd.fused_dropout_plain(
                x, seed, rate)),
            "library_ms": cuda_ms(torch, lambda: F.dropout(
                x, rate, training=True), iters=100),
            "bound_ms": d_bound[0], "bound_by": d_bound[1],
            "seed": "int32 slot on the card",
            "library_note": "F.dropout at the same shape and rate: "
                            "another mask stream",
            "shape": {"rows": x.shape[0], "cols": x.shape[1],
                      "dtype": "float32", "rate": rate}}
    xm, mean, rdisp, m_err = main_md
    m_ms = cuda_ms(torch, lambda: md._launch(xm, mean, rdisp), iters=50)
    m_plain = cuda_ms(torch, lambda: md.mean_disp_normalize_plain(
        xm, mean, rdisp))
    m_bound = cost_bound(md.cost(xm, mean), H100_F32_FLOPS)
    timing = {
        fd.NAME: {**drop_t["main"], "path": "alexnet"},
        fd.NAME + "/synthdigits_conv": {**drop_t["drop3"],
                                        "path": "synthdigits_conv"},
        md.NAME: {"max_abs_err": m_err, "ms": m_ms, "plain_ms": m_plain,
                  "library_ms": None, "bound_ms": m_bound[0],
                  "bound_by": m_bound[1],
                  "bytes": md.cost(xm, mean)["bytes"],
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
    predict batch.  Returns the launches and the epoch's record."""
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.ops.kernels import (fused_dropout, gather_rows,
                                             mean_disp)
    from veles_tpu_torch.runtime.step_cache import WARMUP_STEPS
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
    # the dropout seeds reach the kernel through their slots on the card:
    # train and eval steps captured, each replay counting its launches
    st = run["step_cache"]
    if st["train"] != {"captured": True, "reason": None} \
            or not st["eval"]["captured"]:
        fail(f"AlexNet's steps: {st}")
    if launches[fused_dropout.NAME] != 4 * (steps + WARMUP_STEPS):
        fail(f"AlexNet's epoch counted {launches[fused_dropout.NAME]} "
             f"dropout launches, not 4 for each of {steps} steps and "
             f"{WARMUP_STEPS} capture warm-ups")
    witness = _image_capture_witness(torch)
    say({"phase": "image_capture_witness", **witness})
    if not witness["ok"]:
        fail(f"AlexNet: captured and eager steps differ: {witness}")
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
    return launches, rec


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


@contextlib.contextmanager
def _cudnn_deterministic(torch):
    """cuDNN restricted to its deterministic algorithms (the eager and
    captured witnesses compare bits, and cuDNN may otherwise pick
    algorithms that reduce with atomics)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def _image_capture_witness(torch, host=False):
    """IMG_WITNESS_STEPS AlexNet steps of IMG_B and an eval from one init
    and one store (card-resident, or with ``host`` the host loader's),
    through the eager step (``StepCache(capture=False)``) and the
    captured one, cuDNN deterministic: parameters, momentum and unit
    state, and the epoch sums, bit for bit; each side's median step."""
    from veles_tpu_torch.models.alexnet import (_e2e_config,
                                                alexnet_e2e_device_workflow,
                                                alexnet_e2e_workflow)
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.runtime.decision import Decision
    from veles_tpu_torch.runtime.snapshotter import wstate_to_numpy
    from veles_tpu_torch.runtime.step_cache import StepCache
    kw = dict(minibatch_size=IMG_B, n_train=IMG_WITNESS_STEPS * IMG_B,
              n_valid=IMG_B)
    loader = (alexnet_e2e_workflow(**kw) if host else
              alexnet_e2e_device_workflow(device=DEVICE, **kw)).loader
    runs, states = {}, {}
    with _cudnn_deterministic(torch):
        for capture in (False, True):
            loader.epoch_number = 0
            sw = StandardWorkflow(_e2e_config())
            run = _counted_run(torch, sw.make_trainer(
                loader, Decision(max_epochs=1), device=DEVICE,
                step_cache=StepCache(capture=capture)), 0.0)
            states[capture] = wstate_to_numpy(run["trainer"].wstate)
            runs[capture] = {
                "step_ms_median": float(np.median(run["step_s"])) * 1e3,
                "step_ms": [x * 1e3 for x in run["step_s"]],
                "epoch": run["trainer"].decision.history[0],
                "dropout_launches": run["launches"]["fused_dropout"],
                "step_cache": run["step_cache"]}
            del run, sw
            torch.cuda.empty_cache()
    diff = _state_diff(torch, states[False], states[True])
    sums_equal = runs[False]["epoch"] == runs[True]["epoch"]
    captured = runs[True]["step_cache"]["train"]["captured"]
    return {"steps": IMG_WITNESS_STEPS, "cudnn_deterministic": True,
            "loader": "host" if host else "card",
            "eager_step_ms_median": runs[False]["step_ms_median"],
            "captured_step_ms_median": runs[True]["step_ms_median"],
            "eager": runs[False], "captured": runs[True],
            "state_leaves_differing": diff, "epoch_sums_equal": sums_equal,
            "ok": captured and not diff and sums_equal}


# -- the image/conv family: configs/synthdigits_conv.json ------------------------

def _config(rel):
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, rel)) as f:
        return json.load(f)


def _digits_cache_warm():
    """Whether the port's npz of the mnist loader's 60k + 10k SynthDigits
    is already on disk."""
    from veles_tpu_torch.models import synth_data
    return os.path.exists(os.path.join(
        synth_data.cache_dir(), f"synthdigits_v{synth_data._DIGITS_VERSION}"
        "_60000_10000_20260729.npz"))


def _mnist_loader(torch, minibatch):
    """The mnist loader on the card: the synthesis (or the cache read)
    and the upload timed apart."""
    from veles_tpu_torch.models.mnist import MnistLoader
    warm = _digits_cache_warm()
    t0 = time.perf_counter()
    loader = MnistLoader(minibatch_size=minibatch, device=DEVICE)
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loader.initialize()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    if not loader.on_device or loader.synthetic is not True:
        fail("the mnist loader is not on the card or not SynthDigits")
    return loader, {"cache_warm": warm, "synthesis_or_cache_read_s": synth_s,
                    "upload_s": upload_s}


def _seeded_run(torch, trainer):
    """``initialize(seed=0)`` and one epoch, each train step's staged
    drop3 seed read back after it (so each side's steps draw their
    seeds)."""
    trainer.initialize(seed=0)
    step = trainer._train_step
    inner = getattr(step, "step", step)
    seeds, step_s = [], []

    def run(wstate, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(wstate, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        seeds.append(int(inner.seeds["drop3"].item()) & 0xFFFFFFFF)
        return out

    run.captured = getattr(step, "captured", False)
    trainer._train_step = run
    try:
        trainer.run()
    finally:
        trainer._train_step = step
    return seeds, step_s


def _family_witness(torch, cfg, loader):
    """FAMILY_WITNESS_STEPS steps and an eval of the family's config from
    one init over the first batches of the loader's arrays, through the
    eager and the captured step, cuDNN deterministic: state and epoch
    sums bit for bit, the same seed each step on both sides, a new seed
    every step."""
    from veles_tpu_torch.loader.base import TRAIN, VALID
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.runtime.decision import Decision
    from veles_tpu_torch.runtime.snapshotter import wstate_to_numpy
    from veles_tpu_torch.runtime.step_cache import StepCache
    b = loader.minibatch_size
    n = FAMILY_WITNESS_STEPS * b
    runs, states = {}, {}
    with _cudnn_deterministic(torch):
        for capture in (False, True):
            small = FullBatchLoader(
                {TRAIN: loader._data[TRAIN][:n], VALID: loader._data[VALID][:b]},
                {TRAIN: loader._labels[TRAIN][:n],
                 VALID: loader._labels[VALID][:b]},
                minibatch_size=b, device=DEVICE)
            tr = StandardWorkflow(cfg["workflow"]).make_trainer(
                small, Decision(max_epochs=1), device=DEVICE,
                step_cache=StepCache(capture=capture))
            seeds, step_s = _seeded_run(torch, tr)
            states[capture] = wstate_to_numpy(tr.wstate)
            runs[capture] = {"seeds": seeds,
                             "step_ms_median": float(np.median(step_s)) * 1e3,
                             "epoch": tr.decision.history[0],
                             "step_cache": tr.step_cache.stats()}
            del tr, small
    diff = _state_diff(torch, states[False], states[True])
    seeds = runs[True]["seeds"]
    rec = {"steps": FAMILY_WITNESS_STEPS, "cudnn_deterministic": True,
           "eager": runs[False], "captured": runs[True],
           "state_leaves_differing": diff,
           "epoch_sums_equal": runs[False]["epoch"] == runs[True]["epoch"],
           "same_seeds": seeds == runs[False]["seeds"],
           "distinct_seeds": len(set(seeds))}
    rec["ok"] = (runs[True]["step_cache"]["train"] == {"captured": True,
                                                       "reason": None}
                 and not diff and rec["epoch_sums_equal"]
                 and rec["same_seeds"]
                 and rec["distinct_seeds"] == FAMILY_WITNESS_STEPS)
    return rec


def _family_step_f32_check(torch, trainer):
    """One float32 forward/backward of the family's workflow through the
    kernels and one through the plain versions (the dropout wrapper's
    route patched), from the trainer's weights, its first train batch
    and one key: loss and gradient norms within STEP_LOSS_RTOL /
    STEP_GRAD_RTOL, the drop3 masks identical; cuDNN deterministic."""
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.ops.kernels import fused_dropout
    from veles_tpu_torch.units.workflow import seed_key, split_state_key
    wf, ws = trainer.workflow, trainer.wstate
    batch = next(trainer.loader.iter_epoch(TRAIN, 0)).gather()
    _, sub = split_state_key(seed_key(0))
    with _cudnn_deterministic(torch):
        before = fused_dropout.launches.count
        k_loss, k_norms, k_zero = _loss_and_grad_norms(
            torch, wf, ws["params"], batch, ws["state"], sub, ("drop3",))
        mid = fused_dropout.launches.count
        with plain_routes((fused_dropout,)):
            p_loss, p_norms, p_zero = _loss_and_grad_norms(
                torch, wf, ws["params"], batch, ws["state"], sub,
                ("drop3",))
        after = fused_dropout.launches.count
    loss_rel = abs(k_loss - p_loss) / max(abs(p_loss), 1e-12)
    grad_rel = {n: abs(k_norms[n] - p_norms[n]) / max(p_norms[n], 1e-12)
                for n in p_norms}
    worst = max(grad_rel, key=grad_rel.get)
    mask_same = bool(torch.equal(k_zero["drop3"], p_zero["drop3"]))
    return {"loss_kernels": k_loss, "loss_plain": p_loss,
            "loss_rel_diff": loss_rel, "loss_rtol": STEP_LOSS_RTOL,
            "grad_norm_max_rel_diff": grad_rel[worst], "worst": worst,
            "grad_rtol": STEP_GRAD_RTOL, "drop3_masks_identical": mask_same,
            "drop3_zero_share": float(p_zero["drop3"].float().mean()),
            "kernel_launches": mid - before, "plain_launches": after - mid,
            "ok": (mid - before == 2 and after == mid and mask_same
                   and np.isfinite(k_loss) and loss_rel <= STEP_LOSS_RTOL
                   and grad_rel[worst] <= STEP_GRAD_RTOL)}


def _family_gather_timing(torch, loader, path="synthdigits_conv"):
    """The batch gather at a card-resident loader's shape (the family's:
    100 rows of the 784-float images, their int32 labels and the @mask
    from the 60k train class), on the epoch's order as the loader
    launches it; its plain version; no single PyTorch call gathers
    several arrays."""
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.ops.kernels import gather_rows as gr
    arrays = list(loader._dev_data[TRAIN].values())
    n, m = arrays[0].shape[0], loader.minibatch_size
    perm = gr.index_tensor(np.random.default_rng(0).permutation(n), n, n,
                           "cuda")
    outs = [torch.empty((m,) + a.shape[1:], dtype=a.dtype, device="cuda")
            for a in arrays]
    refs = [torch.empty_like(o) for o in outs]
    mask, ref_mask = (torch.empty(m, device="cuda") for _ in range(2))
    gr.gather_batch(arrays, outs, perm, 0, m, mask)
    gr.gather_batch_plain(arrays, refs, perm, 0, m, ref_mask)
    torch.cuda.synchronize()
    same = (all(torch.equal(o, r) for o, r in zip(outs, refs))
            and bool(torch.equal(mask, ref_mask)))
    if not same:
        fail("the batch gather disagrees with its plain version at the "
             "family's shape")
    row_bytes = [int(np.prod(a.shape[1:])) * a.element_size()
                 for a in arrays]
    g_bound = cost_bound(gr.cost(arrays, m, mask=True), H100_F32_FLOPS)
    return {"max_abs_err": 0.0, "variant": "batch", "path": path,
            "ms": cuda_ms(torch, lambda: gr.gather_batch(
                arrays, outs, perm, 0, m, mask), iters=50),
            "plain_ms": cuda_ms(torch, lambda: gr.gather_batch_plain(
                arrays, outs, perm, 0, m, mask), iters=50),
            "library_ms": None, "bound_ms": g_bound[0],
            "bound_by": g_bound[1],
            "shape": {"rows": n, "m": m, "arrays": [
                str(a.dtype).split(".")[-1] for a in arrays],
                "row_bytes": row_bytes}}


def phase_image_family(torch):
    """configs/synthdigits_conv.json at its published widths and
    minibatch through ``StandardWorkflow.make_trainer`` -> ``Trainer``
    for one epoch (600 steps of 100) and its eval over the mnist loader's
    SynthDigits held on the card; the train and eval steps captured (no
    reason given), the dropout and gather launches exact (2 dropout
    launches a step and the capture's warm-ups; one gather a batch) and
    held against a profiled window's trace; the step times, samples/s
    and idle share; 8 captured steps bitwise 8 eager ones; the float32
    step through the kernels against the plain versions; the gather's
    time at this shape."""
    from veles_tpu_torch.loader.base import TRAIN, VALID
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.ops.kernels import fused_dropout, gather_rows
    from veles_tpu_torch.runtime.decision import Decision
    from veles_tpu_torch.runtime.step_cache import WARMUP_STEPS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _config(FAMILY_CONFIG)
    loader, data = _mnist_loader(torch, cfg["loader"]["minibatch_size"])
    sw = StandardWorkflow(cfg["workflow"])
    run = _counted_run(torch, sw.make_trainer(
        loader, Decision(max_epochs=1), device=DEVICE), 0.0)
    trainer, step_s, losses = run["trainer"], run["step_s"], run["losses"]
    steps, b = len(step_s), loader.minibatch_size
    valid_batches = loader.n_minibatches(VALID)
    med = float(np.median(step_s))
    launches = run["launches"]
    want = {fused_dropout.NAME: 2 * (steps + WARMUP_STEPS),
            gather_rows.NAME: steps + valid_batches}
    hist = trainer.decision.history[0]
    rec = {"phase": "image_family", "config": FAMILY_CONFIG, **data,
           "train_rows": loader.class_lengths[TRAIN],
           "valid_rows": loader.class_lengths[VALID], "minibatch": b,
           "steps": steps, "run_s": run["wall"],
           "step_ms_median": med * 1e3, "step_ms_max": max(step_s) * 1e3,
           "train_samples_per_s": b / med,
           "epoch_samples_per_s": steps * b / run["wall"],
           "first_losses": losses[:4], "last_loss": losses[-1],
           "train": hist["train"], "valid": hist["valid"],
           "launches": launches, "launches_expected": want,
           "step_cache": run["step_cache"]}
    say(rec)
    st = run["step_cache"]
    if st["train"] != {"captured": True, "reason": None} \
            or not st["eval"]["captured"]:
        fail(f"synthdigits_conv's steps are not captured: {st}")
    if any(launches[k] != n for k, n in want.items()) \
            or run["variants"].get(gather_rows.NAME) != {
                "batch": want[gather_rows.NAME]}:
        fail(f"synthdigits_conv's epoch launched {launches}, expected "
             f"{want}")
    if steps != loader.n_minibatches(TRAIN) \
            or not all(np.isfinite(losses)):
        fail(f"synthdigits_conv ran {steps} steps or a loss is not finite")
    profile = _train_profile(torch, trainer,
                             f"3 synthdigits_conv train steps of {b}")
    say({"phase": "image_family_profile", **profile})
    if not profile["launch_trace"]["ok"]:
        fail(f"synthdigits_conv: counted launches and the trace differ: "
             f"{profile['launch_trace']}")
    witness = _family_witness(torch, cfg, loader)
    say({"phase": "image_family_capture_witness", **witness})
    if not witness["ok"]:
        fail(f"synthdigits_conv: captured and eager steps differ: "
             f"{witness}")
    agreement = _family_step_f32_check(torch, trainer)
    say({"phase": "image_family_f32_kernel_vs_plain", **agreement})
    if not agreement["ok"]:
        fail(f"synthdigits_conv float32 step: kernels and plain versions "
             f"disagree: {agreement}")
    gather = _family_gather_timing(torch, loader)
    say({"phase": "image_family_gather_timing", **gather})
    return {"launches": launches, "timing": {
        gather_rows.NAME + "/synthdigits_conv": gather}}


def phase_image_quality(torch):
    """configs/synthdigits_conv.json through the CLI on the card, its
    published 20 epochs, to the bar (BASELINE.md:138)."""
    here = os.path.dirname(os.path.abspath(__file__))
    warm = _digits_cache_warm()
    cmd = [sys.executable, "-m", "veles_tpu_torch",
           os.path.join(here, FAMILY_CONFIG), "--random-seed", "1"]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                           timeout=600)
    except subprocess.TimeoutExpired:
        fail("the synthdigits_conv CLI run exceeded 600 s")
    took = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"the synthdigits_conv CLI run exited {r.returncode}: "
             f"{r.stderr[-2000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    epochs = [ln.split("Decision: ")[-1] for ln in r.stderr.splitlines()
              if "error_pct=" in ln]
    rec = {"phase": "image_quality", "config": FAMILY_CONFIG,
           "cache_warm": warm, "best_error_pct": res["best_value"],
           "best_epoch": res["best_epoch"], "epochs": res["epochs"],
           "seconds": took, "train_s": res["elapsed_s"],
           "train_samples_per_s": res["train_samples_per_s"],
           "bar": FAMILY_BAR, "per_epoch": epochs}
    say(rec)
    if not res["best_value"] <= FAMILY_BAR:
        fail(f"synthdigits_conv reached {res['best_value']} % validation "
             f"error, above the {FAMILY_BAR} % bar")
    return rec


def _ae_run(torch, layers_cfg, loader):
    """A trainer of ``layers_cfg`` (an MSE-against-input workflow) over
    ``loader`` for one epoch: the validation rmse before and after, the
    epoch's train rmse, its steps captured."""
    from veles_tpu_torch.loader.base import VALID
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.runtime.decision import Decision
    tr = StandardWorkflow(layers_cfg).make_trainer(
        loader, Decision(max_epochs=1), device=DEVICE)
    tr.initialize(seed=0)
    before = tr._run_epoch_eval(VALID, 0)["rmse"]
    t0 = time.perf_counter()
    tr.run()
    wall = time.perf_counter() - t0
    (ep,) = tr.decision.history
    st = tr.step_cache.stats()
    rec = {"metric": ep["metric"], "valid_rmse_before": before,
           "valid_rmse_after": ep["valid"]["rmse"],
           "train_rmse": ep["train"]["rmse"],
           "train_batches": ep["train"]["n_batches"], "run_s": wall,
           "captured": st["train"]["captured"] and st["eval"]["captured"]}
    rec["ok"] = (rec["metric"] == "rmse" and rec["captured"]
                 and all(np.isfinite([before, rec["valid_rmse_after"],
                                      rec["train_rmse"]]))
                 and rec["valid_rmse_after"] < before)
    return rec


def phase_image_ae(torch):
    """configs/synthdigits_ae.json for one epoch on the card over the
    mnist loader (600 steps of 100): the rmse gauge finite and falling
    (validation rmse after the epoch below the initial weights'); then
    the conv autoencoder (reshape -> conv -> pool -> depool -> deconv ->
    flatten, ``mse_input``) over AE_CONV_TRAIN SynthDigits, a few steps,
    the same."""
    from veles_tpu_torch.loader.base import TRAIN, VALID
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    cfg = _config(AE_CONFIG)
    loader, data = _mnist_loader(torch, cfg["loader"]["minibatch_size"])
    fc = _ae_run(torch, cfg["workflow"], loader)
    conv_cfg = {"name": "ConvAE", "loss": "mse_input",
                "optimizer": "adadelta", "optimizer_args": {"lr": 1.0},
                "layers": [
                    {"type": "reshape", "shape": [28, 28, 1],
                     "name": "img"},
                    {"type": "conv_relu", "n_kernels": 8, "kx": 3,
                     "padding": 1, "name": "enc_conv"},
                    {"type": "max_pooling", "window": 2, "stride": 2,
                     "name": "enc_pool"},
                    {"type": "depool", "window": 2, "name": "dec_depool"},
                    {"type": "deconv", "n_kernels": 1, "kx": 3,
                     "padding": "SAME", "name": "dec_deconv"},
                    {"type": "flatten", "name": "flat"}]}
    small = FullBatchLoader(
        {TRAIN: loader._data[TRAIN][:AE_CONV_TRAIN],
         VALID: loader._data[VALID][:AE_CONV_VALID]}, {},
        minibatch_size=loader.minibatch_size, device=DEVICE)
    conv = _ae_run(torch, conv_cfg, small)
    rec = {"phase": "image_ae", "config": AE_CONFIG, **data,
           "synthdigits_ae": fc, "conv_autoencoder": conv}
    say(rec)
    if not (fc["ok"] and conv["ok"]):
        fail(f"the autoencoders' rmse is not finite and falling: {rec}")
    return rec


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
    """POST /generate with ``"stream": true``: (the NDJSON frames, the
    seconds to the first one)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    frames, first = [], None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.headers["Content-Type"] != "application/x-ndjson":
            fail(f"a streamed /generate answered {r.headers['Content-Type']}")
        for line in r:
            if line.strip():
                frames.append(json.loads(line))
                if first is None:
                    first = time.perf_counter() - t0
    return frames, first


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
    frames, _ = _stream(port, {"prompt": greedy[:1, :PROMPT].tolist(),
                               "steps": NEW,
                               "stop": [g0[k:k + 2].tolist()]})
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

    from veles_tpu_torch.config import root
    wf = _workflow(torch, "bfloat16")
    flat = jax_layout_weights(wf, seed=0)
    wstate = new_state(params_from_jax(flat, wf, device=DEVICE), {}, {}, 0,
                       None)
    root.common.observe.peak_hbm_gbps = PEAK_HBM_GBPS
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
        gauges = _GaugeSampler()
        t0 = time.perf_counter()
        greedy = np.asarray(_post(srv.port, "/generate", {
            "prompt": prompts.tolist(), "steps": NEW})["tokens"])
        t_greedy = time.perf_counter() - t0
        stats_greedy = engine.stats()
        goodput = gauges.stop(stats_greedy)
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
            and trace["per_replay"].get(PAGED_F32) == LAYERS):
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
    say({"phase": "serving_goodput", **goodput})
    if not (goodput["decode_bandwidth_bytes_per_sec"] > 0
            and goodput["decode_mbu"] > 0
            and goodput["headroom_slots_under_load"] == 0
            and goodput["idle_to_zero_s"] is not None):
        fail(f"the goodput gauges did not read the greedy request or did "
             f"not fall to 0 at idle: {goodput}")
    say({"phase": "serving_capture_witness",
         **_serving_witness(torch, wf, wstate)})
    _serving_agreement(torch, wf, wstate, flat, prompts, greedy)
    # what the artifact phase holds its sealed programs to
    live = {"prompts": prompts, "greedy": greedy,
            "metrics": {"prompt": PROMPT, "new": NEW,
                        **_serve_metrics(stats_greedy, t_greedy)}}
    return launches, live


class _GaugeSampler:
    """Samples the engine's goodput gauges from ``/metrics``'s registry
    every 20 ms while a request runs; :meth:`stop` returns the last
    nonzero bandwidth and MBU the gauges published under load, the least
    headroom, and how long the bandwidth gauge took to fall to 0 once the
    engine idled (None past 10 s)."""

    def __init__(self):
        import threading
        from veles_tpu_torch.runtime.metrics import registry
        reg = registry()
        self.names = ("vt_decode_bandwidth_bytes_per_sec", "vt_decode_mbu",
                      "vt_memory_headroom_slots",
                      "vt_tokens_per_sec_per_chip")
        self.gauges = [reg.get(n) for n in self.names]
        self.samples = []
        self.halt = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self.halt.wait(0.02):
            self.samples.append([g.value if g is not None else None
                                 for g in self.gauges])

    def stop(self, stats):
        self.halt.set()
        self.thread.join(10)
        busy = [s for s in self.samples if s[0]]
        last = busy[-1] if busy else [0.0, 0.0, None, 0.0]
        t0 = time.perf_counter()
        bw = self.gauges[0]
        while bw.value != 0 and time.perf_counter() - t0 < 10:
            time.sleep(0.05)
        return {"decode_bandwidth_bytes_per_sec": last[0],
                "decode_mbu": last[1],
                "tokens_per_sec_per_chip": last[3],
                "headroom_slots_under_load": min(
                    (s[2] for s in self.samples if s[2] is not None),
                    default=None),
                "samples": len(self.samples), "busy_samples": len(busy),
                "peak_hbm_gbps": PEAK_HBM_GBPS,
                "idle_to_zero_s": time.perf_counter() - t0
                if bw.value == 0 else None,
                "stats_goodput": stats["goodput"]}


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
    engine._thread = threading.current_thread()    # submit() wants one
    try:
        reqs = [engine.submit(row, PROFILE_NEW) for row in prompts]
        engine._admit()
        while engine._chunking:
            engine._advance_prefills()
        torch.cuda.synchronize()
        with _profiled(torch, lambda: torch.ones(
                1, device=engine.device).sum()) as win:
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
    rec = _busy(win["prof"], wall, f"{len(prompts)} x decode "
                                   f"{PROFILE_NEW - 1} after the prefill")
    rec["replays"] = {k: c1[k] - c0[k] for k in engine._fns}
    rec["launch_trace"] = _launch_trace_check(win, [
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
    paged = PAGED_F32
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
    paged = PAGED_F32
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
    names = _leaf_names(live)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    zeros = {n: (outputs[n] == 0).detach() for n in zeros_of}
    return float(loss.detach()), {n: float(g.float().norm())
                                  for n, g in zip(names, grads)}, zeros


def _leaf_names(tree, prefix=""):
    """``unit/param`` names of a param tree's leaves in ``tree_leaves``
    order (a pipeline stack's nest as ``stack/s0/<unit>/<param>``)."""
    out = []
    for k in sorted(tree):
        p = f"{prefix}/{k}" if prefix else k
        out += _leaf_names(tree[k], p) if isinstance(tree[k], dict) \
            else [p]
    return out


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
    # goodput: the counted step against the analytic one
    res = run["results"]
    analytic = analytic_train_flops()
    rec.update(train_step_flops=res["train_step_flops"],
               train_mfu=res["train_mfu"], peak_tflops=res["peak_tflops"],
               analytic_step_flops=analytic,
               step_flops_rel_diff=res["train_step_flops"] / analytic - 1,
               achieved_tflops_median_step=res["train_step_flops"] / med
               / 1e12)
    say(rec)
    if not abs(rec["step_flops_rel_diff"]) <= FLOPS_RTOL:
        fail(f"train_step_flops {res['train_step_flops']:.6g} is more than "
             f"{FLOPS_RTOL:.0%} off the analytic {analytic:.6g}")
    if not (res["peak_tflops"] > 0 and res["train_mfu"] > 0):
        fail(f"the LM epoch reported no MFU: {res}")
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
    # the float32 witness's captured run (counts set to 0 before it): every
    # flash launch on float32's variant of its kernel
    f32_run = eager["captured"]
    f32_flash = {k.NAME: f32_run["launches"][k.NAME] for k in
                 (flash_attention, flash_bwd_dq, flash_bwd_dkv)}
    if not all(n and f32_run["variants"].get(name) == {F32_VARIANT: n}
               for name, n in f32_flash.items()):
        fail(f"the float32 LM steps did not launch float32's flash "
             f"variants: {f32_run['variants']}")
    lm_f32 = _f32_flash_timing(torch, TRAIN_B, TRAIN_T, HEADS, E // HEADS,
                               "lm_f32", "the full-width f32 LM's")
    say({"phase": "train_f32_kernel_timing",
         "library_note": "library_ms of both flash backward kernels is one "
                         "SDPA backward (dQ, dK and dV together), float32",
         "witness_launches": f32_flash, **lm_f32})
    rollback = _rollback_check(torch)
    say({"phase": "train_rollback", **rollback})
    if not rollback["ok"]:
        fail(f"a Decision rollback recaptured or did not roll back: "
             f"{rollback}")
    return launches, {"timing": lm_f32,
                      "launches": {f"{name}/lm_f32": n
                                   for name, n in f32_flash.items()}}


def analytic_train_flops():
    """The full-width LM's train step by hand: every matrix product of
    the forward (q, k, v, o projections and the FFN's two a block, the
    head) at 2·M·N·K, times 3 with the backward's two products each,
    plus the flash kernels' 4 + 6 + 8 = 18·B·H·D a scored causal pair a
    layer."""
    m = TRAIN_B * TRAIN_T
    fwd = LAYERS * (4 * 2 * m * E * E + 2 * 2 * m * E * FFN) \
        + 2 * m * E * VOCAB
    pairs = TRAIN_T * (TRAIN_T + 1) // 2
    return 3 * fwd + LAYERS * 18 * TRAIN_B * HEADS * (E // HEADS) * pairs


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
            "step_cache": run["step_cache"], "launches": run["launches"],
            "variants": run["variants"]}
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
    from veles_tpu_torch.loader.base import TRAIN
    warm, *batches = [b for _, b in zip(range(4),
                                        trainer.loader.iter_epoch(TRAIN, 0))]

    def step(batch):
        trainer.wstate, _ = trainer._train_step(trainer.wstate, batch)

    torch.cuda.synchronize()
    with _profiled(torch, lambda: step(warm), cpu=True) as win:
        t0 = time.perf_counter()
        for b in batches:
            step(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rec = _busy(win["prof"], wall, window, steps=len(batches))
    rec["launch_trace"] = _launch_trace_check(
        win, [(trainer._train_step, len(batches))])
    return rec


def _settle(torch):
    """A pause at each end of a profiled window, after the profiler's
    step into its active window and before the window closes.  Kineto
    drops a device record whose timestamp, converted to the host's
    clock, falls outside its capture window (it counts them only in its
    log, "Out-of-range = N"), and the conversion can shift a whole
    window's kernels by milliseconds, before or after their launch (each
    window's ``clock`` record shows where they fell; PERF.md section 6).
    Nothing launches during the pauses, and each window's wall is taken
    before the closing one."""
    time.sleep(0.5)
    torch.cuda.synchronize()


#: kineto's log level in this process (set before torch loads it): INFO,
#: so each closed window logs its "Record counts: Out-of-range = N" line
#: (the records it dropped as outside its capture window)
KINETO_LOG_LEVEL = "1"
_KINETO_LINE = re.compile(r"^(VERBOSE|INFO|WARNING|ERROR|STAGE):\d{4}-")


@contextlib.contextmanager
def _kineto_log():
    """The process's stderr (fd 2) into a temporary file for the block:
    yields a list that, after it, holds kineto's own log lines of the
    block; every other line is written back to stderr."""
    import tempfile
    lines = []
    with tempfile.TemporaryFile() as tmp:
        sys.stderr.flush()
        saved = os.dup(2)
        os.dup2(tmp.fileno(), 2)
        try:
            yield lines
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
            tmp.seek(0)
            for ln in tmp.read().decode(errors="replace").splitlines():
                if _KINETO_LINE.match(ln):
                    lines.append(ln)
                else:
                    print(ln, file=sys.stderr)
            sys.stderr.flush()


@contextlib.contextmanager
def _profiled(torch, warm, cpu=False):
    """A profiled window (CUDA activity, and the host's with ``cpu``):
    ``warm()`` runs as the profiler's warm-up step, traced and discarded
    (the trace can miss a kernel launched right after it starts), then
    the body between two :func:`_settle` pauses.  Yields a dict the
    body's counts and :func:`_launch_trace_check` read: ``counted0``
    (every launch counter before the body), ``t0_ns`` / ``t1_ns`` (the
    host clock, ``time.time_ns()``, at the body's start and after it,
    synchronized) and, once the window closes, ``prof`` and
    ``out_of_range`` (the records kineto logged as outside its window,
    None where it logged no count)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from veles_tpu_torch.ops.kernels import KERNELS
    acts = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    win = {}
    with _kineto_log() as log:
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            warm()
            torch.cuda.synchronize()
            prof.step()
            _settle(torch)
            win["counted0"] = {k.NAME: k.launches.state() for k in KERNELS}
            win["t0_ns"] = time.time_ns()
            yield win
            torch.cuda.synchronize()
            win["t1_ns"] = time.time_ns()
            _settle(torch)
    win["prof"] = prof
    counts = [int(n) for ln in log
              for n in re.findall(r"Out-of-range = (\d+)", ln)]
    win["out_of_range"] = counts[-1] if counts else None


def _device_kernels(prof):
    """``(name, start_ns, end_ns)`` of every kernel in a closed window's
    trace, on the host clock the profiler converts the device's to
    (None where this PyTorch does not expose its raw events)."""
    from torch.autograd import DeviceType
    try:
        events = prof.profiler.kineto_results.events()
        return [(e.name(), e.start_ns(), e.end_ns()) for e in events
                if e.device_type() == DeviceType.CUDA
                and not e.name().startswith("ProfilerStep")]
    except AttributeError:
        return None


def _trace_clock(win, sym=None):
    """Where a window's traced kernels (those of ``sym`` alone, when
    given) sit on the host clock: ``lead_ms`` = the first one's start
    minus ``t0_ns``, ``lag_ms`` = ``t1_ns`` minus the last one's end, and
    their count; both >= 0 when the device's timestamps agree with the
    host's, and a record the profiler drops for lying outside its window
    (the window reaches 0.5 s past either end) shows as a skew beyond
    that margin."""
    kernels = _device_kernels(win["prof"])
    if kernels is None:
        return None
    pat = re.compile(rf"(?<!\w){sym}(?!\w)") if sym else None
    times = sorted((a, b) for n, a, b in kernels
                   if pat is None or pat.search(n))
    if not times:
        return {"traced": 0}
    return {"traced": len(times),
            "lead_ms": (times[0][0] - win["t0_ns"]) / 1e6,
            "lag_ms": (win["t1_ns"] - times[-1][1]) / 1e6}


#: the ``__global__`` function each wrapper launches, by the variant its
#: launch counter names (None: a kernel built in one variant)
KERNEL_SYMBOLS = {
    "flash_attention": {"tc": "flash_fwd_tc",
                        "tf32x3": "flash_fwd_tf32x3"},
    "flash_bwd_dq": {"tc": "flash_bwd_dq_tc",
                     "tf32x3": "flash_bwd_dq_tf32x3"},
    "flash_bwd_dkv": {"tc": "flash_bwd_dkv_tc",
                      "tf32x3": "flash_bwd_dkv_tf32x3"},
    "gather_rows": {"batch": "gather_batch_kernel",
                    "rows": "gather_rows_kernel"},
    "fused_dropout": {None: "dropout_kernel"},
    "mean_disp_normalize": {None: "mean_disp_kernel"},
    "paged_attention_decode": {"f32_pool": "paged_decode_kernel",
                               "bf16_pool": "paged_decode_bf16pool_kernel",
                               "f16_pool": "paged_decode_f16pool_kernel"},
}
#: the paged kernel's variant (its launch counter's name) of a pool dtype
POOL_VARIANTS = {"float32": "f32_pool", "bfloat16": "bf16_pool",
                 "float16": "f16_pool"}
#: the f32-pool paged kernel's label in a launch trace check
PAGED_F32 = "paged_attention_decode/f32_pool"


def _launch_trace_check(win, replays):
    """The launch counts of a profiled window (:func:`_profiled`) held
    against the kernels the device ran: for every wrapper and variant,
    the kernels of its ``__global__`` name in the trace must equal the
    counter's change over the window, and each captured step's share of
    that change must be at least its replays in the window (``replays``:
    ``[(step, n)]``) times what the cache recorded at capture
    (``per_replay`` sums one replay of each program the window
    replayed).  So a replayed graph that no longer runs a kernel it
    counts, or runs one it does not count, fails.  ``clock`` places the
    window's traced kernels on the host clock (:func:`_trace_clock`),
    and a mismatch names where the label's traced kernels sat."""
    from veles_tpu_torch.ops.kernels import KERNELS
    prof, counted0 = win["prof"], win["counted0"]
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
                           f"{counted[label]}; on the host clock "
                           f"{_trace_clock(win, sym)}; kineto dropped "
                           f"{win['out_of_range']} records as outside "
                           f"its window")
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
            "clock": _trace_clock(win),
            "kineto_out_of_range": win["out_of_range"],
            "mismatch": bad, "ok": not bad}


#: kernel-name pieces whose device time a profiled step reports apart
FLASH_KERNELS = ("flash_fwd_tc", "flash_fwd_tf32x3", "flash_bwd_dkv_tc",
                 "flash_bwd_dkv_tf32x3", "flash_bwd_dq_tc",
                 "flash_bwd_dq_tf32x3")


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


#: a CLI child that runs ``python -m veles_tpu_torch``'s ``main`` with its
#: own arguments and then prints every kernel's launches by variant on
#: the last line of its standard error
CLI_COUNTED = (
    "import json, sys\n"
    "from veles_tpu_torch.__main__ import main\n"
    "from veles_tpu_torch.ops.kernels import KERNELS\n"
    "rc = main(sys.argv[1:])\n"
    "print(json.dumps({k.NAME: k.launches.by_variant() or k.launches.count"
    " for k in KERNELS}), file=sys.stderr, flush=True)\n"
    "sys.exit(rc)\n")


def phase_quality(torch, snap_dir):
    """The family's quality bar through the CLI, on the card (every f32
    flash launch of the run on float32's variants, by the child's own
    counters); its snapshots go to ``snap_dir`` and the best one's
    manifest path is returned (the fleet phase's CLI serves it)."""
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-c", CLI_COUNTED,
           os.path.join(here, "configs", "induction_lm.json"),
           "--random-seed", "1", "--snapshot-dir", snap_dir]
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
    variants = json.loads(r.stderr.strip().splitlines()[-1])
    epochs = [ln for ln in r.stderr.splitlines() if "error_pct=" in ln]
    rec = {"phase": "quality", "config": "configs/induction_lm.json",
           "best_error_pct": res["best_value"],
           "best_epoch": res["best_epoch"], "epochs": res["epochs"],
           "seconds": took, "train_samples_per_s":
               res["train_samples_per_s"], "bar": QUALITY_BAR,
           "flash_variants": {n: variants[n] for n in FLASH_NAMES},
           "per_epoch": [ln.split("Decision: ")[-1] for ln in epochs]}
    say(rec)
    if not all(len(variants[n]) == 1 and variants[n].get(F32_VARIANT)
               for n in FLASH_NAMES):
        fail(f"the induction_lm CLI run did not launch float32's flash "
             f"variants alone: {rec['flash_variants']}")
    if not res["best_value"] <= QUALITY_BAR:
        fail(f"induction_lm reached {res['best_value']} % validation "
             f"error, above the {QUALITY_BAR} % bar")
    best = os.path.join(snap_dir, "InductionLM_best.json")
    if not os.path.exists(best):
        fail(f"the induction_lm CLI run wrote no best snapshot in "
             f"{snap_dir}: {sorted(os.listdir(snap_dir))}")
    return best


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
    prompts = np.random.default_rng(12).integers(
        0, VOCAB, (SLOTS, PROFILE_PROMPT)).astype(np.int32)
    with _profiled(torch, lambda: engine.generate(prompts[:, :4], 2,
                                                  timeout=900)) as win:
        s0 = engine.stats()
        t0 = time.perf_counter()
        engine.generate(prompts, PROFILE_NEW, timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s1 = engine.stats()
    rec = _busy(win["prof"], wall, f"{SLOTS} x (prefill {PROFILE_PROMPT} "
                                   f"+ decode {PROFILE_NEW})")
    c0, c1 = _dispatch_counts(s0), _dispatch_counts(s1)
    rec["replays"] = {k: c1[k] - c0[k] for k in engine._fns}
    rec["launch_trace"] = _launch_trace_check(win, [
        (engine._fns[k], n) for k, n in rec["replays"].items()])
    return rec



# -- the bf16 KV cache and the serving lifecycle ---------------------------

def _bench_state(torch, compute_dtype, seed):
    """The bench LM's workflow and a state of numpy-seed weights in the
    JAX package's layout (``jax_layout_weights``) on the card."""
    from veles_tpu_torch.runtime.snapshotter import params_from_jax
    from veles_tpu_torch.units.workflow import new_state
    wf = _workflow(torch, compute_dtype)
    return wf, new_state(params_from_jax(jax_layout_weights(wf, seed), wf,
                                         device=DEVICE), {}, {}, 0, None)


def _serve_engine(wf, wstate, **kw):
    from veles_tpu_torch.runtime.engine import DecodeEngine
    kw = {"slots": SLOTS, "l_max": L_MAX, "page_size": PAGE, "paged": True,
          "paged_kernel": True, "window_ms": 2.0, "device": DEVICE, **kw}
    return DecodeEngine(wf, wstate, **kw)


def _reset_counts():
    from veles_tpu_torch.ops.kernels import KERNELS
    for kern in KERNELS:
        kern.launches.reset()


def _paged_variants():
    from veles_tpu_torch.ops.kernels import paged_attention
    return paged_attention.launches.by_variant()


def phase_bf16_cache(torch):
    """``cache_dtype=torch.bfloat16`` at full width: the greedy SLOTS x
    (PROMPT + NEW) request on a captured bf16-cache engine (bf16
    compute) and on an f32-pool engine built the same way, timed in this
    run; WITNESS_ITERS scheduler iterations on a captured and an eager
    bf16-cache engine, tokens and pools bitwise; in float32 compute, the
    greedy agreement of a bf16-cache engine with the port's
    ``generate(cache_dtype=bfloat16)`` must be 1.0.  The paged kernel's
    bf16-pool launches of the phase must be one a layer a micro-step of
    its bf16-cache engines (capture warm-ups included), counted from 0
    at the phase's start."""
    from veles_tpu_torch.runtime.generate import generate
    bf16 = torch.bfloat16
    wf, wstate = _bench_state(torch, "bfloat16", 0)
    prompts = np.random.default_rng(1).integers(
        0, VOCAB, (SLOTS, PROMPT)).astype(np.int32)
    _reset_counts()
    bf16_engines, f32_engines = [], []
    runs = {"bf16_pool": [], "f32_pool": []}
    # the two pools in turns (A B B A): a later engine of a run has read
    # slower for the same graph (PERF.md section 7)
    for name, cdt in (("bf16_pool", bf16), ("f32_pool", torch.float32),
                      ("f32_pool", torch.float32), ("bf16_pool", bf16)):
        eng = _serve_engine(wf, wstate, cache_dtype=cdt).start()
        try:
            toks, metrics = _timed_generate(eng, prompts, NEW)
            st = eng.stats()
        finally:
            eng.stop()
        metrics["device_ms"] = _replay_ms(torch, eng)
        runs[name].append((toks, metrics, st))
        (bf16_engines if cdt == bf16 else f32_engines).append(st)
        del eng
    # captured against eager, bit for bit, on a bf16 pool
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
    witness = {}
    for capture in (True, False):
        eng = _serve_engine(wf, wstate, cache_dtype=bf16, window_ms=0.0,
                            capture=capture)
        reqs = _drive(torch, eng, script, WITNESS_ITERS)
        witness[capture] = (eng, reqs)
        bf16_engines.append(eng.stats())
    (cap, creqs), (eag, ereqs) = witness[True], witness[False]
    done = [a.done.is_set() and b.done.is_set() for a, b in zip(creqs,
                                                                ereqs)]
    wit = {"requests": len(creqs), "retired": sum(done),
           "tokens_equal": all(np.array_equal(a.result, b.result)
                               for a, b, d in zip(creqs, ereqs, done) if d),
           "token_rows_equal": bool(np.array_equal(cap._toks, eag._toks)),
           "pools_equal": all(torch.equal(cap._caches[n][k],
                                          eag._caches[n][k])
                              for n in cap._caches for k in ("k", "v")),
           "pool_dtype": str(cap._caches["attn0"]["k"].dtype),
           "captured": cap.stats()["capture"]["decode"]["captured"]}
    del witness, cap, eag
    # float32 compute: greedy agreement with generate() on a bf16 cache
    wf32, ws32 = _bench_state(torch, None, 0)
    f32_prompts = prompts[:, :F32_PROMPT]
    eng = _serve_engine(wf32, ws32, cache_dtype=bf16).start()
    try:
        f32_toks = eng.generate(f32_prompts, F32_NEW, timeout=900)
        bf16_engines.append(eng.stats())
    finally:
        eng.stop()
    ref = generate(wf32, ws32, f32_prompts, F32_NEW,
                   cache_dtype=bf16).cpu().numpy()
    gen = slice(F32_PROMPT, None)
    agreement = float(np.mean(f32_toks[:, gen] == ref[:, gen]))
    variants = _paged_variants()
    want_bf16 = LAYERS * sum(_micro_steps(st, True) for st in bf16_engines)
    want_f32 = LAYERS * sum(_micro_steps(st, True) for st in f32_engines)
    st = runs["bf16_pool"][0][2]
    b_toks = [r[0] for r in runs["bf16_pool"]]
    f_toks = [r[0] for r in runs["f32_pool"]]
    rec = {"prompt": PROMPT, "new": NEW, "order": "bf16 f32 f32 bf16",
           "bf16_pool": [r[1] for r in runs["bf16_pool"]],
           "f32_pool": [r[1] for r in runs["f32_pool"]],
           "greedy_sha256": hashlib.sha256(b_toks[0].astype(
               np.int32).tobytes()).hexdigest(),
           "tokens_repeat": bool(np.array_equal(*b_toks)
                                 and np.array_equal(*f_toks)),
           "bf16_vs_f32_pool_token_agreement": float(np.mean(
               b_toks[0][:, PROMPT:] == f_toks[0][:, PROMPT:])),
           "witness": wit, "f32_agreement_generate": agreement,
           "f32_prompt": F32_PROMPT, "f32_new": F32_NEW,
           "launches": variants, "launches_expected":
               {"bf16_pool": want_bf16, "f32_pool": want_f32},
           "compile": st["compile"], "capture": st["capture"]}
    say({"phase": "serving_bf16_cache", **rec})
    rec["ok"] = (rec["tokens_repeat"] and wit["tokens_equal"]
                 and wit["token_rows_equal"]
                 and wit["pools_equal"] and wit["captured"]
                 and wit["retired"] >= 2
                 and wit["pool_dtype"] == "torch.bfloat16"
                 and agreement == 1.0
                 and variants.get("bf16_pool", 0) == want_bf16 > 0
                 and variants.get("f32_pool", 0) == want_f32
                 and st["capture"]["decode_greedy"]["captured"]
                 and st["compile"]["recompiles"] == 0)
    if not rec["ok"]:
        fail(f"the bf16 KV cache checks failed: {rec}")
    return variants


def phase_f16_cache(torch):
    """``cache_dtype=torch.float16`` at full width: the greedy SLOTS x
    (PROMPT + NEW) request on a captured f16-cache engine (bf16
    compute), timed, with its graphs' device times; in float32 compute
    the greedy tokens of an f16-cache engine must equal an f32-pool
    engine's and the port's ``generate(cache_dtype=float16)``'s.  The
    paged kernel's f16-pool launches of the phase must be one a layer a
    micro-step of its f16-cache engines (capture warm-ups included),
    counted from 0 at the phase's start."""
    from veles_tpu_torch.runtime.generate import generate
    f16 = torch.float16
    wf, wstate = _bench_state(torch, "bfloat16", 0)
    prompts = np.random.default_rng(1).integers(
        0, VOCAB, (SLOTS, PROMPT)).astype(np.int32)
    _reset_counts()
    f16_engines, f32_engines = [], []
    eng = _serve_engine(wf, wstate, cache_dtype=f16).start()
    try:
        toks, metrics = _timed_generate(eng, prompts, NEW)
        st = eng.stats()
    finally:
        eng.stop()
    metrics["device_ms"] = _replay_ms(torch, eng)
    f16_engines.append(st)
    del eng
    # float32 compute: the f16 pool's greedy tokens against the f32
    # pool's and generate()'s on an f16 cache
    wf32, ws32 = _bench_state(torch, None, 0)
    f32_prompts = prompts[:, :F32_PROMPT]
    f32_toks = {}
    for name, cdt in (("f16_pool", f16), ("f32_pool", torch.float32)):
        eng = _serve_engine(wf32, ws32, cache_dtype=cdt).start()
        try:
            f32_toks[name] = eng.generate(f32_prompts, F32_NEW, timeout=900)
            (f16_engines if cdt == f16 else f32_engines).append(
                eng.stats())
        finally:
            eng.stop()
    ref = generate(wf32, ws32, f32_prompts, F32_NEW,
                   cache_dtype=f16).cpu().numpy()
    gen = slice(F32_PROMPT, None)
    vs_pool = float(np.mean(f32_toks["f16_pool"][:, gen]
                            == f32_toks["f32_pool"][:, gen]))
    vs_generate = float(np.mean(f32_toks["f16_pool"][:, gen]
                                == ref[:, gen]))
    variants = _paged_variants()
    want = {"f16_pool": LAYERS * sum(_micro_steps(e, True)
                                     for e in f16_engines),
            "f32_pool": LAYERS * sum(_micro_steps(e, True)
                                     for e in f32_engines)}
    rec = {"prompt": PROMPT, "new": NEW, "f16_pool": metrics,
           "greedy_sha256": hashlib.sha256(toks.astype(
               np.int32).tobytes()).hexdigest(),
           "pool_dtype": "float16",
           "f32_agreement_f32_pool": vs_pool,
           "f32_agreement_generate": vs_generate,
           "f32_prompt": F32_PROMPT, "f32_new": F32_NEW,
           "launches": variants, "launches_expected": want,
           "compile": st["compile"], "capture": st["capture"]}
    say({"phase": "serving_f16_cache", **rec})
    rec["ok"] = (vs_pool == 1.0 and vs_generate == 1.0
                 and variants.get("f16_pool", 0) == want["f16_pool"] > 0
                 and variants.get("f32_pool", 0) == want["f32_pool"]
                 and not variants.get("bf16_pool")
                 and st["capture"]["decode_greedy"]["captured"]
                 and st["compile"]["recompiles"] == 0)
    if not rec["ok"]:
        fail(f"the float16 KV cache checks failed: {rec}")
    return variants


def _remote_sources(torch, wf, ws0, snap_dir):
    """The lifecycle's remote weight sources: the seed-2 weights as a file
    snapshot and as the best row of ``remote.sqlite``, and the seed-0
    ones as a file snapshot served by a ``ThreadingHTTPServer`` on
    127.0.0.1 (``out["server"]``, the caller shuts it down); the http
    manifest's tensors checked bitwise against the served seed-0 ones."""
    import functools
    import http.server
    import threading
    from veles_tpu_torch.runtime.snapshotter import (Snapshotter,
                                                     SnapshotterToDB,
                                                     params_to_numpy)
    _, ws2 = _bench_state(torch, None, 2)
    payload = {"wstate": {"params": params_to_numpy(ws2["params"])},
               "workflow_checksum": wf.checksum()}
    del ws2
    out = {"seed2_file": Snapshotter("remote", os.path.join(
        snap_dir, "seed2"), compression=False).save("seed2", payload)}
    db = os.path.join(snap_dir, "remote.sqlite")
    SnapshotterToDB("remote", db, compression=False).save("seed2", payload,
                                                          best=True)
    out["sqlite"] = f"sqlite://{db}#best"
    http_dir = os.path.join(snap_dir, "http")
    man = Snapshotter("remote", http_dir, compression=False).save(
        "seed0", {"wstate": {"params": params_to_numpy(ws0["params"])},
                  "workflow_checksum": wf.checksum()})
    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    handler = functools.partial(Quiet, directory=http_dir)
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    out["server"] = srv
    out["http"] = (f"http://127.0.0.1:{srv.server_address[1]}/"
                   f"{os.path.basename(man)}")
    got = Snapshotter.load(out["http"])["wstate"]["params"]
    want = params_to_numpy(ws0["params"])
    if not all(np.array_equal(got[u][k], want[u][k]) for u in want
               for k in want[u]):
        fail("the http snapshot's tensors differ from the file's")
    return out


def _swap_under_load(eng, port, load, probe, source, ref):
    """``POST /admin/reload`` of ``source`` while LIFE_THREADS clients
    loop greedy requests: their failures, the captures around it, and the
    probe's tokens after it against ``ref`` (a fresh engine's on the same
    weights)."""
    import threading
    comp0 = eng.stats()["compile"]
    codes, stop, lock = [], threading.Event(), threading.Lock()
    threads = [threading.Thread(target=_hammer, args=(
        port, load[i:i + 1], LIFE_NEW, stop, codes, lock))
        for i in range(LIFE_THREADS)]
    for t in threads:
        t.start()
    _wait(lambda: len(codes) >= LIFE_THREADS, 300, "load to flow")
    code, swap = _http_json(port, "/admin/reload", {"path": source})
    n_at_swap = len(codes)
    if code == 200:
        _wait(lambda: len(codes) >= n_at_swap + LIFE_THREADS, 300,
              "load after the swap")
    stop.set()
    for t in threads:
        t.join(900)
    st = eng.stats()
    got = eng.generate(probe, LIFE_NEW, timeout=900)
    return {"source": source.split("://")[0], "status": code,
            "requests": len(codes), "failed": sum(c != 200 for c in codes),
            "in_engine_at_flip": swap.get("in_flight_at_flip"),
            "stage_ms": swap.get("stage_ms"),
            "flip_ms": swap.get("flip_ms"),
            "compiles_during_swap": swap.get("compiles_during_swap"),
            "captures": [comp0["captures"], st["compile"]["captures"]],
            "recompiles": st["compile"]["recompiles"],
            "tokens_equal_file_boot": bool(np.array_equal(got, ref))}


def _hammer(port, prompts, new, stop, codes, lock):
    """POST /generate of each prompt in turn until ``stop``; each answer's
    status into ``codes``."""
    i = 0
    while not stop.is_set():
        code, _ = _http_json(port, "/generate", {
            "prompt": [prompts[i % len(prompts)].tolist()], "steps": new})
        with lock:
            codes.append(code)
        i += 1


def _http_json(port, path, body=None, method=None):
    data = None if body is None else json.dumps(body).encode()
    code, raw = _http_bytes(port, path, data, method)
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw


#: seconds the lifecycle's on-demand profile (1 s of capture, then the
#: trace's processing and export: about 5 s on an H100) may take
PROFILE_CAPTURE_S = 120


def _hung(what):
    """Fail at once where a thread is stuck in a call that will not
    return: every thread's Python stack to stderr, then out of the
    process without the interpreter's teardown, which would wait on it."""
    import faulthandler
    print(f"chip_smoke: FAIL: {what}; the stacks of every thread follow",
          file=sys.stderr, flush=True)
    faulthandler.dump_traceback(all_threads=True)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(1)


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            fail(f"timed out waiting for {what}")
        time.sleep(0.01)


def phase_lifecycle(torch, snap_dir):
    """The serving lifecycle at full width in float32, through
    ``RestfulServer`` with a ``DeployController``: a hot swap under load
    of LIFE_THREADS concurrent greedy (LIFE_PROMPT + LIFE_NEW) requests to
    a second weight set (numpy seed 1, written as a port snapshot) by
    ``POST /admin/reload`` (at least LIFE_IN_FLIGHT requests in the
    engine at the flip, by its own count; no request fails; the
    allocation peak of the swap one staged copy of the weights over the
    served ones; captures flat, the tokens
    after it a fresh engine's on those weights bit for bit, prefix hits
    restart, a VTKV1 blob from before it refused); stage then abort; the
    memory ledger against the allocator; the request spans; a 1 s
    ``POST /debug/profile`` during traffic (a second one 409) whose
    trace holds the paged kernel; beam search on ``/generate``; a drain
    with requests in flight."""
    import threading
    from veles_tpu_torch.runtime.deploy import DeployController
    from veles_tpu_torch.runtime.engine import prefix_page_hashes
    from veles_tpu_torch.runtime.generate import generate, generate_beam
    from veles_tpu_torch.runtime.restful import RestfulServer
    from veles_tpu_torch.runtime.snapshotter import (Snapshotter,
                                                     params_to_numpy)
    from veles_tpu_torch.config import root
    wf, ws0 = _bench_state(torch, None, 0)
    _, ws1 = _bench_state(torch, None, 1)
    rng = np.random.default_rng(41)
    load = rng.integers(0, VOCAB, (LIFE_THREADS, LIFE_PROMPT)).astype(
        np.int32)
    probe = rng.integers(0, VOCAB, (SLOTS, LIFE_PROMPT)).astype(np.int32)
    t0 = time.perf_counter()
    snap = Snapshotter("bench_lm", snap_dir, compression=False).save(
        "seed1", {"wstate": {"params": params_to_numpy(ws1["params"])},
                  "workflow_checksum": wf.checksum()})
    snap_s = time.perf_counter() - t0
    # the remote sources: the seed-2 weights as a file snapshot and as the
    # best row of a sqlite database, the seed-0 ones as a file snapshot a
    # local http server serves
    remote = _remote_sources(torch, wf, ws0, snap_dir)
    _reset_counts()
    # the references: fresh engines on the seed-1 weights and booted from
    # the seed-2 file snapshot, built and run before the served one exists
    fresh = _serve_engine(wf, ws1).start()
    try:
        ref1 = fresh.generate(probe, LIFE_NEW, timeout=900)
        fresh_stats = [fresh.stats()]
    finally:
        fresh.stop()
    del fresh
    del ws1
    from veles_tpu_torch.runtime.snapshotter import wstate_from_snapshot
    fresh = _serve_engine(wf, wstate_from_snapshot(remote["seed2_file"], wf,
                                                   device=DEVICE)).start()
    try:
        ref2 = fresh.generate(probe, LIFE_NEW, timeout=900)
        fresh_stats.append(fresh.stats())
    finally:
        fresh.stop()
    del fresh
    eng = _serve_engine(wf, ws0)
    srv = RestfulServer(wf.make_predict_step(), ws0, PREDICT_B,
                        (PREDICT_T,), port=0, workflow=wf, engine=eng,
                        device=DEVICE)
    eng.start()
    srv.start()
    dep = DeployController(server=srv, model_dir=snap_dir)
    port = srv.port
    rec = {"threads": LIFE_THREADS, "prompt": LIFE_PROMPT, "new": LIFE_NEW}
    try:
        ref0 = eng.generate(probe, LIFE_NEW, timeout=900)
        hashes = prefix_page_hashes(probe[0], PAGE)
        code, blob = _http_bytes(port, "/kv/pages?hashes="
                                 + ",".join(h.hex() for h in hashes))
        if code != 200:
            fail(f"GET /kv/pages answered {code}")
        comp0 = eng.stats()["compile"]
        # swap under load
        codes, stop, lock = [], threading.Event(), threading.Lock()
        threads = [threading.Thread(target=_hammer, args=(
            port, load[i:i + 1], LIFE_NEW, stop, codes, lock))
            for i in range(LIFE_THREADS)]
        for t in threads:
            t.start()
        _wait(lambda: len(codes) >= LIFE_THREADS, 300, "load to flow")
        in_engine_before = eng.stats()["in_flight"]
        hits0 = eng.stats()["pages"]["prefix_hit_pages"]
        # the swap's allocation peak over what was allocated before it:
        # the staged tree is its one device copy of the weights
        torch.cuda.synchronize()
        alloc0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        code, swap = _http_json(port, "/admin/reload", {"path": snap})
        reload_wall = time.perf_counter() - t0
        swap_peak = torch.cuda.max_memory_allocated() - alloc0
        if code != 200:
            stop.set()
            fail(f"POST /admin/reload answered {code}: {swap}")
        n_at_swap = len(codes)
        _wait(lambda: len(codes) >= n_at_swap + 2 * LIFE_THREADS, 300,
              "load after the swap")
        stop.set()
        for t in threads:
            t.join(900)
        st = eng.stats()
        # after the load: the probe misses the prefix cache once (its
        # pages were dropped with the old weights), then hits again
        h0 = st["pages"]["prefix_hit_pages"]
        got1 = eng.generate(probe[:1], LIFE_NEW, timeout=900)
        h1 = eng.stats()["pages"]["prefix_hit_pages"]
        got_all = eng.generate(probe, LIFE_NEW, timeout=900)
        h2 = eng.stats()["pages"]["prefix_hit_pages"]
        old_blob_code, old_blob = _http_bytes(port, "/kv/pages", blob,
                                              "PUT")
        rec["swap"] = {
            "requests": len(codes),
            "failed": sum(c != 200 for c in codes),
            "requests_before_swap": n_at_swap,
            "in_engine_before_swap": in_engine_before,
            "in_engine_at_flip": swap.get("in_flight_at_flip"),
            "peak_over_allocated_bytes": swap_peak,
            "serving_params_bytes": eng.stats()["memory"][
                "serving_params"],
            "stage_ms": swap["stage_ms"], "flip_ms": swap["flip_ms"],
            "swap_ms": swap["swap_ms"], "reload_request_ms":
                reload_wall * 1e3, "snapshot_write_s": snap_s,
            "compiles_during_swap": swap["compiles_during_swap"],
            "captures": [comp0["captures"], st["compile"]["captures"]],
            "recompiles": st["compile"]["recompiles"],
            "tokens_equal_fresh_seed1": bool(np.array_equal(got_all, ref1)
                                             and np.array_equal(
                                                 got1, ref1[:1])),
            "tokens_differ_from_seed0": not np.array_equal(got_all, ref0),
            "prefix_hits_probe_first": h1 - h0,
            "prefix_hits_probe_again": h2 - h1,
            "hits_during_load": h0 - hits0,
            "kv_wver": st["kv_transfer"]["wver"],
            "pre_swap_blob_status": old_blob_code,
            "pre_swap_blob_error": old_blob[:160].decode(errors="replace")}
        # stage then abort: the seed-1 weights stay served
        code, staged = _http_json(port, "/admin/stage", {"path": snap})
        abort_code, aborted = _http_json(port, "/admin/abort",
                                         {"token": staged.get("staged")})
        after_abort = eng.generate(probe[:1], LIFE_NEW, timeout=900)
        rec["stage_abort"] = {
            "stage_status": code, "abort_status": abort_code,
            "aborted": aborted.get("aborted"), "swaps": eng.swaps,
            "tokens_unchanged": bool(np.array_equal(after_abort,
                                                    ref1[:1]))}
        # hot swaps from the remote sources under the same load: the
        # seed-2 sqlite row, then the seed-0 manifest over http
        rec["remote_swaps"] = [
            _swap_under_load(eng, port, load, probe, source, ref)
            for source, ref in ((remote["sqlite"], ref2),
                                (remote["http"], ref0))]
        # the memory ledger against the allocator
        code, mem = _http_json(port, "/memory.json")
        rec["memory"] = {k: mem.get(k) for k in (
            "components", "component_total_bytes", "device",
            "unattributed_bytes", "reserved_unallocated_bytes")}
        rec["memory"]["status"] = code
        # the request spans: the ring keeps the newest spans, each
        # request's four adjacent, so the newest TRACE_CHECKED requests
        # keep their children
        code, trace = _http_json(port, "/trace.json")
        events = trace["traceEvents"]
        spans = [e for e in events if e.get("name") == "request"]
        newest = sorted(spans, key=lambda e: e["ts"] + e["dur"])[
            -TRACE_CHECKED:]
        kids = {}
        for e in events:
            if e.get("name") in ("queue_wait", "prefill", "decode"):
                kids.setdefault(e["tid"], set()).add(e["name"])
        rec["trace"] = {"status": code, "request_spans": len(spans),
                        "events": len(events),
                        "newest_checked": len(newest),
                        "newest_with_all_children": sum(
                            kids.get(e["tid"]) == {"queue_wait", "prefill",
                                                   "decode"}
                            for e in newest),
                        "newest_outcomes": sorted(
                            {e["args"]["outcome"] for e in newest})}
        # the on-demand profiler during one short request
        root.common.observe.profile_dir = os.path.join(snap_dir,
                                                       "profiles")
        prof = {}
        pt = threading.Thread(target=lambda: prof.update(zip(
            ("status", "doc"), _http_json(port, "/debug/profile",
                                          {"duration_s": 1.0}))))
        pt.start()
        from veles_tpu_torch.runtime.profiler import profiler
        _wait(lambda: profiler().active, 60, "the profiler capture")
        busy_code, busy = _http_json(port, "/debug/profile",
                                     {"duration_s": 0.1})
        # the capture reports itself active before torch's profiler
        # records (one short request once finished in between), so short
        # requests follow one another until it returns, spaced so that
        # the window holds a few (each adds to the trace's processing)
        deadline = time.monotonic() + PROFILE_CAPTURE_S
        while pt.is_alive():
            if time.monotonic() > deadline:
                _hung(f"the 1 s on-demand profile under traffic did not "
                      f"return within {PROFILE_CAPTURE_S} s")
            try:
                eng.generate(probe[:1, :PROFILE_PROMPT], PROFILE_NEW,
                             timeout=max(1.0, deadline - time.monotonic()))
            except TimeoutError:
                _hung("a short request during the on-demand profile did "
                      f"not finish within {PROFILE_CAPTURE_S} s")
            time.sleep(0.25)
        with open(os.path.join(prof["doc"]["path"], "kernels.json")) as f:
            kernels = json.load(f)
        paged = [k for k in kernels if "paged_decode_kernel" in k["name"]]
        rec["profile"] = {"status": prof["status"],
                          "second_status": busy_code,
                          "second_active": busy.get("active"),
                          "files": prof["doc"]["files"],
                          "duration_s": prof["doc"]["duration_s"],
                          "paged_kernel_calls": sum(k["calls"]
                                                    for k in paged),
                          "top": prof["doc"]["kernels"][:3]}
        # beam search on /generate
        beam_prompts = probe[:2]
        t0 = time.perf_counter()
        code, beam = _http_json(port, "/generate", {
            "prompt": beam_prompts.tolist(), "steps": LIFE_NEW, "beams": 4})
        beam_s = time.perf_counter() - t0
        lib_toks, lib_scores = generate_beam(wf, eng.wstate, beam_prompts,
                                             LIFE_NEW, beams=4)
        code1, beam1 = _http_json(port, "/generate", {
            "prompt": beam_prompts.tolist(), "steps": LIFE_NEW, "beams": 1})
        greedy = generate(wf, eng.wstate, beam_prompts, LIFE_NEW)
        rec["beam"] = {"status": code, "beams": 4, "rows": 2,
                       "wall_s": beam_s,
                       "ms_per_token": beam_s / LIFE_NEW * 1e3,
                       "scores": beam.get("scores"),
                       "equal_generate_beam": bool(np.array_equal(
                           np.asarray(beam.get("tokens")),
                           lib_toks.cpu().numpy())),
                       "beams1_status": code1,
                       "beams1_equal_greedy": bool(np.array_equal(
                           np.asarray(beam1.get("tokens")),
                           greedy.cpu().numpy()))}
        # drain last, with requests in flight
        out, errs = {}, []

        def long_req(i):
            c, b = _http_json(port, "/generate", {
                "prompt": [load[i].tolist()], "steps": DRAIN_NEW})
            out[i] = (c, b)

        drainers = [threading.Thread(target=long_req, args=(i,))
                    for i in range(4)]
        for t in drainers:
            t.start()
        _wait(lambda: eng.stats()["occupancy"] >= 4, 300,
              "the drain's requests to decode")
        drain_code, drain = _http_json(port, "/admin/drain", {})
        ready_code, ready = _http_json(port, "/ready")
        new_code, _ = _http_json(port, "/generate", {
            "prompt": [load[0].tolist()], "steps": 2})
        clean = dep.wait(timeout=300)
        for t in drainers:
            t.join(300)
        rec["drain"] = {
            "status": drain_code, "ready_status": ready_code,
            "ready_reason": ready.get("reason"),
            "new_request_status": new_code, "clean": clean,
            "in_flight": len(drainers),
            "in_flight_ok": sum(c == 200 and len(b["tokens"][0])
                                == LIFE_PROMPT + DRAIN_NEW
                                for c, b in out.values()),
            "engine_running": eng.started}
        final = eng.stats()
    finally:
        srv.stop()
        eng.stop()
        remote["server"].shutdown()
        remote["server"].server_close()
    variants = _paged_variants()
    want = LAYERS * (sum(_micro_steps(st, True) for st in fresh_stats)
                     + _micro_steps(final, True))
    rec["launches"] = variants
    rec["launches_expected"] = {"f32_pool": want}
    rec["compile"] = final["compile"]
    say({"phase": "serving_lifecycle", **rec})
    sw, sa, pr = rec["swap"], rec["stage_abort"], rec["profile"]
    mem = rec["memory"]
    problems = [name for name, ok in (
        ("swap_failed_requests", sw["failed"] == 0),
        ("swap_in_flight", (sw["in_engine_at_flip"] or 0)
         >= LIFE_IN_FLIGHT),
        # one staged copy, not two: a second device tree would double it
        ("swap_one_staged_copy", 0 < sw["peak_over_allocated_bytes"]
         < 1.5 * sw["serving_params_bytes"]),
        ("swap_captures_flat", sw["captures"][0] == sw["captures"][1]
         and sw["recompiles"] == 0 and sw["compiles_during_swap"] == 0),
        ("swap_tokens", sw["tokens_equal_fresh_seed1"]
         and sw["tokens_differ_from_seed0"]),
        ("swap_prefix_restart", sw["prefix_hits_probe_first"] == 0
         and sw["prefix_hits_probe_again"] > 0),
        ("swap_old_blob_refused", sw["pre_swap_blob_status"] == 400
         and "weights-version" in sw["pre_swap_blob_error"]),
        ("stage_abort", sa["stage_status"] == 200
         and sa["abort_status"] == 200 and sa["aborted"]
         and sa["swaps"] == 1 and sa["tokens_unchanged"]),
        ("remote_swaps", all(
            r["status"] == 200 and r["failed"] == 0 and r["requests"] > 0
            and r["captures"][0] == r["captures"][1]
            and r["recompiles"] == 0 and r["compiles_during_swap"] == 0
            and r["tokens_equal_file_boot"]
            for r in rec["remote_swaps"])),
        ("memory", mem["status"] == 200 and mem["device"]
         and mem["components"].get("engine.kv_cache", 0) > 0
         and mem["unattributed_bytes"] is not None),
        ("trace", rec["trace"]["status"] == 200
         and rec["trace"]["newest_checked"] == TRACE_CHECKED
         and rec["trace"]["newest_with_all_children"] == TRACE_CHECKED
         and rec["trace"]["newest_outcomes"] == ["ok"]),
        ("profile", pr["status"] == 200 and pr["second_status"] == 409
         and pr["paged_kernel_calls"] > 0),
        ("beam", rec["beam"]["status"] == 200
         and rec["beam"]["equal_generate_beam"]
         and rec["beam"]["beams1_equal_greedy"]),
        ("drain", rec["drain"]["status"] == 202
         and rec["drain"]["ready_status"] == 503
         and rec["drain"]["new_request_status"] == 503
         and rec["drain"]["clean"]
         and rec["drain"]["in_flight_ok"] == rec["drain"]["in_flight"]
         and not rec["drain"]["engine_running"]),
        ("launches", variants.get("f32_pool", 0) == want > 0
         and not variants.get("bf16_pool")))
        if not ok]
    if problems:
        fail(f"the serving lifecycle failed {problems}: {rec}")
    return variants


# -- the goodput gauges' denominator -------------------------------------------

# -- the recurrent family ------------------------------------------------------

def rec_lm_layers():
    """The GRU+LSTM LM of BASELINE.md:115 (d=64) over the LM64 loader's
    vocabulary: embedding -> gru -> lstm -> seq_last -> softmax."""
    return [{"type": "embedding", "vocab": REC_V, "dim": REC_DIM,
             "name": "emb"},
            {"type": "gru", "hidden": REC_DIM, "name": "gru1"},
            {"type": "lstm", "hidden": REC_DIM, "name": "lstm1"},
            {"type": "seq_last", "name": "last"},
            {"type": "softmax", "output_size": REC_V, "name": "out"}]


def _rec_trainer(torch, capture=True, n_train=REC_TRAIN, n_valid=REC_VALID,
                 epochs=REC_EPOCHS):
    """The GRU+LSTM LM (float32, Adam lr 1e-3) through
    ``StandardWorkflow.make_trainer`` over a card-resident
    ``InductionLoader`` (vocab 32, T 64, minibatch 100; the last position
    supervised), capture on or off."""
    from veles_tpu_torch.models.lm import InductionLoader
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.runtime.decision import Decision
    from veles_tpu_torch.runtime.step_cache import StepCache
    loader = InductionLoader(minibatch_size=REC_B, n_train=n_train,
                             n_valid=n_valid, seq_len=REC_T, vocab=REC_V,
                             device=DEVICE)
    sw = StandardWorkflow({"name": "GRULSTM_LM", "layers": rec_lm_layers(),
                           "optimizer": "adam",
                           "optimizer_args": {"lr": 1e-3}})
    return sw.make_trainer(loader, Decision(max_epochs=epochs),
                           device=DEVICE,
                           step_cache=StepCache(capture=capture))


def _rec_witness(torch):
    """REC_WITNESS_STEPS steps and an eval of the GRU+LSTM LM from one
    init and one batch order through the eager step and the captured
    one: parameters, Adam state and the epoch sums, bit for bit."""
    from veles_tpu_torch.runtime.snapshotter import wstate_to_numpy
    runs, states = {}, {}
    for capture in (False, True):
        run = _counted_run(torch, _rec_trainer(
            torch, capture, REC_WITNESS_STEPS * REC_B, REC_B, 1), 0.0)
        states[capture] = wstate_to_numpy(run["trainer"].wstate)
        runs[capture] = {
            "step_ms_median": float(np.median(run["step_s"])) * 1e3,
            "epoch": run["trainer"].decision.history[0],
            "step_cache": run["step_cache"]}
        del run
    diff = _state_diff(torch, states[False], states[True])
    sums_equal = runs[False]["epoch"] == runs[True]["epoch"]
    captured = runs[True]["step_cache"]["train"]["captured"]
    return {"steps": REC_WITNESS_STEPS,
            "eager_step_ms_median": runs[False]["step_ms_median"],
            "captured_step_ms_median": runs[True]["step_ms_median"],
            "state_leaves_differing": diff, "epoch_sums_equal": sums_equal,
            "captured": captured,
            "ok": captured and not diff and sums_equal}


def _rec_decode(torch, trainer):
    """``generate`` of REC_GEN_ROWS x (REC_GEN_PROMPT + REC_GEN_NEW),
    greedy, from the trained weights: its tokens against the argmax of
    the full forward at every generated position (the recurrence is
    causal, so the lstm's output at position t is the full forward of the
    prefix up to t), and a captured paged engine's tokens against it."""
    from veles_tpu_torch.runtime.engine import DecodeEngine
    from veles_tpu_torch.runtime.generate import generate
    from veles_tpu_torch.units.base import Context
    wf, ws = trainer.workflow, trainer.wstate
    prompt = np.random.default_rng(13).integers(
        0, REC_V, (REC_GEN_ROWS, REC_GEN_PROMPT)).astype(np.int32)
    generate(wf, ws, prompt, 2)                       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(wf, ws, prompt, REC_GEN_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    P = REC_GEN_PROMPT
    with torch.inference_mode():
        outs, _ = wf.forward(ws["params"], ws["state"],
                             {"@input": toks[:, :-1]}, Context(),
                             only=wf.ancestors("lstm1"))
        h = outs["lstm1"]
        head = next(u for u in wf.units if u.name == "out")
        logits, _ = head.apply(ws["params"]["out"], {},
                               [h.reshape(-1, h.shape[-1])], Context())
        pred = logits.float().argmax(-1).view(h.shape[0], h.shape[1])
    forward_mismatch = int((pred[:, P - 1:] != toks[:, P:].long()).sum())
    eng = DecodeEngine(wf, ws, slots=REC_GEN_ROWS, l_max=REC_L_MAX,
                       page_size=PAGE, paged=True, window_ms=2.0,
                       device=DEVICE).start()
    try:
        etoks, metrics = _timed_generate(eng, prompt, REC_GEN_NEW)
        st = eng.stats()
    finally:
        eng.stop()
    return {"rows": REC_GEN_ROWS, "prompt": P, "new": REC_GEN_NEW,
            "generate_s": gen_s,
            "generate_tokens_per_s": REC_GEN_ROWS * REC_GEN_NEW / gen_s,
            "full_forward_mismatches": forward_mismatch,
            "engine_tokens_equal": bool(np.array_equal(
                etoks, toks.cpu().numpy())),
            "engine": metrics,
            "engine_captured": {k: st["capture"][k]["captured"]
                                for k in ("decode_greedy", "prefill")},
            "ok": (forward_mismatch == 0
                   and np.array_equal(etoks, toks.cpu().numpy())
                   and st["capture"]["decode_greedy"]["captured"]
                   and st["capture"]["prefill"]["captured"])}


def phase_recurrent_train(torch):
    """The GRU+LSTM LM trained REC_EPOCHS captured epochs (and their
    evals) with the launch counts set to 0 before: every loss finite,
    the epoch train loss falling, train and eval captured, one batch
    gather a batch; then 8 captured steps bitwise 8 eager ones, and
    greedy decode (``generate`` and the engine) from the trained
    weights.  Returns the gather's launches and its timing at the
    loader's shape."""
    from veles_tpu_torch.ops.kernels import gather_rows as gr
    torch.backends.cuda.matmul.allow_tf32 = False
    run = _counted_run(torch, _rec_trainer(torch), 0.0)
    trainer = run["trainer"]
    hist = trainer.decision.history
    epoch_loss = [h["train"]["loss"] for h in hist]
    step_s = run["step_s"]
    med = float(np.median(step_s))
    batches = REC_EPOCHS * (REC_TRAIN // REC_B + REC_VALID // REC_B)
    st = run["step_cache"]
    rec = {"phase": "recurrent_train",
           "layers": [layer["type"] for layer in rec_lm_layers()],
           "dim": REC_DIM, "vocab": REC_V, "seq_len": REC_T,
           "minibatch": REC_B, "n_train": REC_TRAIN, "dtype": "float32",
           "epochs": len(hist), "steps": len(step_s),
           "step_ms_median": med * 1e3, "step_ms_max": max(step_s) * 1e3,
           "train_tokens_per_s": REC_B * REC_T / med,
           "epoch_train_loss": epoch_loss,
           "valid_error_pct": [h["valid"]["error_pct"] for h in hist],
           "run_s": run["wall"], "launches": run["launches"],
           "variants": run["variants"], "step_cache": st}
    rec["ok"] = (len(step_s) == REC_EPOCHS * (REC_TRAIN // REC_B)
                 and all(np.isfinite(run["losses"]))
                 and epoch_loss[-1] < epoch_loss[0]
                 and st["train"]["captured"] and st["eval"]["captured"]
                 and run["variants"].get(gr.NAME) == {"batch": batches})
    say(rec)
    if not rec["ok"]:
        fail(f"the GRU+LSTM LM's epochs: {rec}")
    timing = _family_gather_timing(torch, trainer.loader, "recurrent_train")
    witness = _rec_witness(torch)
    say({"phase": "recurrent_capture_witness", **witness})
    if not witness["ok"]:
        fail(f"GRU+LSTM LM: captured and eager steps differ: {witness}")
    dec = _rec_decode(torch, trainer)
    say({"phase": "recurrent_decode", **dec})
    if not dec["ok"]:
        fail(f"GRU+LSTM LM decode: {dec}")
    launches = run["launches"][gr.NAME]
    del trainer, run
    torch.cuda.empty_cache()
    return {"launches": launches, "timing": timing}


def rec_serve_layers():
    """tests/test_generate.py:149-156's mixed chain at bench_lm.py's
    width: the bench LM's 4 attention blocks, then gru 512, seq_last and
    a softmax head."""
    return bench_layers()[:-1] + [
        {"type": "gru", "hidden": E, "name": "gru"},
        {"type": "seq_last", "name": "last"},
        {"type": "softmax", "output_size": VOCAB, "name": "out"}]


def _rec_serve_state(torch, compute_dtype, flat=None):
    """The mixed chain's workflow and a state of numpy-seed weights in
    the JAX layout (seed 31, or ``flat``) on the card."""
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.runtime.snapshotter import params_from_jax
    from veles_tpu_torch.units.base import Spec
    from veles_tpu_torch.units.workflow import new_state
    wf = StandardWorkflow({"name": "mixed_rnn_attention",
                           "layers": rec_serve_layers(),
                           "compute_dtype": compute_dtype,
                           "optimizer": "adam",
                           "optimizer_args": {"lr": 1e-3}}).workflow
    wf.build({"@input": Spec((2, 16), torch.int32),
              "@labels": Spec((2,), torch.int32),
              "@mask": Spec((2,), torch.float32)})
    flat = jax_layout_weights(wf, seed=31) if flat is None else flat
    return wf, new_state(params_from_jax(flat, wf, device=DEVICE), {}, {}, 0,
                         None), flat


def _rec_serve(torch, eng, prompts, new):
    """``prompts`` submitted together to a started engine: the tokens,
    decode tokens/s, step p50 and TTFT mean and max."""
    s0 = eng.stats()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, new) for p in prompts]
    for r in reqs:
        if not r.done.wait(900) or r.error is not None:
            fail(f"a mixed-chain request failed: {r.error}")
    wall = time.perf_counter() - t0
    m = _engine_metrics(eng, s0, eng.stats(), wall)
    ttft = [r.first_token_at - r.submitted_at for r in reqs]
    m.update(ttft_s_mean=float(np.mean(ttft)), ttft_s_max=float(max(ttft)))
    return np.stack([r.result for r in reqs]), m


def _rec_preempt(torch, wf, ws, prompts, ref):
    """A float32 engine of one class-1 request and SLOTS - 1 class-0
    ones, driven on this thread: after REC_PREEMPT_AFTER decode steps a
    class-0 arrival finds no free slot and preempts the class-1 request,
    which resumes by re-prefilling from token 0.  Its tokens against
    ``ref`` (its run without the arrival)."""
    import threading
    eng = _serve_engine(wf, ws, prefill_chunk=0, priorities=2, preempt=True)
    eng._thread = threading.current_thread()    # submit() wants one
    try:
        victim = eng.submit(prompts[0], NEW, priority=1)
        others = [eng.submit(p, NEW, priority=0) for p in prompts[1:]]
        eng._admit()
        for _ in range(REC_PREEMPT_AFTER):
            eng._step_once()
        high = eng.submit(prompts[1][:PROFILE_PROMPT], PROFILE_NEW,
                          priority=0)
        eng._admit()
        reqs = [victim, high] + others
        for _ in range(4 * (PROMPT + NEW)):
            if all(r.done.is_set() for r in reqs):
                break
            eng._admit()
            eng._advance_prefills()
            if eng._active.any():
                eng._step_once()
    finally:
        eng._thread = None
    if not all(r.done.is_set() and r.error is None for r in reqs):
        fail("a request of the mixed chain's preemption run did not finish")
    return {"preemptions": victim.preemptions,
            "tokens_equal_uninterrupted": bool(np.array_equal(
                victim.result, ref)),
            "ok": victim.preemptions >= 1 and bool(np.array_equal(
                victim.result, ref))}


def phase_recurrent_serving(torch):
    """The mixed attention + GRU chain at bench_lm.py's width, bf16
    compute, served by captured paged engines (SLOTS slots, l_max L_MAX,
    page PAGE, paged kernel on) with the launch counts set to 0 at the
    start: the greedy SLOTS x (PROMPT + NEW) request (whole prefill) on
    a captured engine, an eager one (on the prompts cut to
    REC_EAGER_PROMPT, against the captured engine's tokens on them), a
    megastep (N=MEGASTEP_N) one, a speculative (k=SPEC_K) one driven
    with a verify dispatch every iteration, and a chunked-prefill
    (REC_SERVE_CHUNK) one, all bitwise the first; a shared-prefix pair takes no prefix hit and ``GET
    /kv/pages`` answers 400; profiled decode, megastep and verify windows
    hold the paged launches of each replay against the trace (LAYERS a
    decode micro-step); in float32 the engine's tokens equal
    ``generate()``'s and a preempted request equals its uninterrupted
    run; in bf16 the share of tokens equal to ``generate()``'s is
    reported.  Returns the paged kernel's launches over the phase."""
    from veles_tpu_torch.ops.kernels import paged_attention as pa
    from veles_tpu_torch.runtime.generate import generate
    from veles_tpu_torch.runtime.restful import RestfulServer
    _reset_counts()
    wf, ws, flat = _rec_serve_state(torch, "bfloat16")
    rng = np.random.default_rng(41)
    prompts = rng.integers(0, VOCAB, (SLOTS, PROMPT)).astype(np.int32)
    window = np.random.default_rng(12).integers(
        0, VOCAB, (SLOTS, PROFILE_PROMPT)).astype(np.int32)
    eng = _serve_engine(wf, ws, prefill_chunk=0)
    prof_decode = _decode_window(torch, eng, window,
                                 lambda e, i: e._step_once())
    eng.start()
    srv = RestfulServer(wf.make_predict_step(), ws, 2, (16,), port=0,
                        workflow=wf, engine=eng, device=DEVICE).start()
    try:
        toks, metrics = _rec_serve(torch, eng, prompts, NEW)
        short = prompts[:, :REC_EAGER_PROMPT]
        toks_short, _ = _rec_serve(torch, eng, short, NEW)
        sysp = rng.integers(0, VOCAB, SHARED_PREFIX)
        for _ in range(2):
            eng.generate(np.concatenate([sysp, rng.integers(
                0, VOCAB, 16)]).astype(np.int32)[None], 8, timeout=900)
        kv_code, kv_body = _http_bytes(srv.port, "/kv/pages?top=4")
        st = eng.stats()
    finally:
        srv.stop()
        eng.stop()
    runs = {}
    for name, kw in (("eager", {"capture": False}),
                     ("chunked", {"prefill_chunk": REC_SERVE_CHUNK})):
        e = _serve_engine(wf, ws, **({"prefill_chunk": 0} | kw)).start()
        try:
            runs[name] = _rec_serve(torch, e, short if name == "eager"
                                    else prompts, NEW)
            runs[name] += (e.stats(),)
        finally:
            e.stop()
    mega = _serve_engine(wf, ws, prefill_chunk=0, megastep=MEGASTEP_N)
    prof_mega = _decode_window(torch, mega, window,
                               lambda e, i: e._advance_once())
    mega.start()
    try:
        runs["megastep"] = _rec_serve(torch, mega, prompts, NEW) + (
            mega.stats(),)
    finally:
        mega.stop()

    def verify_first(e, i):
        if i == 0:
            _verify_always(e, i)
        else:
            e._step_once()

    spec = _serve_engine(wf, ws, prefill_chunk=0, spec=True, spec_k=SPEC_K)
    prof_verify = _decode_window(torch, spec, window, verify_first)
    stoks, s0, s1, swall = _driven_run(torch, spec, prompts, NEW,
                                       [{}] * SLOTS, _verify_always)
    verify_steps = s1["spec"]["verify_steps"] - s0["spec"]["verify_steps"]
    gen_bf16 = generate(wf, ws, prompts, NEW).cpu().numpy()
    # float32: the engine against generate(), and the preemption
    wf32, ws32, _ = _rec_serve_state(torch, None, flat)
    e32 = _serve_engine(wf32, ws32, prefill_chunk=0).start()
    try:
        toks32, _ = _rec_serve(torch, e32, prompts, NEW)
    finally:
        e32.stop()
    gen32 = generate(wf32, ws32, prompts, NEW).cpu().numpy()
    preempt = _rec_preempt(torch, wf32, ws32, prompts, toks32[0])
    torch.cuda.synchronize()
    paged_launches = pa.launches.count
    traces = {"decode": (prof_decode, LAYERS),
              "megastep": (prof_mega, LAYERS * MEGASTEP_N),
              "verify": (prof_verify, LAYERS * (SPEC_K + 1))}
    per_replay = {k: p["launch_trace"]["per_replay_by_kind"].get(k, {})
                  .get(PAGED_F32) for k, (p, _) in traces.items()}
    traces_ok = all(p["launch_trace"]["ok"] and p["launch_trace"]["captured"]
                    and per_replay[k] == n for k, (p, n) in traces.items())
    rec = {"phase": "recurrent_serving", "layers": len(rec_serve_layers()),
           "vocab": VOCAB, "dim": E, "attention_blocks": LAYERS,
           "heads": HEADS, "gru": E, "compute": "bfloat16",
           "slots": SLOTS, "l_max": L_MAX, "page": PAGE, "prompt": PROMPT,
           "new": NEW, **metrics,
           "eager": runs["eager"][1], "chunked": runs["chunked"][1],
           "megastep": runs["megastep"][1],
           "tokens_equal": {
               "eager": bool(np.array_equal(runs["eager"][0],
                                            toks_short)),
               "megastep": bool(np.array_equal(runs["megastep"][0], toks)),
               "spec": bool(np.array_equal(stoks, toks)),
               "chunked": bool(np.array_equal(runs["chunked"][0], toks))},
           "mega_dispatches":
               runs["megastep"][2]["megastep"]["mega_dispatches"],
           "verify_steps": verify_steps, "spec_wall_s": swall,
           "chunked_prefill_calls": runs["chunked"][2]["prefill_calls"],
           "prefix_hit_pages": st["pages"]["prefix_hit_pages"],
           "kv_pages_status": kv_code,
           "kv_pages_body": kv_body[:200].decode(errors="replace"),
           "generate_equal_share_bf16": float((toks == gen_bf16).mean()),
           "first_diff_row0_bf16": _first_diff(toks[0], gen_bf16[0]),
           "generate_equal_f32": bool(np.array_equal(toks32, gen32)),
           "preempt_f32": preempt,
           "paged_per_replay": per_replay,
           "idle_share": {k: p["device_idle_share"]
                          for k, (p, _) in traces.items()},
           "paged_launches": paged_launches,
           "captures": {k: v["captured"] for k, v in st["capture"].items()}}
    rec["ok"] = (all(rec["tokens_equal"].values())
                 and rec["mega_dispatches"] > 0 and verify_steps > 0
                 and rec["chunked_prefill_calls"] >= SLOTS * PROMPT
                 // REC_SERVE_CHUNK
                 and rec["prefix_hit_pages"] == 0 and kv_code == 400
                 and rec["generate_equal_f32"] and preempt["ok"]
                 and traces_ok and all(rec["captures"].values())
                 and st["compile"]["recompiles"] == 0
                 and paged_launches > 0)
    say(rec)
    if not rec["ok"]:
        fail(f"the mixed attention + GRU chain's serving checks failed: "
             f"{rec}")
    del wf, ws, wf32, ws32
    torch.cuda.empty_cache()
    return {"paged_attention_decode": paged_launches}


# -- the host image path -------------------------------------------------------

def _host_profile(torch, trainer):
    """Device busy time over 3 captured AlexNet steps fed as the epoch
    feeds them: the host crop and the pinning on the trainer's prefetch
    thread (``Trainer._batches``), so the idle share counts the card's
    waits on the host; a fourth step first as the profiler's warm-up;
    the launch counters held against the trace."""
    from veles_tpu_torch.loader.base import TRAIN
    step = trainer._train_step
    it = trainer._batches(TRAIN, 0, step)

    def run(batch):
        trainer.wstate, _ = step(trainer.wstate, batch)

    try:
        with _profiled(torch, lambda: run(next(it)), cpu=True) as win:
            t0 = time.perf_counter()
            for _, b in zip(range(3), it):
                run(b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        it.close()
    rec = _busy(win["prof"], wall, f"3 AlexNet host-path steps, {IMG_B} "
                                   "images each, fed through the prefetch",
                steps=3)
    rec["launch_trace"] = _launch_trace_check(win, [(step, 3)])
    return rec


def phase_image_host(torch, device_rec):
    """``alexnet_e2e_workflow``: AlexNet (bf16) fed uint8 batches that
    ``ImagenetHostLoader`` crops and mirrors on the host (4096 + 512
    images, minibatch 512), normalized on the card by the ``norm0``
    unit's mean/disp kernel, one captured epoch and its eval with the
    trainer's prefetch (2) overlapping the host crop with the step, the
    launch counts set to 0 before; the host crop's ms a batch; a
    profiled window (idle share); IMG_WITNESS_STEPS captured steps
    bitwise eager ones (cuDNN deterministic); samples/s beside the
    card-resident variant's (``device_rec``, the image phase's)."""
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.models.alexnet import alexnet_e2e_workflow
    from veles_tpu_torch.ops.kernels import mean_disp
    from veles_tpu_torch.runtime.decision import Decision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_data = time.perf_counter()
    sw = alexnet_e2e_workflow(minibatch_size=IMG_B, n_train=IMG_TRAIN,
                              n_valid=IMG_VALID)
    sw.loader.initialize()
    t_data = time.perf_counter() - t_data
    crop_s, it = [], sw.loader.iter_epoch(TRAIN, 0)
    for _ in range(4):
        t0 = time.perf_counter()
        next(it)
        crop_s.append(time.perf_counter() - t0)
    it.close()
    trainer = sw.make_trainer(sw.loader, Decision(max_epochs=1),
                              device=DEVICE)
    run = _counted_run(torch, trainer, t_data)
    step_s, losses, launches = run["step_s"], run["losses"], run["launches"]
    med = float(np.median(step_s))
    st = run["step_cache"]
    steps = len(step_s)
    profile = _host_profile(torch, trainer)
    rec = {"phase": "image_host", "steps": steps, "prefetch":
           trainer.prefetch, "store_s": t_data,
           "host_crop_ms_per_batch": float(np.median(crop_s)) * 1e3,
           "step_ms_median": med * 1e3, "run_s": run["wall"],
           "train_samples_per_s": IMG_B / med,
           "epoch_samples_per_s": steps * IMG_B / run["wall"],
           "device_variant_samples_per_s": device_rec["train_samples_per_s"],
           "device_variant_epoch_samples_per_s":
               device_rec["epoch_samples_per_s"],
           "idle_share": profile["device_idle_share"],
           "losses": losses, "launches": launches, "step_cache": st,
           "profile": profile}
    say(rec)
    if (steps != IMG_TRAIN // IMG_B or not all(np.isfinite(losses))
            or not (st["train"]["captured"] and st["eval"]["captured"])
            or launches[mean_disp.NAME] < IMG_MIN_LAUNCHES[mean_disp.NAME]
            or not profile["launch_trace"]["ok"]):
        fail(f"the host image path: {rec}")
    del trainer, run, sw
    torch.cuda.empty_cache()
    witness = _image_capture_witness(torch, host=True)
    say({"phase": "image_host_capture_witness", **witness})
    if not witness["ok"]:
        fail(f"AlexNet host path: captured and eager steps differ: "
             f"{witness}")
    return {"launches": launches[mean_disp.NAME]}


def phase_device_benchmark(torch):
    """``runtime.benchmark.benchmark_device()`` once on the card (GEMM
    chains of 1024-4096 in float32 and bfloat16, CUDA events), its DB
    persisted under ``root.common.cache_dir`` so every trainer of the run
    (the CLI subprocesses too) reads the peak its MFU divides by."""
    from veles_tpu_torch.runtime.benchmark import (benchmark_device,
                                                   resolve_peak_tflops)
    info = benchmark_device(refresh=True)
    peak = resolve_peak_tflops()
    say({"phase": "device_benchmark", **info, "peak_tflops": peak})
    if not peak > 0:
        fail(f"the GEMM calibration measured no rate: {info}")
    return peak


# -- the curriculum path -------------------------------------------------------

def _lm64_trainer(torch, n_train=CUR_TRAIN, n_valid=CUR_VALID, epochs=1):
    """configs/induction_lm64.json's workflow and loader at the
    curriculum's sizes, through ``StandardWorkflow.make_trainer``."""
    from veles_tpu_torch.__main__ import make_loader
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.runtime.decision import Decision
    cfg = _config(CURRICULUM_CONFIG)
    loader_cfg = dict(cfg["loader"])
    name = loader_cfg.pop("name")
    loader_cfg.update(n_train=n_train, n_valid=n_valid)
    loader = make_loader(name, device=DEVICE, **loader_cfg)
    sw = StandardWorkflow(cfg["workflow"])
    return sw.make_trainer(loader, Decision(max_epochs=epochs),
                           device=DEVICE)


def _f32_flash_timing(torch, B, T, H, D, path, what):
    """The f32 flash kernels (the 3xTF32 forward, dQ and dK/dV) at a
    path's shape (B, T, H, D, causal) against their plain versions
    (forward FLASH_TOL, its error against float64 reported beside;
    backward :func:`bwd_within`; each twice bit for bit; fails the run
    otherwise), each timed beside its plain version, SDPA in float32 and
    the bound of its ``cost()`` at the f32 tensor-core rate: the
    ``kernels`` line's entries ``<name>/<path>``."""
    import torch.nn.functional as F
    from veles_tpu_torch.ops.kernels import flash_attention as fa
    from veles_tpu_torch.ops.kernels import flash_bwd_dkv as dkv
    from veles_tpu_torch.ops.kernels import flash_bwd_dq as dq
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(11)
    f32 = torch.float32
    (q, k, v), ferr, lerr, finite, ran, f64 = _flash_case(
        torch, gen, B, T, T, H, H, D, f32, True, None)
    # the forward twice: no float atomics, the same bits
    repeat_fwd = all(torch.equal(a, b) for a, b in zip(
        fa.flash_attention(q, k, v, True), fa.flash_attention(q, k, v, True)))
    args, kw, res = _bwd_case(torch, gen, B, T, T, H, H, D, f32, True, None)
    first = (dq.flash_bwd_dq(*args, **kw),) + dkv.flash_bwd_dkv(*args, **kw)
    second = (dq.flash_bwd_dq(*args, **kw),) + dkv.flash_bwd_dkv(*args, **kw)
    repeat = [bool(torch.equal(a, b)) for a, b in zip(first, second)]
    del first, second
    ok = (ferr <= FLASH_TOL["float32"] and lerr <= LSE_TOL and finite
          and ran == expected_variant(f32)
          and all(res["variant"][m.NAME] == expected_variant(f32)
                  for m in (dq, dkv))
          and all(repeat) and repeat_fwd
          and all(bwd_within(res[g]) and res[g]["finite"]
                  for g in ("dq", "dk", "dv")))
    check = {"phase": path + "_kernels_check", "max_abs_err": ferr,
             "tol": FLASH_TOL["float32"], "lse_err": lerr, **f64,
             "forward_two_runs_bitwise": repeat_fwd,
             "backward": res, "backward_two_runs_bitwise": repeat, "ok": ok}
    say(check)
    if not ok:
        fail(f"f32 flash kernels disagree with their plain versions at "
             f"{what} shape: {check}")
    qa, ka, va, do, lse, delta = args
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (qa, ka, va))
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    bwd_lib = cuda_ms(torch, lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
    shape = {"B": B, "T": T, "H": H, "D": D, "dtype": "float32",
             "causal": True}
    # the plain versions at full width: a few calls are enough
    plain_iters = 20 if B * T * H * D <= 1 << 20 else 3
    timing = {}
    for mod, fn, plain, lib, err in (
            (fa, lambda: fa.flash_attention(q, k, v, True),
             lambda: fa.flash_attention_plain(q, k, v, causal=True),
             lambda: F.scaled_dot_product_attention(
                 *(x.transpose(1, 2) for x in (q, k, v)), is_causal=True),
             ferr),
            (dq, lambda: dq.flash_bwd_dq(*args, **kw),
             lambda: dq.flash_bwd_dq_plain(*args, **kw), None,
             res["dq"]["max_abs_err"]),
            (dkv, lambda: dkv.flash_bwd_dkv(*args, **kw),
             lambda: dkv.flash_bwd_dkv_plain(*args, **kw), None,
             max(res["dk"]["max_abs_err"], res["dv"]["max_abs_err"]))):
        ms = cuda_ms(torch, fn, iters=100)
        c = mod.cost(q, k, v, True)
        b_ms, b_by = cost_bound(c, H100_F32_TC_FLOPS)
        timing[f"{mod.NAME}/{path}"] = {
            "max_abs_err": err, **(f64 if mod is fa else {}), "ms": ms,
            "plain_ms": cuda_ms(torch, plain, iters=plain_iters),
            "library_ms": cuda_ms(torch, lib, iters=100) if lib
            else bwd_lib,
            "bound_ms": b_ms, "bound_by": b_by, "variant": F32_VARIANT,
            "source": mod.SOURCES[F32_VARIANT], "path": path,
            "tflops": c["flops"] / ms / 1e9, "bound_share": b_ms / ms,
            "shape": shape}
    return timing


def phase_curriculum_kernels(torch):
    """The curriculum's kernels: one epoch of its LM64 trainer (captured)
    with the counts set to 0 before it, each f32 flash kernel at its
    shape (B=100, T=64, H=4, D=16, causal) against its plain version
    (forward 1e-4, backward BWD_UNITS) and timed beside the plain version,
    SDPA in float32 and the bound of its ``cost()``; the batch gather at
    the path's shape."""
    from veles_tpu_torch.ops.kernels import KERNELS
    from veles_tpu_torch.ops.kernels import flash_attention as fa
    from veles_tpu_torch.ops.kernels import flash_bwd_dkv as dkv
    from veles_tpu_torch.ops.kernels import flash_bwd_dq as dq
    from veles_tpu_torch.ops.kernels import gather_rows as gr
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = _lm64_trainer(torch)
    for kern in KERNELS:
        kern.launches.reset()
    trainer.initialize(seed=0)
    results = trainer.run()
    launches = {k.NAME: k.launches.count for k in KERNELS}
    variants = {k.NAME: k.launches.by_variant() for k in KERNELS
                if k.launches.by_variant()}
    st = trainer.step_cache.stats()
    batches = CUR_TRAIN // CUR_B + CUR_VALID // CUR_B
    run = {"phase": "curriculum_path_epoch", "results": results,
           "launches": launches, "variants": variants, "step_cache": st}
    say(run)
    flash = (fa, dq, dkv)
    problems = [k.NAME for k in flash
                if not launches[k.NAME]
                or variants.get(k.NAME) != {F32_VARIANT: launches[k.NAME]}]
    if problems or variants.get(gr.NAME) != {"batch": batches} \
            or not (st["train"]["captured"] and st["eval"]["captured"]):
        fail(f"the curriculum's epoch did not run its f32 kernels, one "
             f"batch gather a batch and captured steps: {run}")
    timing = _f32_flash_timing(torch, CUR_B, CUR_T, CUR_H, CUR_D,
                               "induction_lm64", "the curriculum's")
    timing[gr.NAME + "/induction_lm64"] = _family_gather_timing(
        torch, trainer.loader, "induction_lm64")
    say({"phase": "curriculum_kernel_timing",
         "library_note": "library_ms of both flash backward kernels is one "
                         "SDPA backward (dQ, dK and dV together), float32",
         **timing})
    counts = {name + "/induction_lm64": launches[name]
              for name in (fa.NAME, dq.NAME, dkv.NAME, gr.NAME)}
    del trainer
    torch.cuda.empty_cache()
    return {"timing": timing, "launches": counts}


def curriculum_two_phases():
    """The published spec cut to its first two phases: the same
    ``common``, ``bar`` and phase 1, and phase 2 once (``"repeat": 1``),
    budgets 170 and 320 epochs.  Two phases still exercise the chain (the
    second CLI process restores the first one's best snapshot); the whole
    chain (~3,190 epochs) would push the script past its time limit."""
    spec = _config(CURRICULUM_SPEC)
    first, second = spec["phases"][:2]
    return dict(spec, phases=[first, dict(second, repeat=1)])


def phase_curriculum(torch, out_dir):
    """``python -m veles_tpu_torch configs/induction_lm64.json
    --curriculum SPEC`` on the card, SPEC the published
    configs/induction_lm64_curriculum.json cut to two phases
    (:func:`curriculum_two_phases`, written into ``out_dir``): each
    phase's best value, best epoch, epochs, wall and median train-phase
    step.  Fails when a phase fails (the CLI exits non-zero), when the
    summary is not whole (a finite best value, every phase run to its
    budget, the best snapshot on disk, phase 2 started from phase 1's
    best snapshot) or when a phase's median step is not finite.  The bar
    is reported (``bar_met``), not required: the JAX package's own CLI
    stalls near chance on the published spec and seed too (PERF.md §6;
    ROADMAP.md's reference caveat), so the bar measures the recipe, not
    the port."""
    here = os.path.dirname(os.path.abspath(__file__))
    res_path = os.path.join(out_dir, "summary.json")
    spec = curriculum_two_phases()
    spec_path = os.path.join(out_dir, "curriculum_two_phases.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f, indent=1)
    # a storage setting, not the spec: each phase snapshots every epoch,
    # and the newest 2 are kept
    cmd = [sys.executable, "-m", "veles_tpu_torch", CURRICULUM_CONFIG,
           "root.common.snapshot_keep=2",
           "--curriculum", spec_path, "--curriculum-out", out_dir,
           "--result-file", res_path, "--device", DEVICE]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                           timeout=CURRICULUM_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"the curriculum exceeded {CURRICULUM_TIMEOUT} s")
    took = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"the curriculum exited {r.returncode}: {r.stderr[-3000:]}")
    with open(res_path) as f:
        summary = json.load(f)
    for ph in summary["phases"]:
        say({"phase": "curriculum_phase", **ph,
             "step_ms_median": (ph.get("train_step_s_median") or 0) * 1e3})
    rec = {"phase": "curriculum", "config": CURRICULUM_CONFIG,
           "spec": CURRICULUM_SPEC, "phases": "the first two, phase 2 once",
           "best_value": summary["value"],
           "best_phase": summary["best_phase"],
           "phases_run": summary["phases_run"], "wall_s": took,
           "bar": CURRICULUM_BAR,
           "trajectory": [ph.get("best_value") for ph in summary["phases"]],
           "jax_trajectory": JAX_TRAJECTORY,
           "phase_wall_s": [ph["wall_s"] for ph in summary["phases"]],
           "phase_train_s": [ph.get("elapsed_s")
                             for ph in summary["phases"]]}
    best = summary["value"]
    rec["bar_met"] = best is not None and best <= CURRICULUM_BAR
    say(rec)
    budgets = [int(o.split("=")[1]) for o in _curriculum_budgets(spec)]
    phases = summary["phases"]
    p1_dir = os.path.join(out_dir, "p1")
    # phase 2 ran from phase 1's best snapshot (when the bar did not stop
    # the chain after phase 1)
    chained = len(phases) < 2 or (
        (phases[1].get("restored_from") or "").startswith(p1_dir)
        and phases[1]["restored_from"].endswith("_best.json"))
    rec["phase2_restored_from"] = (phases[1].get("restored_from")
                                   if len(phases) > 1 else None)
    whole = (best is not None and np.isfinite(best) and chained
             and summary["phases_run"] >= 1
             and [ph["epochs"] for ph in summary["phases"]]
             == budgets[:summary["phases_run"]]
             and (rec["bar_met"] or summary["phases_run"] == len(budgets))
             and summary["best_snapshot"]
             and os.path.exists(summary["best_snapshot"])
             and all(np.isfinite(ph.get("train_step_s_median") or np.nan)
                     for ph in summary["phases"]))
    if not whole:
        fail(f"the curriculum's summary is not whole: {summary}")
    return summary["best_snapshot"]


def _curriculum_budgets(spec):
    """Each phase's ``workflow.max_epochs=`` override in ``spec``."""
    from veles_tpu_torch.runtime.curriculum import expand_phases
    return [o for ph in expand_phases(spec)
            for o in ph["overrides"] if o.startswith("workflow.max_epochs=")]


def _seeded_lm64_snapshot(torch, out_dir):
    """A snapshot of the LM64 trainer at its seed-0 initial weights (the
    trainer's payload, which the CLI's restore reads)."""
    from veles_tpu_torch.runtime.snapshotter import Snapshotter
    trainer = _lm64_trainer(torch, n_train=CUR_B, n_valid=CUR_B)
    trainer.initialize(seed=0)
    return Snapshotter("InductionLM64", out_dir).save(
        "seed0", trainer._payload(), best=True)


def phase_generate_cli(torch, snapshot, out_dir):
    """``--generate 64`` over 8 prompts of 64 ids through the CLI on the
    card, greedy and ``--beams 4``, token for token an in-process
    ``generate()`` / ``generate_beam()`` on the same snapshot; the CLI's
    wall and the in-process decode's tokens/s."""
    from veles_tpu_torch.runtime.generate import generate, generate_beam
    here = os.path.dirname(os.path.abspath(__file__))
    seeded = snapshot is None
    if seeded:
        snapshot = _seeded_lm64_snapshot(torch, out_dir)
    vocab = _config(CURRICULUM_CONFIG)["loader"]["vocab"]
    prompt = np.random.default_rng(13).integers(
        0, vocab, (GEN_ROWS, GEN_PROMPT)).astype(np.int32)
    prompt_file = os.path.join(out_dir, "prompt.npy")
    np.save(prompt_file, prompt)
    cli = {}
    for mode, extra in (("greedy", []), ("beams", ["--beams",
                                                  str(GEN_BEAMS)])):
        res_path = os.path.join(out_dir, f"generate_{mode}.json")
        cmd = [sys.executable, "-m", "veles_tpu_torch", CURRICULUM_CONFIG,
               "--snapshot", snapshot, "--generate", str(GEN_NEW),
               "--prompt", "@" + prompt_file, "--result-file", res_path,
               "--device", DEVICE, *extra]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                           timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"the {mode} --generate CLI exited {r.returncode}: "
                 f"{r.stderr[-2000:]}")
        with open(res_path) as f:
            cli[mode] = {"out": json.load(f), "wall_s": wall}
    trainer = _lm64_trainer(torch, n_train=CUR_B, n_valid=CUR_B)
    trainer.initialize(seed=0)
    trainer.restore(snapshot)
    wf, ws = trainer.workflow, trainer.wstate
    generate(wf, ws, prompt, 2)                       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(wf, ws, prompt, GEN_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    btoks, bscores = generate_beam(wf, ws, prompt, GEN_NEW, beams=GEN_BEAMS)
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    greedy_eq = cli["greedy"]["out"]["tokens"] == toks.cpu().tolist()
    beam_eq = cli["beams"]["out"]["tokens"] == btoks.cpu().tolist()
    score_err = float(np.abs(np.asarray(cli["beams"]["out"]["scores"])
                             - bscores.cpu().numpy()).max())
    rec = {"phase": "generate_cli", "snapshot": "curriculum best"
           if not seeded else "seed-0 init", "rows": GEN_ROWS,
           "prompt": GEN_PROMPT, "new": GEN_NEW, "beams": GEN_BEAMS,
           "cli_wall_s": {m: c["wall_s"] for m, c in cli.items()},
           "generate_s": gen_s,
           "generate_tokens_per_s": GEN_ROWS * GEN_NEW / gen_s,
           "beam_s": beam_s, "beam_ms_per_token": beam_s / GEN_NEW * 1e3,
           "greedy_equal": greedy_eq, "beams_equal": beam_eq,
           "beam_score_max_abs_diff": score_err,
           "ok": greedy_eq and beam_eq}
    say(rec)
    if not rec["ok"]:
        fail(f"the CLI's --generate tokens differ from the in-process "
             f"decode: {rec}")
    return rec


# -- the pipeline stack, its process group and the MoE chain --------------------

#: the four pipelined configs, trained with no mesh (the stack runs its
#: stages sequentially: on one card the run has one rank)
PP_CONFIGS = ("induction_lm_pp", "induction_lm_pp_moe", "induction_lm_pp_sp",
              "induction_lm_pp_sp_interleaved")
#: the sequence family's bar (BASELINE.md:139, :141 for the MoE config);
#: the _sp configs' published bars were measured on a seq=2 mesh
PP_BARS = {"induction_lm_pp": 5.0, "induction_lm_pp_moe": 5.0}
PP_TIMEOUT = 600
PP_PATH = "induction_lm_pp_moe"  # the kernels line's entries of this path
PP_BATCHES = 8                  # batches of the in-process counted epoch
DIST_STEPS = 4                  # one-rank NCCL steps held bitwise
MOE_ROWS, MOE_PROMPT, MOE_NEW, MOE_LMAX = 8, 64, 64, 256


def _pp_trainer(torch, name, n_batches, capture=True):
    """A config's workflow over a card-resident induction loader of
    ``n_batches`` train batches and one to evaluate, through
    ``StandardWorkflow.make_trainer`` (no mesh)."""
    from veles_tpu_torch.__main__ import make_loader
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.runtime.decision import Decision
    from veles_tpu_torch.runtime.step_cache import StepCache
    cfg = _config(os.path.join("configs", name + ".json"))
    ld = dict(cfg["loader"])
    ld.pop("name")
    b = ld["minibatch_size"]
    loader = make_loader("induction", device=DEVICE, n_train=n_batches * b,
                         n_valid=b, **ld)
    return StandardWorkflow(cfg["workflow"]).make_trainer(
        loader, Decision(max_epochs=1), device=DEVICE,
        step_cache=StepCache(capture=capture))


def _pp_clis(names):
    """Each config through ``python -m veles_tpu_torch`` (its published 25
    epochs, captured steps, no mesh), all of them at once on the card
    (small LMs that leave it mostly idle: one after the other they took
    ~155 s of the script); each run's record as :func:`_pp_cli_record`
    makes it, its walls those of concurrent runs."""
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    runs = []
    try:
        for name in names:
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile(
                "w+")
            cmd = [sys.executable, "-m", "veles_tpu_torch",
                   os.path.join("configs", name + ".json"),
                   "--random-seed", "1"]
            runs.append((name, subprocess.Popen(
                cmd, cwd=here, stdout=out, stderr=err, text=True, env=env),
                out, err, time.perf_counter()))
        recs = {}
        for name, proc, out, err, t0 in runs:
            try:
                rc = proc.wait(timeout=max(1.0, t0 + PP_TIMEOUT
                                           - time.perf_counter()))
            except subprocess.TimeoutExpired:
                fail(f"the {name} CLI run exceeded {PP_TIMEOUT} s")
            wall = time.perf_counter() - t0
            out.seek(0)
            err.seek(0)
            recs[name] = _pp_cli_record(name, rc, out.read(), err.read(),
                                        wall, len(runs))
        return recs
    finally:
        for _, proc, out, err, _ in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(60)
            out.close()
            err.close()


def _pp_cli_record(name, rc, stdout, stderr, wall, concurrent):
    """One config's CLI run: its results, per-epoch decisions and bar."""
    if rc != 0:
        fail(f"the {name} CLI run exited {rc}: {stderr[-2000:]}")
    res = json.loads(stdout.strip().splitlines()[-1])
    r = types.SimpleNamespace(stderr=stderr)
    b = _config(os.path.join("configs", name + ".json"))["loader"][
        "minibatch_size"]
    rec = {"phase": "pipeline_train_cli", "config": f"configs/{name}.json",
           "best_error_pct": res["best_value"],
           "best_epoch": res["best_epoch"], "epochs": res["epochs"],
           "bar": PP_BARS.get(name), "wall_s": wall,
           "concurrent_runs": concurrent,
           "epoch_wall_s": res["elapsed_s"] / max(res["epochs"], 1),
           "train_step_s_median": res["train_step_s_median"],
           "samples_per_s_median_step": b / res["train_step_s_median"],
           "train_samples_per_s": res["train_samples_per_s"],
           "train_mfu": res["train_mfu"],
           "per_epoch": [ln.split("Decision: ")[-1]
                         for ln in r.stderr.splitlines()
                         if "error_pct=" in ln]}
    say(rec)
    if rec["bar"] is not None and not res["best_value"] <= rec["bar"]:
        fail(f"{name} reached {res['best_value']} % validation error, "
             f"above the {rec['bar']} % bar")
    return rec


def _pp_flash_shape():
    """(B, T, H, D) of the pp_moe stages' attention, from its config."""
    cfg = _config(os.path.join("configs", PP_PATH + ".json"))
    dim = cfg["workflow"]["layers"][0]["dim"]
    heads = cfg["workflow"]["layers"][1]["stages"][0][0]["n_heads"]
    return (cfg["loader"]["minibatch_size"], cfg["loader"]["seq_len"],
            heads, dim // heads)


def _pp_counted(torch, name):
    """The config's captured epoch of PP_BATCHES batches and its eval,
    every kernel count set to 0 before and read after; then a profiled
    window of 3 captured steps (idle share) holding the counted launches
    against the trace."""
    from veles_tpu_torch.ops.kernels import KERNELS
    from veles_tpu_torch.ops.kernels import flash_attention as fa
    from veles_tpu_torch.ops.kernels import flash_bwd_dkv as dkv
    from veles_tpu_torch.ops.kernels import flash_bwd_dq as dq
    from veles_tpu_torch.ops.kernels import fused_dropout as fd
    from veles_tpu_torch.ops.kernels import gather_rows as gr
    trainer = _pp_trainer(torch, name, PP_BATCHES)
    _reset_counts()
    trainer.initialize(seed=0)
    trainer.run()
    torch.cuda.synchronize()
    launches = {k.NAME: k.launches.count for k in KERNELS}
    variants = {k.NAME: k.launches.by_variant() for k in KERNELS
                if k.launches.by_variant()}
    st = trainer.step_cache.stats()
    step = trainer._train_step
    per_replay = {k.NAME: n for c, (n, _) in getattr(step, "launches", ())
                  for k in KERNELS if k.launches is c}
    prof = _train_profile(torch, trainer,
                          window=f"3 captured train steps of {name}")
    seeded = step.step.seeded
    rec = {"phase": "pipeline_train_epoch", "config": name,
           "batches": PP_BATCHES, "launches": launches,
           "variants": variants, "per_replay": per_replay,
           "seed_slots": seeded, "step_cache": st,
           "idle_share": prof["device_idle_share"],
           "top_kernels_s": prof["top_kernels_s"],
           "launch_trace": prof["launch_trace"]}
    rec["ok"] = (st["train"]["captured"] and st["eval"]["captured"]
                 and all(launches[k.NAME] and variants.get(k.NAME) == {
                     F32_VARIANT: launches[k.NAME]} for k in (fa, dq, dkv))
                 and variants.get(gr.NAME) == {"batch": PP_BATCHES + 1}
                 # a dropout launches forward and backward (its mask again)
                 and per_replay.get(fd.NAME, 0) == 2 * len(seeded)
                 and launches[fd.NAME] >= 2 * len(seeded) * PP_BATCHES
                 and prof["launch_trace"]["ok"]
                 and prof["launch_trace"]["captured"])
    say(rec)
    if not rec["ok"]:
        fail(f"{name}'s captured epoch did not run its kernels as "
             f"counted: {rec}")
    return trainer, rec


def _pp_f32_check(torch, trainer):
    """One float32 forward/backward of the pp_moe workflow through the
    kernels (f32 flash, dropout) and one through their plain versions,
    same weights, batch and key: loss and every gradient norm within
    STEP_LOSS_RTOL / STEP_GRAD_RTOL."""
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.ops.kernels import flash_attention as fa
    from veles_tpu_torch.ops.kernels import flash_bwd_dkv as dkv
    from veles_tpu_torch.ops.kernels import flash_bwd_dq as dq
    from veles_tpu_torch.ops.kernels import fused_dropout as fd
    from veles_tpu_torch.units.workflow import seed_key, split_state_key
    wf, ws = trainer.workflow, trainer.wstate
    batch = next(trainer.loader.iter_epoch(TRAIN, 0)).gather()
    _, sub = split_state_key(seed_key(0))
    mods = (fa, dq, dkv, fd)
    before = [m.launches.count for m in mods]
    k_loss, k_norms, _ = _loss_and_grad_norms(torch, wf, ws["params"],
                                              batch, ws["state"], sub)
    mid = [m.launches.count for m in mods]
    with plain_routes(mods):
        p_loss, p_norms, _ = _loss_and_grad_norms(
            torch, wf, ws["params"], batch, ws["state"], sub)
    after = [m.launches.count for m in mods]
    launched = all(m > b for m, b in zip(mid, before)) and after == mid
    loss_rel = abs(k_loss - p_loss) / max(abs(p_loss), 1e-12)
    grad_rel = {n: abs(k_norms[n] - p_norms[n]) / max(p_norms[n], 1e-12)
                for n in p_norms}
    worst = max(grad_rel, key=grad_rel.get)
    return {"loss_kernels": k_loss, "loss_plain": p_loss,
            "loss_rel_diff": loss_rel, "loss_rtol": STEP_LOSS_RTOL,
            "grad_norm_max_rel_diff": grad_rel[worst], "worst": worst,
            "grad_rtol": STEP_GRAD_RTOL, "kernels_launched": launched,
            "ok": (launched and np.isfinite(k_loss)
                   and loss_rel <= STEP_LOSS_RTOL
                   and grad_rel[worst] <= STEP_GRAD_RTOL)}


def _pp_dropout_timing(torch, B, T, E_, rate):
    """The dropout kernel at the pp_moe stages' shape (B x T x E float32,
    the seed in a slot on the card) against its plain version, bitwise;
    its time, the plain version's, F.dropout's and the byte bound."""
    import torch.nn.functional as F
    from veles_tpu_torch.ops.kernels import fused_dropout as fd
    gen = torch.Generator().manual_seed(17)
    x = torch.randn((B, T, E_), generator=gen).cuda()
    seed = fd.seed_tensor(0x51ED, "cuda")
    y, ref = fd.fused_dropout(x, seed, rate), fd.fused_dropout_plain(
        x, seed, rate)
    torch.cuda.synchronize()
    if not torch.equal(y, ref):
        fail("the dropout kernel disagrees with its plain version at the "
             "pp_moe stages' shape")
    b_ms, b_by = cost_bound(fd.cost(x), H100_F32_FLOPS)
    return {"max_abs_err": 0.0, "path": PP_PATH,
            "ms": cuda_ms(torch, lambda: fd._launch(x, seed, rate),
                          iters=100),
            "plain_ms": cuda_ms(torch, lambda: fd.fused_dropout_plain(
                x, seed, rate)),
            "library_ms": cuda_ms(torch, lambda: F.dropout(
                x, rate, training=True), iters=100),
            "bound_ms": b_ms, "bound_by": b_by,
            "seed": "int32 slot on the card",
            "library_note": "F.dropout at the same shape and rate: "
                            "another mask stream",
            "shape": {"B": B, "T": T, "E": E_, "dtype": "float32",
                      "rate": rate}}


def phase_pipeline_train(torch):
    """The four pipelined configs: each through the CLI for its 25
    epochs, the four runs at once (no mesh, captured; induction_lm_pp and
    induction_lm_pp_moe to the 5 % bar), then in-process a captured epoch
    of PP_BATCHES batches of each with the counts set to 0 before (f32
    flash kernels, two dropout launches a stage dropout a replay,
    one batch gather a batch) and a profiled window holding them against
    the trace; the pp_moe step through the kernels against the plain
    versions in float32; the path's kernels timed at its shape.  Returns
    the pp_moe path's timing and launches for the kernels line."""
    from veles_tpu_torch.ops.kernels import flash_attention as fa
    from veles_tpu_torch.ops.kernels import flash_bwd_dkv as dkv
    from veles_tpu_torch.ops.kernels import flash_bwd_dq as dq
    from veles_tpu_torch.ops.kernels import fused_dropout as fd
    from veles_tpu_torch.ops.kernels import gather_rows as gr
    torch.backends.cuda.matmul.allow_tf32 = False
    cli = _pp_clis(PP_CONFIGS)
    counted = {}
    for name in PP_CONFIGS:
        trainer, counted[name] = _pp_counted(torch, name)
        if name != PP_PATH:
            del trainer
            torch.cuda.empty_cache()
            continue
        moe_trainer = trainer
    check = _pp_f32_check(torch, moe_trainer)
    say({"phase": "pipeline_train_f32_step", **check})
    if not check["ok"]:
        fail(f"the pp_moe step through the kernels differs from the plain "
             f"versions': {check}")
    cfg = _config(os.path.join("configs", PP_PATH + ".json"))
    ld = cfg["loader"]
    dim = cfg["workflow"]["layers"][0]["dim"]
    timing = _f32_flash_timing(torch, *_pp_flash_shape(), PP_PATH,
                               "the pp_moe stages'")
    timing[f"{fd.NAME}/{PP_PATH}"] = _pp_dropout_timing(
        torch, ld["minibatch_size"], ld["seq_len"], dim,
        cfg["workflow"]["layers"][1]["stages"][0][1]["dropout_ratio"])
    timing[f"{gr.NAME}/{PP_PATH}"] = _family_gather_timing(
        torch, moe_trainer.loader, PP_PATH)
    say({"phase": "pipeline_train_kernel_timing", **timing})
    launches = counted[PP_PATH]["launches"]
    counts = {f"{name}/{PP_PATH}": launches[name]
              for name in (fa.NAME, dq.NAME, dkv.NAME, fd.NAME, gr.NAME)}
    say({"phase": "pipeline_train",
         "configs": {n: {k: c[k] for k in ("best_error_pct", "epochs",
                                           "epoch_wall_s",
                                           "samples_per_s_median_step")}
                     for n, c in cli.items()},
         "idle_share": {n: c["idle_share"] for n, c in counted.items()},
         "per_replay": {n: c["per_replay"] for n, c in counted.items()}})
    del moe_trainer
    torch.cuda.empty_cache()
    return {"timing": timing, "launches": counts}


def phase_distributed_one_rank(torch):
    """``initialize_distributed`` with NCCL on the card at world size 1,
    the mesh's groups over it, and DIST_STEPS data-parallel train steps
    of induction_lm_pp_moe (dropout and MoE in the stack) through the
    group: parameters, optimizer state, unit state and metrics bit for
    bit those of the no-mesh step from the same init and batches (both
    eager).  A failure of NCCL to start fails the phase."""
    import socket

    import torch.distributed as dist
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.parallel.distributed import (initialize_distributed,
                                                      shutdown_distributed)
    from veles_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from veles_tpu_torch.runtime.snapshotter import wstate_to_numpy
    from veles_tpu_torch.units.workflow import ShardedTrainStep
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    try:
        initialize_distributed(f"127.0.0.1:{port}", 1, 0, device=DEVICE,
                               timeout_s=120)
        mesh = make_mesh(MeshSpec(data=1), timeout_s=120)
        backend = dist.get_backend()
    except Exception as e:       # NCCL did not start: the phase fails
        fail(f"the one-rank NCCL group did not start: {e!r}")
    init_s = time.perf_counter() - t0
    try:
        runs = {}
        for kind in ("plain", "sharded"):
            tr = _pp_trainer(torch, PP_PATH, DIST_STEPS, capture=False)
            tr.initialize(seed=0)
            wf, opt = tr.workflow, tr.optimizer
            step = (wf.make_sharded_train_step(opt, mesh)
                    if kind == "sharded" else wf.make_train_step(opt))
            ws, mets = tr.wstate, []
            t1 = time.perf_counter()
            for batch in tr.loader.iter_epoch(TRAIN, 0):
                ws, m = step(ws, batch.gather())
                mets.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            runs[kind] = {"state": wstate_to_numpy(ws), "metrics": mets,
                          "wall_s": time.perf_counter() - t1,
                          "is_sharded": isinstance(step, ShardedTrainStep)}
            del tr, ws
        diff = _state_diff(torch, runs["plain"]["state"],
                           runs["sharded"]["state"])
        rec = {"phase": "distributed_one_rank", "backend": backend,
               "world_size": dist.get_world_size(), "init_s": init_s,
               "mesh": mesh.shape, "data_group": mesh.group("data")
               is not None, "steps": DIST_STEPS, "config": PP_PATH,
               "state_leaves_differing": diff,
               "metrics_equal": runs["plain"]["metrics"]
               == runs["sharded"]["metrics"],
               "step_ms": {k: r["wall_s"] / DIST_STEPS * 1e3
                           for k, r in runs.items()},
               "loss": [m["loss"] for m in runs["sharded"]["metrics"]]}
        rec["ok"] = (backend == "nccl" and rec["world_size"] == 1
                     and rec["data_group"] and runs["sharded"]["is_sharded"]
                     and not diff and rec["metrics_equal"]
                     and all(np.isfinite(rec["loss"])))
    finally:
        shutdown_distributed()
    say(rec)
    if not rec["ok"]:
        fail(f"the one-rank data-parallel step differs from the no-mesh "
             f"step: {rec}")
    return rec


def _moe_chain(torch, seed=0):
    """induction_lm_pp_moe.json's chain at its width (dim 64, vocab 16):
    the three attention stages with their dropouts taken out, the MoE
    stage, seq_last and the softmax head; float32, random weights from
    ``seed``."""
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.units.base import Spec
    wcfg = _config(os.path.join("configs", PP_PATH + ".json"))["workflow"]
    for layer in wcfg["layers"]:
        if layer["type"] == "pipeline_stack":
            layer["stages"] = [[s for s in st if s["type"] != "dropout"]
                               for st in layer["stages"]]
    wf = StandardWorkflow(wcfg).workflow
    wf.build({"@input": Spec((2, MOE_PROMPT), torch.int32),
              "@labels": Spec((2,), torch.int32),
              "@mask": Spec((2,), torch.float32)})
    return wf, wf.init_state(seed, device=DEVICE)


def _moe_paged_timing(torch, wf, pos):
    """The paged kernel at the chain's shape (MOE_ROWS rows, 4 heads of
    16, a float32 pool) against its plain version, timed."""
    from veles_tpu_torch.ops.kernels import paged_attention as pa
    from veles_tpu_torch.runtime.generate import DecodePlan
    u = DecodePlan(wf)._attn_units[0]
    H, Dh = u.n_heads, wf.specs["emb"].shape[-1] // u.n_heads
    gen = torch.Generator().manual_seed(23)
    args = _paged_inputs(torch, gen, MOE_ROWS, H, u.n_kv_heads, Dh, PAGE,
                         MOE_LMAX // PAGE, torch.float32, pos, True)
    out = pa.paged_attention_decode(*args, page_size=PAGE,
                                    n_kv_heads=u.n_kv_heads)
    ref = pa.paged_attention_decode_plain(*args, page_size=PAGE,
                                          n_kv_heads=u.n_kv_heads)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not err <= PAGED_TOL:
        fail(f"the paged kernel disagrees with its plain version at the "
             f"MoE chain's shape: {err}")
    t = _paged_timing(torch, pa, args, err, pos, H, u.n_kv_heads)
    t["path"] = "moe_serving"
    say({"phase": "moe_kernel_timing", pa.NAME: t})
    return t


def phase_moe_serving(torch):
    """The MoE chain served by captured paged engines (MOE_ROWS slots,
    l_max MOE_LMAX, page PAGE, paged kernel on) with the launch counts
    set to 0 at the start: the greedy MOE_ROWS x (MOE_PROMPT + MOE_NEW)
    request's tokens equal ``generate()``'s (MoE decoded dropless inside
    the graphs), bitwise on an eager engine, a megastep (N=MEGASTEP_N)
    one and a speculative (k=SPEC_K) one driven with a verify dispatch
    every iteration; a profiled decode window holds each replay's paged
    launches (3, one an attention stage) against the trace; every
    engine's paged launches are 3 x its micro-steps.  Returns the paged
    kernel's launches and its timing at the chain's shape."""
    from veles_tpu_torch.ops.kernels import paged_attention as pa
    from veles_tpu_torch.runtime.generate import DecodePlan, generate
    wf, ws = _moe_chain(torch)
    layers = len(DecodePlan(wf)._attn_units)
    rng = np.random.default_rng(43)
    prompts = rng.integers(0, 16, (MOE_ROWS, MOE_PROMPT)).astype(np.int32)
    ref = generate(wf, ws, prompts, MOE_NEW).cpu().numpy()
    _reset_counts()
    kw = dict(slots=MOE_ROWS, l_max=MOE_LMAX, prefill_chunk=0)
    eng = _serve_engine(wf, ws, **kw)
    window = np.random.default_rng(12).integers(
        0, 16, (MOE_ROWS, PROFILE_PROMPT)).astype(np.int32)
    prof = _decode_window(torch, eng, window, lambda e, i: e._step_once())
    eng.start()
    try:
        toks, metrics = _rec_serve(torch, eng, prompts, MOE_NEW)
        st = eng.stats()
    finally:
        eng.stop()
    runs, stats = {}, [st]
    for name, extra in (("eager", {"capture": False}),
                        ("megastep", {"megastep": MEGASTEP_N})):
        e = _serve_engine(wf, ws, **kw, **extra).start()
        try:
            runs[name] = _rec_serve(torch, e, prompts, MOE_NEW)[0]
            stats.append(e.stats())
        finally:
            e.stop()
    spec = _serve_engine(wf, ws, **kw, spec=True, spec_k=SPEC_K)
    runs["spec"], s0, s1, _ = _driven_run(torch, spec, prompts, MOE_NEW,
                                          [{}] * MOE_ROWS, _verify_always)
    stats.append(s1)
    torch.cuda.synchronize()
    paged = pa.launches.count
    want = layers * sum(_micro_steps(s, s.get("capture", {}).get(
        "decode", {}).get("captured", False)) for s in stats)
    per = prof["launch_trace"]["per_replay_by_kind"].get("decode", {}).get(
        PAGED_F32)
    rec = {"phase": "moe_serving", "chain": "induction_lm_pp_moe stack "
           "(3 attention stages, dropout out, MoE 4 experts top-2) + head",
           "attention_layers": layers, "slots": MOE_ROWS, "l_max": MOE_LMAX,
           "prompt": MOE_PROMPT, "new": MOE_NEW, "dtype": "float32",
           **metrics,
           "tokens_per_s": MOE_ROWS * MOE_NEW / metrics["wall_s"],
           "generate_equal": bool(np.array_equal(toks, ref)),
           "tokens_equal": {k: bool(np.array_equal(v, toks))
                            for k, v in runs.items()},
           "mega_dispatches": stats[2]["megastep"]["mega_dispatches"],
           "verify_steps": s1["spec"]["verify_steps"]
           - s0["spec"]["verify_steps"],
           "paged_per_decode_replay": per, "paged_launches": paged,
           "paged_launches_expected": want,
           "idle_share": prof["device_idle_share"],
           "launch_trace_ok": prof["launch_trace"]["ok"],
           "launch_trace_mismatch": prof["launch_trace"]["mismatch"],
           "captures": {k: v["captured"] for k, v in st["capture"].items()},
           "recompiles": st["compile"]["recompiles"]}
    rec["ok"] = (rec["generate_equal"] and all(rec["tokens_equal"].values())
                 and rec["mega_dispatches"] > 0 and rec["verify_steps"] > 0
                 and per == layers and rec["launch_trace_ok"]
                 and prof["launch_trace"]["captured"]
                 and paged == want and all(rec["captures"].values())
                 and rec["recompiles"] == 0)
    say(rec)
    if not rec["ok"]:
        fail(f"the MoE chain's serving checks failed: {rec}")
    pos = np.full(MOE_ROWS, MOE_PROMPT + MOE_NEW // 2, np.int64)
    timing = _moe_paged_timing(torch, wf, pos)
    del wf, ws
    torch.cuda.empty_cache()
    return {"paged_attention_decode": paged, "timing": timing}


class _DigitsSynthesis:
    """The mnist loader's 60k + 10k SynthDigits rendered into
    ``$VELES_TORCH_CACHE`` by a background process on the host (no card);
    :meth:`wait` joins it and reports its wall, or that the cache was
    already warm."""

    def __init__(self):
        self.warm = _digits_cache_warm()
        self.proc = None if self.warm else subprocess.Popen(
            [sys.executable, "-c",
             "import time; t = time.perf_counter(); "
             "from veles_tpu_torch.models.mnist import synthesize_mnist; "
             "synthesize_mnist(); print(time.perf_counter() - t)"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait(self):
        if self.proc is None:
            return {"cache_warm": True}
        out, err = self.proc.communicate(timeout=600)
        if self.proc.returncode != 0:
            fail(f"the SynthDigits synthesis exited "
                 f"{self.proc.returncode}: {err[-2000:]}")
        return {"cache_warm": False, "synthesis_s": float(out.split()[-1]),
                "cache_warm_after": _digits_cache_warm()}


# -- the fleet (PR 14) -----------------------------------------------------------

# the fleet phase: FLEET_PROMPT + FLEET_NEW greedy requests through the
# router held to generate(); FLEET_SESSIONS sessions of a FLEET_SYSTEM-
# token system prompt, FLEET_TURNS streamed requests each (a
# FLEET_TAIL-token tail); FLEET_THREADS clients across the swap, the
# drain and the kill; 2 x SLOTS requests of FLEET_SHORT + FLEET_TPS_NEW
# for the decode rate; a FLEET_JOB-prompt batch job of FLEET_SHORT +
# FLEET_JOB_NEW sampled requests with bursts of FLEET_INTERACTIVE (every
# serving slot's worth) interactive requests of FLEET_SHORT + FLEET_NEW
# arriving mid-job.  FLEET_SHORT is
# one page: shorter than the two pages a disaggregated leg needs, so
# those requests go straight to the serving replicas (a cold prompt of
# two pages or more takes the prefill replica's leg first, and that
# replica's one-position prefill, ~0.9 ms a token, then paces the
# traffic)
FLEET_PROMPT, FLEET_NEW = 64, 16
FLEET_SESSIONS, FLEET_SYSTEM, FLEET_TAIL, FLEET_TURNS = 4, 256, 32, 4
FLEET_THREADS = 16
FLEET_SHORT = 24
FLEET_TPS_NEW = 128
FLEET_JOB, FLEET_JOB_NEW = 32, 256
FLEET_INTERACTIVE = 2 * SLOTS
FLEET_CLI_CONFIG = os.path.join("configs", "induction_lm.json")


class _Fleet:
    """Two ``mixed`` replicas and one ``prefill`` replica of the bench LM
    (float32, paged, captured, SLOTS slots each, booted from the seed-0
    snapshot ``snap0``) behind a ``FleetServer`` with a job store; every
    engine the factory builds (restarts included) is kept in
    ``engines`` for the phase's launch count."""

    def __init__(self, torch, wf, ws0, snap0, jobs_dir):
        from veles_tpu_torch.runtime.deploy import DeployController
        from veles_tpu_torch.runtime.fleet import (FleetRouter, FleetServer,
                                                   InProcessReplica)
        from veles_tpu_torch.runtime.restful import RestfulServer
        self.engines, self.replicas, self.fsrv = [], [], None

        def factory():
            own = dict(ws0, params={u: {k: t.clone() for k, t in p.items()}
                                    for u, p in ws0["params"].items()})
            eng = _serve_engine(wf, own).start()
            self.engines.append(eng)
            srv = RestfulServer(wf.make_predict_step(), eng.wstate,
                                PREDICT_B, (PREDICT_T,), port=0, workflow=wf,
                                engine=eng, device=DEVICE)
            DeployController(server=srv, boot_source=snap0)
            return srv.start()

        try:
            for role in ("mixed", "mixed", "prefill"):
                self.replicas.append((InProcessReplica(factory), role))
            self.router = FleetRouter(scrape_interval_s=0.1)
            for rep, role in self.replicas:
                self.router.add_replica(url=rep.url,
                                        registry_key="in-process",
                                        restart=rep.restart, kill=rep.kill,
                                        role=role)
            self.fsrv = FleetServer(self.router, port=0,
                                    jobs_dir=jobs_dir).start()
        except BaseException:
            self.stop()
            raise
        self.port = self.fsrv.port

    def live(self):
        return [rep for rep, _ in self.replicas]

    def stop(self):
        if self.fsrv is not None:
            self.fsrv.stop()
        for rep, _ in self.replicas:
            rep.stop()


def _stream_tokens(frames, n):
    """The tokens of a gapless, duplicate-free stream of ``n`` frames
    that ends on ``length``, else None."""
    body = [f for f in frames if not f.get("done")]
    if [f["i"] for f in body] != list(range(n)) or not frames \
            or frames[-1].get("finish_reason") != "length":
        return None
    return [f["token"] for f in body]


def _concurrent(fn, items):
    """``fn(item)`` on a thread each; the results in ``items``' order."""
    import threading
    out = [None] * len(items)

    def run(i):
        try:
            out[i] = fn(items[i])
        except Exception as e:  # noqa: BLE001 — the check names it
            out[i] = repr(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    if any(t.is_alive() for t in threads):
        fail("a fleet client thread did not return")
    return out


def _under_load(port, prompts, new, action):
    """``action()`` while FLEET_THREADS clients loop greedy requests
    through the router (``_hammer``): (its result, the clients' status
    codes, the seconds it took)."""
    import threading
    codes, stop, lock = [], threading.Event(), threading.Lock()
    threads = [threading.Thread(target=_hammer, args=(
        port, prompts[i % len(prompts)][None], new, stop, codes, lock))
        for i in range(FLEET_THREADS)]
    for t in threads:
        t.start()
    try:
        _wait(lambda: len(codes) >= FLEET_THREADS, 300, "load to flow")
        t0 = time.perf_counter()
        out = action()
        took = time.perf_counter() - t0
        n = len(codes)
        _wait(lambda: len(codes) >= n + FLEET_THREADS, 300,
              "load after the action")
    finally:
        stop.set()
        for t in threads:
            t.join(900)
    return out, codes, took


def _job(port, spec):
    """POST /jobs and wait for the job: (status doc, results by index,
    seconds)."""
    t0 = time.perf_counter()
    code, doc = _http_json(port, "/jobs", spec)
    if code != 200:
        fail(f"POST /jobs answered {code}: {doc}")
    jid = doc["id"]
    _wait(lambda: _http_json(port, f"/jobs/{jid}")[1]["state"] == "done",
          600, "the batch job")
    took = time.perf_counter() - t0
    st = _http_json(port, f"/jobs/{jid}")[1]
    res = _http_json(port, f"/jobs/{jid}/results?limit={FLEET_JOB}")[1]
    return st, {r["index"]: r for r in res["results"]}, took


def _fleet_trace_window(torch, fleet, prompts):
    """A profiled window of one burst of greedy requests through the
    router, every replica's engine replaying: the counted launches held
    against the trace, each graph's replays counted (``_launch_trace_
    check``), and the device's busy share."""
    engines = [rep.srv.engine for rep in fleet.live()]
    torch.cuda.synchronize()
    with _profiled(torch, lambda: torch.ones(1, device=DEVICE).sum()) \
            as win:
        s0 = [e.stats() for e in engines]
        t0 = time.perf_counter()
        out = _concurrent(lambda row: _http_json(fleet.port, "/generate", {
            "prompt": [row.tolist()], "steps": FLEET_NEW}), list(prompts))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s1 = [e.stats() for e in engines]
    if any(not isinstance(o, tuple) or o[0] != 200 for o in out):
        fail(f"a profiled fleet request failed: {out}")
    replays = []
    for e, a, b in zip(engines, s0, s1):
        c0, c1 = _dispatch_counts(a), _dispatch_counts(b)
        replays += [(e._fns[k], c1[k] - c0[k]) for k in c1]
    rec = _busy(win["prof"], wall, f"{len(prompts)} x ({FLEET_PROMPT} + "
                                   f"{FLEET_NEW}) through the router")
    rec["launch_trace"] = _launch_trace_check(win, replays)
    return rec


def phase_fleet(torch, snapshot, work_dir):
    """The fleet router at bench width, float32, on one H100: two
    ``mixed`` replicas and a ``prefill`` one behind a ``FleetServer``.
    Greedy requests through the router equal ``generate()``'s and a
    replica's local prefill; shared-prefix sessions take affinity hits
    and pages the prefill leg or a remote fetch placed give the local
    prefill's tokens; a stream cut by ``stream_cut_at_token`` is spliced
    gapless and bitwise; a coordinated swap under load fails no request
    and leaves every replica on the new weights; an injected flip
    failure rolls every replica back; a killed replica loses no request
    (ejected, one resubmission at least); a rolling drain under load
    drops none (each restart captures while the others serve); a
    profiled burst holds the launches to the trace (4 paged a decode
    replay); a 32-prompt batch job with interactive requests mid-job is
    preempted first, stays out of the SLO histograms and gives the bytes
    of an uninterrupted run and of a run with a replica killed mid-job;
    no replica recaptures.  Then ``python -m veles_tpu_torch
    configs/induction_lm.json --snapshot SNAP --serve 0 --fleet 2`` as a
    child process, driven through /generate and /fleet.json and drained
    to exit 0."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.runtime import faults
    from veles_tpu_torch.runtime.fleet import ACTIVE, EJECTED
    from veles_tpu_torch.runtime.generate import generate
    from veles_tpu_torch.runtime.metrics import registry
    from veles_tpu_torch.runtime.snapshotter import (Snapshotter,
                                                     params_to_numpy)
    wf, ws0 = _bench_state(torch, None, 0)
    _, ws1 = _bench_state(torch, None, 1)
    snaps = {}
    for tag, ws in (("seed0", ws0), ("seed1", ws1)):
        snaps[tag] = Snapshotter("bench_lm", os.path.join(
            work_dir, tag), compression=False).save(
            tag, {"wstate": {"params": params_to_numpy(ws["params"])},
                  "workflow_checksum": wf.checksum()})
    rng = np.random.default_rng(14)
    prompts = rng.integers(0, VOCAB, (SLOTS, FLEET_PROMPT)).astype(np.int32)
    ref0 = generate(wf, ws0, prompts, FLEET_NEW).cpu().numpy()
    ref1 = generate(wf, ws1, prompts, FLEET_NEW).cpu().numpy()
    del ws1
    jobs_cfg = root.common.serve.jobs
    prev_workers = jobs_cfg.get("workers", 2)
    # more dispatch workers than the two serving replicas have slots: a
    # slot that frees is refilled with batch work at once
    jobs_cfg.workers = 3 * SLOTS
    _reset_counts()
    t_build = time.perf_counter()
    fleet = _Fleet(torch, wf, ws0, snaps["seed0"],
                   os.path.join(work_dir, "jobs"))
    build_s = time.perf_counter() - t_build
    router, port = fleet.router, fleet.port
    rec = {"replicas": ["mixed", "mixed", "prefill"], "slots": SLOTS,
           "build_s": build_s, "seconds": {}}
    mark = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        rec["seconds"][name] = now - mark[0]
        mark[0] = now

    def every_replica_answers(ref):
        """Each replica, asked directly, answers ``prompts`` with
        ``ref``'s tokens."""
        for rep in fleet.live():
            code, doc = _http_json(rep.srv.port, "/generate", {
                "prompt": prompts.tolist(), "steps": FLEET_NEW})
            if code != 200 or not np.array_equal(np.asarray(doc["tokens"]),
                                                 ref):
                return False
        return True

    try:
        pre_eng = fleet.live()[2].srv.engine
        # the local prefill's tokens: the prefill replica's own engine
        # decodes every reference prompt first (its cached pages are what
        # its prefill legs later ship)
        local = pre_eng.generate(prompts, FLEET_NEW, timeout=900)
        # greedy through the router (cold: each takes the prefill leg)
        out = _concurrent(lambda row: _http_json(port, "/generate", {
            "prompt": [row.tolist()], "steps": FLEET_NEW}), list(prompts))
        got = np.asarray([o[1]["tokens"][0] if isinstance(o, tuple)
                          and o[0] == 200 else [-1] * (FLEET_PROMPT
                                                        + FLEET_NEW)
                          for o in out])
        rec["greedy"] = {"rows": SLOTS, "prompt": FLEET_PROMPT,
                         "new": FLEET_NEW,
                         "equal_generate": bool(np.array_equal(got, ref0)),
                         "equal_local_prefill": bool(np.array_equal(
                             got, local)),
                         "local_equal_generate": bool(np.array_equal(
                             local, ref0))}
        lap("greedy")
        # shared-prefix sessions: one warm request a session, then its
        # turns, streamed; references from the prefill replica's engine
        systems = rng.integers(0, VOCAB, (FLEET_SESSIONS, FLEET_SYSTEM))
        turns = [[np.concatenate([systems[s], rng.integers(
            0, VOCAB, FLEET_TAIL)]).astype(np.int32)
            for _ in range(FLEET_TURNS)] for s in range(FLEET_SESSIONS)]
        refs = [[pre_eng.generate(p[None], FLEET_NEW, timeout=900)[0]
                 [FLEET_SYSTEM + FLEET_TAIL:].tolist() for p in ts]
                for ts in turns]
        aff0 = router.fleet_doc()["affinity"]
        kv0 = [rep.srv.engine.stats()["kv_transfer"]
               for rep in fleet.live()]

        def session(s):
            out = []
            for t, p in enumerate(turns[s]):
                frames, ttft = _stream(port, {
                    "prompt": p.tolist(), "steps": FLEET_NEW})
                out.append((_stream_tokens(frames, FLEET_NEW) == refs[s][t],
                            ttft))
            return out

        sess = _concurrent(session, list(range(FLEET_SESSIONS)))
        if any(not isinstance(s, list) for s in sess):
            fail(f"a fleet session failed: {sess}")
        aff1 = router.fleet_doc()["affinity"]
        kv1 = [rep.srv.engine.stats()["kv_transfer"]
               for rep in fleet.live()]
        cold = [s[0][1] for s in sess]
        warm = [x[1] for s in sess for x in s[1:]]
        rec["affinity"] = {
            "sessions": FLEET_SESSIONS, "system": FLEET_SYSTEM,
            "tail": FLEET_TAIL, "turns": FLEET_TURNS,
            "tokens_equal_local_prefill": all(x[0] for s in sess
                                              for x in s),
            "hits": aff1["hits"] - aff0["hits"],
            "requests": aff1["requests"] - aff0["requests"],
            "imported_pages": sum(b["imported_pages"] - a["imported_pages"]
                                  for a, b in zip(kv0, kv1)),
            "remote_hit_pages": sum(b["remote_hit_pages"]
                                    - a["remote_hit_pages"]
                                    for a, b in zip(kv0, kv1)),
            "ttft_cold_s": {"mean": float(np.mean(cold)),
                            "max": float(np.max(cold))},
            "ttft_warm_affinity_s": {"mean": float(np.mean(warm)),
                                     "max": float(np.max(warm))},
            "kv_transfer": router.fleet_doc()["kv_transfer"]}
        lap("affinity")
        # decode tokens/s through the router, SLOTS x 2 slots busy: the
        # generated tokens over the burst's wall, and the serving
        # engines' own decode rates (tokens over their decode seconds)
        tps_prompts = rng.integers(0, VOCAB, (2 * SLOTS, FLEET_SHORT))
        serving = [rep.srv.engine for rep, role in fleet.replicas
                   if role == "mixed"]
        e0 = [e.stats() for e in serving]
        t0 = time.perf_counter()
        out = _concurrent(lambda row: _http_json(port, "/generate", {
            "prompt": [row.tolist()], "steps": FLEET_TPS_NEW}),
            list(tps_prompts))
        wall = time.perf_counter() - t0
        e1 = [e.stats() for e in serving]
        rec["router_tokens_per_s"] = {
            "requests": 2 * SLOTS, "prompt": FLEET_SHORT,
            "new": FLEET_TPS_NEW, "wall_s": wall,
            "ok": sum(isinstance(o, tuple) and o[0] == 200 for o in out),
            "tokens_per_s": 2 * SLOTS * FLEET_TPS_NEW / wall,
            "engines_decode_tokens_per_s": [
                (b["decode_tokens"] - a["decode_tokens"])
                / max(b["decode_seconds"] - a["decode_seconds"], 1e-9)
                for a, b in zip(e0, e1)]}
        lap("tokens_per_s")
        # a stream cut after its 4th frame, spliced on a survivor
        body = {"prompt": prompts[0].tolist(), "steps": FLEET_NEW,
                "temperature": 0.8, "top_k": 40, "seed": 7}
        clean = _stream_tokens(_stream(port, body)[0], FLEET_NEW)
        resumes0 = router._m_stream_resumes.value
        faults.configure(stream_cut_at_token=4)
        try:
            cut = _stream_tokens(_stream(port, body)[0], FLEET_NEW)
        finally:
            faults.reset()
        rec["stream_cut"] = {
            "at_token": 4, "gapless_bitwise": cut is not None
            and cut == clean,
            "resumes": router._m_stream_resumes.value - resumes0}
        lap("stream_cut")
        # the coordinated swap to the seed-1 snapshot under load
        swap, codes, swap_s = _under_load(
            port, prompts, FLEET_NEW,
            lambda: _http_json(port, "/admin/reload",
                               {"path": snaps["seed1"]}))
        models = [_http_json(rep.srv.port, "/models")[1]
                  for rep in fleet.live()]
        deps = [rep.srv.deploy for rep in fleet.live()]
        rec["swap"] = {
            "status": swap[0], "swapped": swap[1].get("swapped"),
            "requests": len(codes), "failed": sum(c != 200 for c in codes),
            "wall_s": swap_s,
            "stage_ms": [d.last_stage_ms for d in deps],
            "flip_ms": [d.last_flip_ms for d in deps],
            "active_versions": [m["active"] for m in models],
            "tokens_equal_generate_seed1": every_replica_answers(ref1)}
        lap("swap")
        # an injected flip failure on one replica rolls all back
        victim = fleet.live()[1].srv.engine
        real_swap = victim.swap_params

        def boom(params, **kw):
            raise RuntimeError("injected flip failure")

        victim.swap_params = boom
        try:
            code, rb = _http_json(port, "/admin/reload",
                                  {"path": snaps["seed0"]})
        finally:
            victim.swap_params = real_swap
        rec["rollback"] = {
            "status": code, "phase": rb.get("phase"),
            "rolled_back": rb.get("rolled_back"),
            "rollback_errors": rb.get("rollback_errors"),
            "staged_left": [rep.srv.deploy.staged_token
                            for rep in fleet.live()],
            "tokens_still_seed1": every_replica_answers(ref1)}
        lap("rollback")
        # a replica killed mid-burst (the fault knob's kill handle)
        resub0 = router._m_resubmissions.value
        faults.configure(replica_crash_at_request=router._route_count + 6)
        try:
            out = _concurrent(lambda row: _http_json(port, "/generate", {
                "prompt": [row.tolist()], "steps": FLEET_NEW}),
                list(np.concatenate([prompts, prompts])))
        finally:
            faults.reset()
        _wait(lambda: [r["state"] for r in router.fleet_doc()[
            "replicas"]].count(EJECTED) == 1, 60, "the victim's ejection")
        rec["kill"] = {"requests": len(out),
                       "ok": sum(isinstance(o, tuple) and o[0] == 200
                                 for o in out),
                       "ejected": [r["id"] for r in router.fleet_doc()[
                           "replicas"] if r["state"] == EJECTED],
                       "resubmissions": router._m_resubmissions.value
                       - resub0}
        lap("kill")
        # a rolling drain under load: every replica drained, rebuilt (its
        # engine captured while the others serve) and readmitted; the
        # killed one repaired
        drain, codes, drain_s = _under_load(port, prompts, FLEET_NEW,
                                            router.rolling_drain)
        rec["rolling_drain"] = {
            "completed": drain["completed"], "wall_s": drain_s,
            "requests": len(codes), "failed": sum(c != 200 for c in codes),
            "readmitted": [r.get("readmitted") for r in drain["replicas"]],
            "prewarm": [r.get("prewarm") for r in drain["replicas"]],
            "states": [r["state"] for r in router.fleet_doc()["replicas"]]}
        lap("rolling_drain")
        # the launches of a profiled burst held to the trace
        _wait(lambda: all(r.ready for r in router.replicas()), 60,
              "every replica ready")
        rec["trace"] = _fleet_trace_window(torch, fleet, prompts)
        lap("trace")
        # the batch job: interactive requests mid-job, then the same job
        # uninterrupted, then with a replica killed mid-job
        spec = {"prompts": rng.integers(0, VOCAB, (
            FLEET_JOB, FLEET_SHORT)).tolist(), "steps": FLEET_JOB_NEW,
            "temperature": 1.0, "top_k": 50, "seed": 123}
        inter = rng.integers(0, VOCAB, (FLEET_INTERACTIVE, FLEET_SHORT))
        reg = registry()
        h_ttft = reg.get("vt_request_ttft_seconds")
        h_qw = reg.get("vt_request_queue_wait_seconds")

        def batch_preemptions():
            return sum(rep.srv.engine.stats()["batch"]["preemptions"]
                       for rep in fleet.live())

        p0, t0c, q0c = (batch_preemptions(), h_ttft.aggregate_snapshot()[2],
                        h_qw.aggregate_snapshot()[2])
        code, doc = _http_json(port, "/jobs", spec)
        if code != 200:
            fail(f"POST /jobs answered {code}: {doc}")
        jid = doc["id"]
        mixed = [rep.srv.engine for rep, role in fleet.replicas
                 if role == "mixed"]      # the rolling drain rebuilt them

        def job_done():
            return _http_json(port, f"/jobs/{jid}")[1]["state"] == "done"

        inter_codes = []
        for _ in range(5):      # bursts mid-job, each once the batch work
            #                     holds a replica's worth of slots, until
            #                     one preempts it: a burst asks for every
            #                     serving slot, so an arrival that finds
            #                     none free takes a batch request's
            _wait(lambda: job_done() or sum(
                int(e._active.sum()) for e in mixed) >= SLOTS, 300,
                "the job to fill the serving replicas")
            if job_done():
                break
            inter_codes += [o[0] if isinstance(o, tuple) else o
                            for o in _concurrent(
                                lambda row: _http_json(port, "/generate", {
                                    "prompt": [row.tolist()],
                                    "steps": FLEET_NEW}), list(inter))]
            if batch_preemptions() > p0:
                break
        _wait(lambda: _http_json(port, f"/jobs/{jid}")[1]["state"]
              == "done", 600, "the batch job")
        run1 = {r["index"]: r for r in _http_json(
            port, f"/jobs/{jid}/results?limit={FLEET_JOB}")[1]["results"]}
        n_inter = len(inter_codes)
        rec["job_with_interactive"] = {
            "prompts": FLEET_JOB, "interactive": n_inter,
            "interactive_ok": sum(c == 200 for c in inter_codes),
            "batch_preemptions": batch_preemptions() - p0,
            "ttft_observations": h_ttft.aggregate_snapshot()[2] - t0c,
            "queue_wait_observations": h_qw.aggregate_snapshot()[2] - q0c}
        lap("job_with_interactive")
        st2, run2, job_s = _job(port, spec)
        resub0 = router._m_resubmissions.value
        faults.configure(replica_crash_at_request=router._route_count + 8)
        try:
            st3, run3, _ = _job(port, spec)
        finally:
            faults.reset()
        rec["job"] = {
            "prompts": FLEET_JOB, "len": FLEET_SHORT, "new": FLEET_JOB_NEW,
            "wall_s": job_s, "prompts_per_s": FLEET_JOB / job_s,
            "done": [st2["done"], st3["done"]],
            "failed": [st2["failed"], st3["failed"]],
            "bytes_equal_interrupted": run1 == run2,
            "bytes_equal_killed": run3 == run2,
            "killed_resubmissions": router._m_resubmissions.value - resub0,
            "ejected_after_kill": [r["id"] for r in router.fleet_doc()[
                "replicas"] if r["state"] == EJECTED]}
        lap("jobs")
        slo = router.merged_slo_doc()["metrics"]["ttft"]
        rec["merged_slo_ttft"] = {k: slo[k] for k in ("count", "p50_ms",
                                                      "p99_ms")}
    finally:
        faults.reset()
        jobs_cfg.workers = prev_workers
        fleet.stop()
    stats = [e.stats() for e in fleet.engines]
    from veles_tpu_torch.ops.kernels import paged_attention as pa
    want = LAYERS * sum(_micro_steps(st, True) for st in stats)
    variants = _paged_variants()
    rec["engines"] = len(stats)
    rec["captures"] = [st["compile"]["captures"] for st in stats]
    rec["recompiles"] = [st["compile"]["recompiles"] for st in stats]
    rec["per_replay"] = sorted({m for e in fleet.engines
                                for k in ("decode", "decode_greedy")
                                for c, (m, _) in getattr(e._fns[k],
                                                         "launches", ())
                                if c is pa.launches})
    rec["launches"] = variants
    rec["launches_expected"] = {"f32_pool": want}
    rec["cli"] = _fleet_cli(torch, snapshot)
    lap("cli")
    say({"phase": "fleet", **rec})
    aff, sw, rb, lt = rec["affinity"], rec["swap"], rec["rollback"], \
        rec["trace"]["launch_trace"]
    jw, jb, dr = rec["job_with_interactive"], rec["job"], \
        rec["rolling_drain"]
    problems = [name for name, ok in (
        ("greedy", all(rec["greedy"][k] for k in (
            "equal_generate", "equal_local_prefill",
            "local_equal_generate"))),
        ("affinity", aff["tokens_equal_local_prefill"] and aff["hits"] > 0
         and aff["imported_pages"] > 0 and aff["remote_hit_pages"] > 0),
        ("router_tokens", rec["router_tokens_per_s"]["ok"] == 2 * SLOTS),
        ("stream_cut", rec["stream_cut"]["gapless_bitwise"]
         and rec["stream_cut"]["resumes"] == 1),
        ("swap", sw["status"] == 200 and sw["swapped"] and sw["failed"] == 0
         and sw["requests"] > 0 and sw["active_versions"] == [2, 2, 2]
         and sw["tokens_equal_generate_seed1"]),
        ("rollback", rb["status"] == 409 and rb["phase"] == "commit"
         and rb["rolled_back"] and not rb["rollback_errors"]
         and rb["tokens_still_seed1"]
         and rb["staged_left"] == [None] * 3),
        ("kill", rec["kill"]["ok"] == rec["kill"]["requests"]
         and len(rec["kill"]["ejected"]) == 1
         and rec["kill"]["resubmissions"] >= 1),
        ("rolling_drain", dr["completed"] and dr["failed"] == 0
         and dr["requests"] > 0 and all(dr["readmitted"])
         and dr["states"] == [ACTIVE] * 3),
        ("trace", lt["ok"] and lt["captured"]
         and lt["per_replay_by_kind"].get("decode", {}).get(PAGED_F32)
         == LAYERS),
        ("job_interactive", jw["interactive"] > 0
         and jw["interactive_ok"] == jw["interactive"]
         and jw["batch_preemptions"] >= 1
         and jw["ttft_observations"] == jw["interactive"]
         and jw["queue_wait_observations"] == jw["interactive"]),
        ("job", jb["done"] == [FLEET_JOB] * 2 and jb["failed"] == [0, 0]
         and jb["bytes_equal_interrupted"] and jb["bytes_equal_killed"]
         and len(jb["ejected_after_kill"]) == 1),
        ("recaptures", all(c == 3 for c in rec["captures"])
         and not any(rec["recompiles"])),
        ("launches", variants.get("f32_pool", 0) == want > 0
         and rec["per_replay"] == [LAYERS]),
        ("cli", rec["cli"]["exit"] == 0 and rec["cli"]["replicas"] == 2
         and rec["cli"]["tokens_equal_generate"]
         and rec["cli"]["drain_status"] == 202))
        if not ok]
    if problems:
        fail(f"the fleet phase failed {problems}: {rec}")
    return variants


def _fleet_cli(torch, snapshot):
    """``python -m veles_tpu_torch configs/induction_lm.json --snapshot
    SNAP --serve 0 --fleet 2`` on the card as a child process: its
    banner, one greedy /generate (held to ``generate()`` on the
    snapshot's weights in this process), /fleet.json, and POST
    /admin/drain to exit 0."""
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.runtime.generate import generate
    from veles_tpu_torch.runtime.snapshotter import wstate_from_snapshot
    from veles_tpu_torch.units.base import Spec
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, FLEET_CLI_CONFIG)) as f:
        cfg = json.load(f)
    wf = StandardWorkflow(cfg["workflow"]).workflow
    B, T = cfg["loader"].get("minibatch_size", 1), cfg["loader"]["seq_len"]
    wf.build({"@input": Spec((B, T), torch.int32),
              "@labels": Spec((B,), torch.int32),
              "@mask": Spec((B,), torch.float32)})
    prompt = np.asarray([[1, 2, 3, 4, 5, 6]], np.int32)
    ref = generate(wf, wstate_from_snapshot(snapshot, wf, device=DEVICE),
                   prompt, 8).cpu().numpy().tolist()
    import tempfile
    t0 = time.perf_counter()
    # the child's log into a file: a pipe nobody reads until the end
    # would stall the child once its buffer fills
    err = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", FLEET_CLI_CONFIG,
         "--snapshot", snapshot, "--serve", "0", "--fleet", "2"],
        cwd=here, stdout=subprocess.PIPE, stderr=err, text=True)
    rec = {"config": FLEET_CLI_CONFIG}
    try:
        banner = None
        deadline = time.monotonic() + 300
        while banner is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
            if line.startswith("{"):
                banner = json.loads(line)
        if banner is None:
            err.seek(0)
            fail(f"the --fleet CLI printed no banner (exit {proc.poll()}): "
                 f"{err.read()[-2000:]}")
        rec["boot_s"] = time.perf_counter() - t0
        port = banner["serving"]
        code, doc = _http_json(port, "/generate",
                               {"prompt": prompt.tolist(), "steps": 8})
        rec["generate_status"] = code
        rec["tokens_equal_generate"] = code == 200 and doc["tokens"] == ref
        fd = _http_json(port, "/fleet.json")[1]
        rec["replicas"] = len(fd["replicas"])
        rec["dispatched"] = sum(r["dispatched"] for r in fd["replicas"])
        rec["drain_status"] = _http_json(port, "/admin/drain", {})[0]
        rec["exit"] = proc.wait(timeout=300)
        rec["wall_s"] = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(60)
        proc.stdout.close()
        err.close()
    return rec


# -- the compiled artifact (export, sealed programs, ArtifactRunner) ---------

ART_FLEET_NEW = 8              # the --fleet CLI's greedy requests
ART_PREEMPT_AT = 8             # decode steps before the forced preemption


def _artifact_state(torch, compute_dtype, seed):
    """The bench LM's workflow (``compute_dtype``) and numpy-seed weights
    on the card, a fresh copy each call (a swap writes into them)."""
    return _bench_state(torch, compute_dtype, seed)


class _ArtifactChild:
    """``python -m veles_tpu_torch --serve 0 --artifact ART [extra]`` as a
    child with no config and no model code, started at once and read
    later (its boot overlaps the parent's work): :meth:`banner` waits for
    its banner, :meth:`end` drains it (``POST /admin/drain``) and waits
    for its exit, :meth:`kill` stops it whatever its state."""

    def __init__(self, art, *extra):
        import tempfile
        here = os.path.dirname(os.path.abspath(__file__))
        # the child's log into a file: a pipe nobody reads until the end
        # would stall the child once its buffer fills
        self.err = tempfile.TemporaryFile("w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "veles_tpu_torch", "--serve", "0",
             "--artifact", art, "--device", DEVICE, *extra], cwd=here,
            stdout=subprocess.PIPE, stderr=self.err, text=True)
        self.doc = None
        self.boot_s = None

    def banner(self):
        deadline = time.monotonic() + 300
        while self.doc is None and time.monotonic() < deadline:
            line = self.proc.stdout.readline()
            if not line and self.proc.poll() is not None:
                break
            if line.startswith("{"):
                self.doc = json.loads(line)
        if self.doc is None:
            self.err.seek(0)
            fail(f"--serve --artifact printed no banner (exit "
                 f"{self.proc.poll()}): {self.err.read()[-3000:]}")
        if self.boot_s is None:
            self.boot_s = time.perf_counter() - self.t0
        return self.doc

    def end(self):
        """(the drain's status, the exit code)."""
        try:
            code = _http_json(self.doc["serving"], "/admin/drain", {})[0]
            rc = self.proc.wait(timeout=300)
        finally:
            self.kill()
        return code, rc

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(60)
        self.proc.stdout.close()
        self.err.close()


def _artifact_child_serving(torch, child, live, predict_ref):
    """The sealed bf16 artifact served by the CLI child: the greedy SLOTS
    x (PROMPT + NEW) request through ``POST /generate`` (tokens equal to
    the live engine's), its timing and the child's engine stats beside
    the live engine's, and ``POST /predict`` against the live predict."""
    banner = child.banner()
    port = banner["serving"]
    t0 = time.perf_counter()
    code, doc = _http_json(port, "/generate", {
        "prompt": live["prompts"].tolist(), "steps": NEW})
    wall = time.perf_counter() - t0
    if code != 200:
        fail(f"the artifact child's /generate answered {code}: {doc}")
    toks = np.asarray(doc["tokens"])
    st = _http_json(port, "/engine")[1]
    code, pdoc = _http_json(port, "/predict",
                            {"input": predict_ref["row"].tolist()})
    if code != 200:
        fail(f"the artifact child's /predict answered {code}")
    out = np.asarray(pdoc["output"], np.float32)
    drain_code, rc = child.end()
    err_p = float(np.abs(out - predict_ref["live"]).max())
    return {"boot_s": child.boot_s, "programs": banner.get("programs"),
            "tokens_equal_live": bool(np.array_equal(toks, live["greedy"])),
            "greedy_request": {"prompt": PROMPT, "new": NEW,
                               **_serve_metrics(st, wall)},
            "live_greedy_request": live["metrics"],
            "compile": st["compile"], "megastep": st.get("megastep"),
            "spec": st.get("spec"),
            "predict_max_abs_err": err_p,
            "predict_bitwise": bool(np.array_equal(out,
                                                   predict_ref["live"])),
            "drain_status": drain_code, "exit": rc}


def _logit_delta(torch, runner, eager):
    """The largest |logit difference| of one prefill position, the same
    token, page-table row and zeroed caches, through the runner's sealed
    program and the live (eager) engine's step: what the export's
    decompositions change."""
    out = []
    for eng in (runner, eager):
        step = eng._fns["prefill"].step
        caches = {u: {k: torch.zeros_like(t) for k, t in c.items()}
                  for u, c in eng._caches.items()}
        buf = torch.zeros_like(step.inputs["buf"])
        buf[0] = 7
        buf[L_MAX:L_MAX + eng.n_ptab] = torch.arange(eng.n_ptab)
        out.append(step.run(caches, {"buf": buf}, None)["logits"].float())
    return float((out[0] - out[1]).abs().max())


def _artifact_runner_checks(torch, r, load_s, live):
    """The bf16 artifact in this process: an ``ArtifactRunner`` captured
    at load, driven on this thread.  Plain decode, megastep and verify
    runs (one sampled row on the verify prompts) bitwise the runner's
    own plain decode; profiled windows of each program with the paged
    launches of each replay held to the trace; the forward program's
    flash launches; counters flat after load."""
    comp0 = dict(r.stats()["compile"])
    prompts = live["prompts"]
    kws = [{}] * SLOTS
    plain, s0, s1, wall = _driven_run(torch, r, prompts, NEW, kws,
                                      lambda e, i: e._step_once())
    plain_metrics = _engine_metrics(r, s0, s1, wall)
    mega, s0, s1, wall = _driven_run(torch, r, prompts, NEW, kws,
                                     lambda e, i: e._megastep_once())
    mega_metrics = _engine_metrics(r, s0, s1, wall)
    rng = np.random.default_rng(21)
    phrases = rng.integers(0, VOCAB, (SLOTS, SPEC_PHRASE))
    sp = np.stack([np.resize(p, SPEC_PROMPT) for p in phrases]
                  ).astype(np.int32)
    skw = [{}] * (SLOTS - 1) + [dict(temperature=0.8, top_k=50, seed=7)]
    sp_plain = _driven_run(torch, r, sp, SPEC_NEW, skw,
                           lambda e, i: e._step_once())[0]
    sp_ver, s0, s1, wall = _driven_run(torch, r, sp, SPEC_NEW, skw,
                                       _verify_always)
    window = np.random.default_rng(12).integers(
        0, VOCAB, (SLOTS, PROFILE_PROMPT)).astype(np.int32)
    windows = {
        "decode": _decode_window(torch, r, window,
                                 lambda e, i: e._step_once()),
        "megastep": _decode_window(torch, r, window,
                                   lambda e, i: e._megastep_once()),
        "verify": _decode_window(torch, r, window, _verify_always)}
    per_replay = {k: w["launch_trace"]["per_replay_by_kind"].get(k, {})
                  .get(PAGED_F32) for k, w in windows.items()}
    traces_ok = all(w["launch_trace"]["ok"] and w["launch_trace"]["captured"]
                    for w in windows.values())
    # the sealed forward in this process: the flash kernel's launches
    from veles_tpu_torch.ops.kernels import flash_attention
    f0 = flash_attention.launches.count
    x = torch.from_numpy(np.random.default_rng(5).integers(
        0, VOCAB, (PREDICT_B, PREDICT_T)).astype(np.int32)).to(DEVICE)
    logits = r.predict(r.wstate, {"@input": x})
    torch.cuda.synchronize()
    flash_launches = flash_attention.launches.count - f0
    eager = _serve_engine(live["wf"], live["ws"], capture=False)
    delta = _logit_delta(torch, r, eager)
    del eager
    st = r.stats()
    r.stop()
    rec = {"load_s": load_s, "programs": st["artifact"]["programs"],
           "compile_at_load": comp0, "compile_end": st["compile"],
           "tokens_equal_live": bool(np.array_equal(plain, live["greedy"])),
           "megastep_equal_plain": bool(np.array_equal(mega, plain)),
           "verify_equal_plain": bool(np.array_equal(sp_ver, sp_plain)),
           "decode": plain_metrics, "megastep": mega_metrics,
           "verify": {"wall_s": wall, "tokens_per_s_all_slots":
                      (s1["decode_tokens"] - s0["decode_tokens"]) / wall},
           "accepted": s1["spec"]["accepted"] - s0["spec"]["accepted"],
           "paged_per_replay": per_replay,
           "windows": {k: {"idle_share": w["device_idle_share"],
                           "replays": w["replays"]}
                       for k, w in windows.items()},
           "forward_flash_launches": flash_launches,
           "prefill_logit_max_abs_delta_vs_live": delta,
           "forward_finite": bool(torch.isfinite(logits.float()).all())}
    rec["ok"] = (rec["tokens_equal_live"] and rec["megastep_equal_plain"]
                 and rec["verify_equal_plain"] and traces_ok
                 and per_replay == {"decode": LAYERS,
                                    "megastep": LAYERS * MEGASTEP_N,
                                    "verify": LAYERS * (SPEC_K + 1)}
                 and comp0["captures"] == comp0["compiles"] == 7
                 and st["compile"]["compiles"] == comp0["compiles"]
                 and st["compile"]["recompiles"] == 0
                 and flash_launches == LAYERS and rec["forward_finite"])
    return rec


def _artifact_preempt(torch, runner, prompts):
    """A float32 runner's slot 0 preempted after ART_PREEMPT_AT decode
    steps and resumed (re-prefilled from prompt + its tokens so far):
    every row bitwise the same requests decoded without interruption."""
    kws = [{}] * SLOTS
    ref = _driven_run(torch, runner, prompts, NEW, kws,
                      lambda e, i: e._step_once())[0]

    def advance(e, i):
        if i == ART_PREEMPT_AT:
            e._preempt(0)
            e._admit()
            while e._chunking:
                e._advance_prefills()
        e._step_once()

    pre0 = runner.stats()["admission"]["preemptions"]
    got = _driven_run(torch, runner, prompts, NEW, kws, advance)[0]
    return {"preemptions": runner.stats()["admission"]["preemptions"] - pre0,
            "equal_uninterrupted": bool(np.array_equal(got, ref))}


def _artifact_swaps(torch, art_f32, sources, refs):
    """Hot swaps of a float32 ``ArtifactRunner`` (booted from
    ``art_f32``) under the lifecycle's load, from each of ``sources``:
    no request failed, nothing recaptured, the probe's tokens after each
    swap those of a live engine on the swapped weights (``refs``)."""
    from veles_tpu_torch.runtime.artifact import ArtifactRunner
    from veles_tpu_torch.runtime.deploy import DeployController
    from veles_tpu_torch.runtime.restful import RestfulServer
    rng = np.random.default_rng(33)
    load = rng.integers(0, VOCAB, (LIFE_THREADS, LIFE_PROMPT)).astype(
        np.int32)
    probe = rng.integers(0, VOCAB, (1, LIFE_PROMPT)).astype(np.int32)
    r = ArtifactRunner(art_f32, window_ms=2.0, device=DEVICE)
    srv = RestfulServer(r.predict, r.wstate, PREDICT_B, (PREDICT_T,),
                        port=0, engine=r, device=DEVICE)
    preempt = _artifact_preempt(torch, r, np.random.default_rng(34)
                                .integers(0, VOCAB, (SLOTS, F32_PROMPT))
                                .astype(np.int32))
    r.start()
    srv.start()
    DeployController(server=srv, boot_source=art_f32)
    swaps = []
    try:
        for name, source in sources:
            ref = refs[name](probe)
            s = _swap_under_load(r, srv.port, load, probe, source, ref)
            s["name"] = name
            swaps.append(s)
        st = r.stats()
    finally:
        srv.stop()
        r.stop()
    ok = preempt["preemptions"] == 1 and preempt["equal_uninterrupted"] \
        and st["compile"]["recompiles"] == 0 and all(
            s["status"] == 200 and s["failed"] == 0
            and s["captures"][0] == s["captures"][1]
            and s["tokens_equal_file_boot"] for s in swaps)
    return {"swaps": swaps, "preempt_f32": preempt,
            "compile": st["compile"], "ok": ok}


def _artifact_fleet(torch, child, ref_fn):
    """``--serve 0 --artifact ART --fleet 2``: greedy requests through the
    router equal ``generate()``'s, then a rolling drain under load
    (``POST /admin/rolling-drain``) reboots both replicas from the
    artifact with no request dropped."""
    import threading
    prompts = np.random.default_rng(35).integers(
        0, VOCAB, (4, F32_PROMPT)).astype(np.int32)
    banner = child.banner()
    port = banner["serving"]
    rec = {"boot_s": child.boot_s,
           "replicas": len(banner.get("replicas", []))}
    try:
        outs = _concurrent(lambda p: _http_json(port, "/generate", {
            "prompt": [p.tolist()], "steps": ART_FLEET_NEW}), list(prompts))
        rec["tokens_equal_generate"] = all(
            code == 200 and doc["tokens"] == ref_fn(p[None]).tolist()
            for (code, doc), p in zip(outs, prompts))
        codes, stop, lock = [], threading.Event(), threading.Lock()
        threads = [threading.Thread(target=_hammer, args=(
            port, prompts[i % len(prompts)][None], ART_FLEET_NEW, stop,
            codes, lock)) for i in range(FLEET_THREADS)]
        for t in threads:
            t.start()
        try:
            _wait(lambda: len(codes) >= FLEET_THREADS, 300, "load to flow")
            t0 = time.perf_counter()
            code = _http_json(port, "/admin/rolling-drain", {})[0]
            if code != 202:
                fail(f"POST /admin/rolling-drain answered {code}")

            def drained():
                d = _http_json(port, "/fleet.json")[1].get(
                    "last_rolling_drain") or {}
                return d if d.get("completed") is not None else None

            _wait(lambda: drained() is not None, 600, "the rolling drain")
            drain = drained()
            rec["drain_s"] = time.perf_counter() - t0
            n = len(codes)
            _wait(lambda: len(codes) >= n + FLEET_THREADS, 300,
                  "load after the drain")
        finally:
            stop.set()
            for t in threads:
                t.join(900)
        rec["rolling_drain"] = {
            "completed": drain["completed"], "requests": len(codes),
            "failed": sum(c != 200 for c in codes),
            "readmitted": [x.get("readmitted")
                           for x in drain.get("replicas", [])]}
    finally:
        rec["drain_status"], rec["exit"] = child.end()
    rec["ok"] = (rec["replicas"] == 2 and rec["tokens_equal_generate"]
                 and rec["rolling_drain"]["completed"]
                 and rec["rolling_drain"]["failed"] == 0
                 and rec["exit"] == 0)
    return rec


def _artifact_autotune(torch, work_dir):
    """AlexNet's two ``LRN(method="auto")`` units at the image phase's
    shape (IMG_B x 227 x 227 x 3): the first build measures the three
    formulations forward plus backward on the card and writes the DB (a
    fresh one under ``work_dir``), a second build reads it and measures
    nothing; then the second build's forward sealed as a forward-only
    artifact (mean/disp and the picked LRN inside), served by
    ``load_forward`` against the live predict."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.export.compiled import export_compiled
    from veles_tpu_torch.models import alexnet
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.ops.kernels import mean_disp
    from veles_tpu_torch.runtime import autotune
    from veles_tpu_torch.runtime.artifact import load_forward
    from veles_tpu_torch.runtime.benchmark import (device_kind,
                                                   load_device_infos)
    from veles_tpu_torch.units.base import Spec
    specs = {"@input": Spec((IMG_B, alexnet.INPUT_HW, alexnet.INPUT_HW, 3),
                            torch.uint8),
             "@labels": Spec((IMG_B,), torch.int32),
             "@mask": Spec((IMG_B,), torch.float32)}
    prev = (root.common.cache_dir, root.common.autotune)
    root.common.cache_dir = os.path.join(work_dir, "autotune_db")
    root.common.autotune = True
    measured = []
    real_measure = autotune.measure

    def counting(fn, args, *a, **kw):
        measured.append(1)
        return real_measure(fn, args, *a, **kw)

    try:
        autotune._memo.clear()
        builds = []
        with mock.patch.object(autotune, "measure", counting):
            for _ in range(2):
                n0 = len(measured)
                sw = StandardWorkflow(alexnet._e2e_config())
                sw.workflow.build(specs)
                t0 = time.perf_counter()
                ws = sw.workflow.init_state(0, device=DEVICE)
                torch.cuda.synchronize()
                builds.append({
                    "measured": len(measured) - n0,
                    "init_s": time.perf_counter() - t0,
                    "methods": [u.method for u in sw.workflow.units
                                if u.name.startswith("lrn")]})
                autotune._memo.clear()     # the second build: a new run
        db = load_device_infos()[device_kind(DEVICE)]["autotune"]
        art = os.path.join(work_dir, "alexnet_forward")
        t0 = time.perf_counter()
        man = export_compiled(sw.workflow, ws, art)
        export_s = time.perf_counter() - t0
    finally:
        root.common.cache_dir, root.common.autotune = prev
    predict, aws, _ = load_forward(art, device=DEVICE)
    x = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, tuple(specs["@input"].shape)).astype(np.uint8)).to(DEVICE)
    m0 = mean_disp.launches.count
    got = predict(aws, {"@input": x})
    torch.cuda.synchronize()
    md = mean_disp.launches.count - m0
    ref = sw.workflow.make_predict_step("fc8")(ws, {"@input": x})
    err = float((got.float() - ref.float()).abs().max())
    rec = {"shape": list(specs["@input"].shape), "builds": builds,
           "db": db, "forward_export_s": export_s,
           "decode_unsupported": man.get("decode_unsupported"),
           "forward_mean_disp_launches": md, "forward_max_abs_err": err}
    rec["ok"] = (builds[0]["measured"] > 0 and builds[1]["measured"] == 0
                 and builds[0]["methods"] == builds[1]["methods"]
                 and "auto" not in builds[0]["methods"] and len(db) >= 1
                 and md == 1 and err <= FLASH_TOL["bfloat16"])
    return rec


def export_artifacts(work_dir):
    """The artifact phase's two exports, run in a child process the
    script starts after the build (:class:`_ArtifactExport`) so that the
    host work of tracing and saving overlaps the earlier phases: the
    serving phase's bf16 LM (seed 0; megastep MEGASTEP_N, spec k SPEC_K,
    the paged kernel) and the float32 LM (seed 1; decode and prefill
    alone) under ``work_dir``.  Prints one JSON line: each export's
    seconds, programs and blob sizes."""
    import torch
    from veles_tpu_torch.export.compiled import export_compiled
    out = {"torch": torch.__version__}
    for tag, dtype, seed, kw in (
            ("bf16", "bfloat16", 0, dict(megastep=MEGASTEP_N, spec=True,
                                         spec_k=SPEC_K)),
            ("f32", None, 1, dict(megastep=1, spec=False))):
        wf, ws = _bench_state(torch, dtype, seed)
        art = os.path.join(work_dir, f"bench_lm_{tag}")
        t0 = time.perf_counter()
        man = export_compiled(wf, ws, art, slots=SLOTS, l_max=L_MAX,
                              page_size=PAGE, paged=True, paged_kernel=True,
                              **kw)
        out[tag] = {"dir": art, "seconds": time.perf_counter() - t0,
                    "programs": sorted(man["programs"]),
                    "decode_unsupported": man.get("decode_unsupported"),
                    "blob_bytes": {
                        os.path.relpath(os.path.join(dp, f), art):
                        os.path.getsize(os.path.join(dp, f))
                        for dp, _, fs in os.walk(art) for f in fs}}
        del ws
    print(json.dumps(out), flush=True)


class _ArtifactExport:
    """:func:`export_artifacts` in a child process, started at once and
    waited for by the artifact phase; killed at exit if the script fails
    before then."""

    def __init__(self, work_dir):
        import atexit
        import tempfile
        here = os.path.dirname(os.path.abspath(__file__))
        self.err = tempfile.TemporaryFile("w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.export_artifacts({work_dir!r})"],
            cwd=here, stdout=subprocess.PIPE, stderr=self.err, text=True)
        atexit.register(self.kill)

    def wait(self):
        """The child's record, and the seconds the parent waited for it."""
        t0 = time.perf_counter()
        try:
            out, _ = self.proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            self.kill()
            fail("the artifact export child ran past 900 s")
        waited = time.perf_counter() - t0
        if self.proc.returncode != 0:
            self.err.seek(0)
            fail(f"the artifact export child exited "
                 f"{self.proc.returncode}: {self.err.read()[-3000:]}")
        rec = json.loads(out.strip().splitlines()[-1])
        rec["child_wall_s"] = time.perf_counter() - self.t0
        rec["parent_waited_s"] = waited
        self.err.close()
        return rec

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(60)


def _custom_op_host_cost(torch):
    """Host microseconds of one call of each export-path kernel through
    its wrapper and custom op against one direct launch of the kernel
    (``_launch``), at shapes whose device work is below the host's (so
    the loop measures the host), in turns op, direct, direct, op: the
    dispatcher's cost per eager call, which a graph replay does not
    pay."""
    from veles_tpu_torch.ops.kernels import flash_attention as fa
    from veles_tpu_torch.ops.kernels import mean_disp as md
    from veles_tpu_torch.ops.kernels import paged_attention as pa
    dev, Dh = DEVICE, E // HEADS
    n_ptab = 4
    q = torch.randn(SLOTS, HEADS, Dh, device=dev)
    kp = torch.randn(SLOTS * n_ptab + 1, PAGE, HEADS, Dh, device=dev)
    vp = torch.randn_like(kp)
    ptab = torch.arange(SLOTS * n_ptab, dtype=torch.int32,
                        device=dev).view(SLOTS, n_ptab)
    pos = torch.full((SLOTS,), 40, dtype=torch.int32, device=dev)
    qf, kf, vf = (torch.randn(1, 128, HEADS, Dh, device=dev,
                              dtype=torch.bfloat16) for _ in range(3))
    x = torch.randint(0, 256, (4, 32, 32, 3), dtype=torch.uint8, device=dev)
    mean = torch.rand(32, 32, 3, device=dev)
    rdisp = torch.rand(32, 32, 3, device=dev)
    cases = {
        pa.NAME: (lambda: pa.paged_attention_decode(
            q, kp, vp, ptab, pos, page_size=PAGE, n_kv_heads=HEADS),
            lambda: pa._launch(q, kp, vp, ptab, pos, 1, PAGE, Dh ** -0.5,
                               None)),
        fa.NAME: (lambda: fa.flash_attention(qf, kf, vf, True),
                  lambda: fa._launch(qf, kf, vf, True, Dh ** -0.5, None)),
        md.NAME: (lambda: md.mean_disp_normalize(x, mean, rdisp),
                  lambda: md._launch(x, mean, rdisp))}
    out = {}
    for name, (op, direct) in cases.items():
        us = {"op": [], "direct": []}
        for label, fn in (("op", op), ("direct", direct),
                          ("direct", direct), ("op", op)):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(500):
                fn()
            us[label].append((time.perf_counter() - t0) / 500 * 1e6)
            torch.cuda.synchronize()
        out[name] = {"op_us": us["op"], "direct_us": us["direct"],
                     "op_cost_us": min(us["op"]) - min(us["direct"])}
    return out


def phase_artifact(torch, live, work_dir, exporter):
    """The compiled artifact at the serving phase's full width (see the
    module docstring, phase 13).  The two exports ran in ``exporter``'s
    child beside the earlier phases; the CLI children boot while this
    process loads (their loads are host work); the timed request runs
    once both have booted."""
    from veles_tpu_torch.export.package import export_package
    from veles_tpu_torch.forge.store import ForgeStore
    from veles_tpu_torch.ops.kernels import flash_attention, paged_attention
    from veles_tpu_torch.runtime.artifact import ArtifactRunner, read_manifest
    from veles_tpu_torch.runtime.generate import generate
    laps = {}
    t_lap = time.perf_counter()

    def lap(name):
        nonlocal t_lap
        now = time.perf_counter()
        laps[name] = now - t_lap
        t_lap = now

    # 1. the exports (the child's): bf16 (megastep, spec, forward) and
    # float32
    exp = exporter.wait()
    say({"phase": "artifact_export", **exp})
    art, art32 = exp["bf16"]["dir"], exp["f32"]["dir"]
    man = read_manifest(art)
    if man.get("decode_unsupported") or len(man["programs"]) != 8 \
            or len(exp["f32"]["programs"]) != 4:
        fail(f"the exports sealed {sorted(man['programs'])} / "
             f"{exp['f32']['programs']}: {man.get('decode_unsupported')}")
    wf, ws = _artifact_state(torch, "bfloat16", 0)
    children = [_ArtifactChild(art)]
    try:
        # the live predict the sealed forward is held to
        row = np.random.default_rng(7).integers(
            0, VOCAB, (1, PREDICT_T)).astype(np.int32)
        batch = np.zeros((PREDICT_B, PREDICT_T), np.int32)
        batch[:1] = row
        live_pred = wf.make_predict_step()(ws, {"@input": torch.from_numpy(
            batch).to(DEVICE)})[:1].float().cpu().numpy()
        live = dict(live, wf=wf, ws=ws)
        wf32, ws1 = _artifact_state(torch, None, 1)
        children.append(_ArtifactChild(art32, "--fleet", "2"))
        lap("export")
        # 2. the bf16 runner in this process, loaded while the children
        # boot
        t0 = time.perf_counter()
        runner = ArtifactRunner(art, window_ms=2.0, device=DEVICE)
        load_s = time.perf_counter() - t0
        for c in children:
            c.banner()
        lap("load")
        # 3. the CLI child: greedy and /predict, both children idle
        child = _artifact_child_serving(torch, children[0], live,
                                        {"row": row, "live": live_pred})
        say({"phase": "artifact_child", **child})
        lap("child")
        if not (child["tokens_equal_live"] and child["exit"] == 0
                and child["compile"]["recompiles"] == 0
                and child["compile"]["captures"]
                == child["compile"]["compiles"]
                and child["predict_max_abs_err"] <= FLASH_TOL["bfloat16"]):
            fail(f"the artifact CLI child failed its checks: {child}")
        # 4. the runner: megastep, verify, launches, forward
        _reset_counts()
        checks = _artifact_runner_checks(torch, runner, load_s, live)
        launches = {k.NAME: k.launches.count
                    for k in (flash_attention, paged_attention)}
        del runner, live, ws
        say({"phase": "artifact_runner", **checks, "launches": launches})
        lap("runner")
        if not checks["ok"]:
            fail(f"the artifact runner failed its checks: {checks}")
        # 5. float32 swaps from a second artifact, a package and a forge
        # store
        wf2, ws2 = _artifact_state(torch, None, 2)
        pkg = os.path.join(work_dir, "bench_lm_pkg")
        export_package(wf2, ws2, pkg)
        wf3, ws3 = _artifact_state(torch, None, 3)
        pkg3 = os.path.join(work_dir, "bench_lm_pkg3")
        export_package(wf3, ws3, pkg3)
        store = os.path.join(work_dir, "forge")
        ForgeStore(store).add(ForgeStore.pack_dir(pkg3, {
            "name": "bench_lm", "workflow": "contents.json",
            "configuration": "contents.json", "author": "chip_smoke",
            "short_description": "the bench LM, seed 3"}))
        _, ws0 = _artifact_state(torch, None, 0)

        def live_ref(w):
            def ref(probe):
                eng = _serve_engine(wf32, w, capture=False).start()
                try:
                    return eng.generate(probe, LIFE_NEW, timeout=900)
                finally:
                    eng.stop()
            return ref

        swaps = _artifact_swaps(torch, art32, [
            ("artifact", "artifact://" + art), ("package", pkg),
            ("forge", f"forge://{store}/bench_lm")],
            {"artifact": live_ref(ws0), "package": live_ref(ws2),
             "forge": live_ref(ws3)})
        say({"phase": "artifact_swaps", **swaps})
        lap("swaps")
        if not swaps["ok"]:
            fail(f"the artifact swaps failed their checks: {swaps}")
        del ws0, ws2, ws3
        # 6. the --fleet 2 CLI over the float32 artifact
        fleet = _artifact_fleet(torch, children[1], lambda p: generate(
            wf32, ws1, p, ART_FLEET_NEW).cpu().numpy())
        say({"phase": "artifact_fleet", **fleet})
        lap("fleet")
        if not fleet["ok"]:
            fail(f"the artifact fleet failed its checks: {fleet}")
    finally:
        for c in children:
            c.kill()
    say({"phase": "artifact_custom_op_host_cost",
         **_custom_op_host_cost(torch)})
    # 7. autotune: AlexNet's LRN units measured once, then read
    tune = _artifact_autotune(torch, work_dir)
    launches["mean_disp_normalize"] = tune["forward_mean_disp_launches"]
    say({"phase": "artifact_autotune", **tune})
    lap("autotune")
    if not tune["ok"]:
        fail(f"the LRN autotune failed its checks: {tune}")
    say({"phase": "artifact_laps", **laps})
    return launches

def main():
    here = os.path.dirname(os.path.abspath(__file__))
    # before torch loads kineto: the profiled windows read its log
    os.environ.setdefault("KINETO_LOG_LEVEL", KINETO_LOG_LEVEL)
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
    os.environ.setdefault("VELES_TORCH_CACHE", os.path.join(
        here, ".veles_tpu", "cache"))
    # the GEMM calibration DB the MFU reads, where the CLI runs (cwd here)
    # find it too
    from veles_tpu_torch.config import root
    root.common.cache_dir = os.path.join(here, ".veles_tpu")

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[phase] = time.perf_counter() - t0
        return out

    name, smi = timed("device", phase_device, torch)
    timed("build", phase_build)
    import tempfile
    # the artifact phase's exports: host work in a child, beside the
    # phases up to it
    a_tmp = tempfile.TemporaryDirectory(prefix="vt_artifact_")
    exporter = _ArtifactExport(a_tmp.name)
    timing = timed("kernels", phase_kernels, torch)
    timing.update(timed("train_kernels", phase_train_kernels, torch))
    timing.update(timed("image_kernels", phase_image_kernels, torch))
    timed("device_benchmark", phase_device_benchmark, torch)
    serve_launches, live = timed("serving", phase_main_path, torch)
    bf16_launches = timed("serving_bf16_cache", phase_bf16_cache, torch)
    f16_launches = timed("serving_f16_cache", phase_f16_cache, torch)
    with tempfile.TemporaryDirectory(prefix="vt_lifecycle_") as snap_dir:
        timed("serving_lifecycle", phase_lifecycle, torch, snap_dir)
    rec_serve = timed("recurrent_serving", phase_recurrent_serving, torch)
    train_launches, lm_f32 = timed("train", phase_train, torch)
    timing.update(lm_f32["timing"])
    rec_train = timed("recurrent_train", phase_recurrent_train, torch)
    image_launches, image_rec = timed("image", phase_image, torch)
    host = timed("image_host", phase_image_host, torch, image_rec)
    cur = timed("curriculum_kernels", phase_curriculum_kernels, torch)
    timing.update(cur["timing"])
    # the image family's 70k SynthDigits render on the host (numpy, one
    # core) while the curriculum's phases run, into the cache the family
    # phase and its CLI run then read
    synth = _DigitsSynthesis()
    try:
        with tempfile.TemporaryDirectory(prefix="vt_curriculum_") as cur_dir:
            best = timed("curriculum", phase_curriculum, torch, cur_dir)
            timed("generate_cli", phase_generate_cli, torch, best, cur_dir)
    finally:
        say({"phase": "digits_synthesis", **synth.wait()})
    family = timed("image_family", phase_image_family, torch)
    timing.update(family["timing"])
    timed("image_quality", phase_image_quality, torch)
    timed("image_ae", phase_image_ae, torch)
    with tempfile.TemporaryDirectory(prefix="vt_quality_") as q_dir:
        best = timed("quality", phase_quality, torch, q_dir)
        with tempfile.TemporaryDirectory(prefix="vt_fleet_") as f_dir:
            fleet_launches = timed("fleet", phase_fleet, torch, best, f_dir)
    pp = timed("pipeline_train", phase_pipeline_train, torch)
    timing.update(pp["timing"])
    timed("distributed_one_rank", phase_distributed_one_rank, torch)
    moe = timed("moe_serving", phase_moe_serving, torch)
    # last: the artifact phase's runners, children and loaded programs
    # stay out of every earlier phase's profiled windows
    with a_tmp as a_dir:
        art_launches = timed("artifact", phase_artifact, torch, live, a_dir,
                             exporter)
    timing["paged_attention_decode/moe_serving"] = moe["timing"]
    # each kernel's launches on its own path: paged decode on the serving
    # path, dropout and mean/disp on the image path, the rest on the LM
    # training path (flash forward runs on both LM paths, the gather on
    # both training paths; the other counts are in the phase lines)
    launches = dict(train_launches)
    # the full-width LM in float32: the f32 flash kernels over its
    # witness's captured steps
    launches.update(lm_f32["launches"])
    launches["paged_attention_decode"] = serve_launches[
        "paged_attention_decode"]
    for kname in IMG_MIN_LAUNCHES:
        launches[kname] = image_launches[kname]
    # the paged kernel's bf16- and f16-pool variants: their launches on
    # their cache phases' engines
    launches["paged_attention_decode/bf16_pool"] = bf16_launches[
        "bf16_pool"]
    launches["paged_attention_decode/f16_pool"] = f16_launches["f16_pool"]
    # this slice's path, the image/conv family: the dropout (seed on the
    # card) and the batch gather over its epoch and eval
    for kname in ("fused_dropout", "gather_rows"):
        launches[kname + "/synthdigits_conv"] = family["launches"][kname]
    # the curriculum: the f32 flash kernels and the batch gather over one
    # captured epoch of its LM64 trainer
    launches.update(cur["launches"])
    # this slice's paths: paged decode on the mixed attention + GRU
    # chain's engines (the serving shape the kernel was timed at), the
    # batch gather over the GRU+LSTM LM's epochs (timed at its loader's
    # shape), mean/disp on the host image path (AlexNet's norm0 shape)
    launches["paged_attention_decode/recurrent_serving"] = rec_serve[
        "paged_attention_decode"]
    timing["paged_attention_decode/recurrent_serving"] = {
        **timing["paged_attention_decode"], "path": "recurrent_serving"}
    launches["gather_rows/recurrent_train"] = rec_train["launches"]
    timing["gather_rows/recurrent_train"] = rec_train["timing"]
    launches["mean_disp_normalize/image_host"] = host["launches"]
    # this slice's paths: the f32 flash kernels, the stage dropouts and
    # the batch gather over induction_lm_pp_moe's counted epoch, paged
    # decode on the MoE chain's engines
    launches.update(pp["launches"])
    launches["paged_attention_decode/moe_serving"] = moe[
        "paged_attention_decode"]
    # this slice's path: paged decode on the fleet's replica engines (the
    # serving shape the kernel was timed at)
    launches["paged_attention_decode/fleet"] = fleet_launches["f32_pool"]
    timing["paged_attention_decode/fleet"] = {
        **timing["paged_attention_decode"], "path": "fleet"}
    timing["mean_disp_normalize/image_host"] = {
        **timing["mean_disp_normalize"], "path": "image_host"}
    # this slice's path: the sealed programs of the compiled artifact
    # (paged decode in the runner's decode, megastep and verify replays,
    # the flash forward in its forward program, mean/disp in AlexNet's)
    for kname, n in art_launches.items():
        launches[kname + "/artifact"] = n
        timing[kname + "/artifact"] = {**timing[kname], "path": "artifact"}
    line = []
    for kern in KERNELS:
        names = [kern.NAME] + [k for k in timing
                               if k.startswith(kern.NAME + "/")]
        for tname in names:
            t = timing[tname]
            extra = {k: t[k] for k in ("variant", "path") if k in t}
            line.append({"name": kern.NAME, "route": "cuda",
                         "source": t.get("source", kern.SOURCE),
                         "replaces": kern.REPLACES, **extra,
                         "launches": launches[tname],
                         "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                         "plain_ms": t["plain_ms"],
                         "bound_ms": t["bound_ms"],
                         "bound_by": t["bound_by"],
                         "library_ms": t["library_ms"]})
    import threading
    say({"phase": "done", "seconds": time.perf_counter() - t_start,
         "by_phase": seconds,
         "threads_left": sorted(t.name for t in threading.enumerate())})
    say({"kernels": line})
    say(smi)
    say({"ok": True, "device": {"platform": "gpu", "kind": name,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # out without the interpreter's teardown: a daemon thread still inside
    # a torch call at finalization aborted a run on the H100 ("terminate
    # called without an active exception") after every check had passed
    os._exit(code)
