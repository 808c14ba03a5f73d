"""Decode-serving A/B between checkouts of this repo, on one card.

    python3 serving_ab.py DIR [DIR ...] [--windows N]

Each DIR is a checkout of the repo (its root, or another commit unpacked
with ``git archive`` into a directory ``.gitignore`` lists).  For each
DIR, in the order given (parent, change, change, parent puts both on
the card twice), a fresh process imports that checkout's
``veles_tpu_torch`` and ``chip_smoke``, builds its kernels, boots the
main path's engine (``chip_smoke._workflow`` in bf16 with seeded
weights; SLOTS slots, paged, captured) and, after one warm-up request,
serves N windows of SLOTS prompts of PROMPT tokens with NEW decoded
(chip_smoke's constants: 8 x (512 + 64)).  It prints one JSON line a
checkout: decode tokens/s over all slots and the decode step's p50 (the
engine's own step times), each window's and their medians, then the
card's name and power limit.  Needs a CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def one(tree: str, windows: int) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import chip_smoke as cs
    import veles_tpu_torch
    from veles_tpu_torch.runtime.engine import DecodeEngine
    from veles_tpu_torch.runtime.snapshotter import params_from_jax
    from veles_tpu_torch.units.workflow import new_state

    cs.phase_build()
    wf = cs._workflow(torch, "bfloat16")
    flat = cs.jax_layout_weights(wf, seed=0)
    wstate = new_state(params_from_jax(flat, wf, device="cuda"), {}, {}, 0,
                       None)
    engine = DecodeEngine(wf, wstate, slots=cs.SLOTS, l_max=cs.L_MAX,
                          page_size=cs.PAGE, paged=True, paged_kernel=True,
                          window_ms=2.0, device="cuda").start()
    rng = np.random.default_rng(1)
    tps, p50 = [], []
    try:
        engine.generate(rng.integers(0, cs.VOCAB, (cs.SLOTS, cs.PROMPT))
                        .astype(np.int32), cs.NEW, timeout=900)
        for _ in range(windows):
            prompts = rng.integers(0, cs.VOCAB, (cs.SLOTS, cs.PROMPT)) \
                .astype(np.int32)
            s0 = engine.stats()
            reqs = [engine.submit(p, cs.NEW) for p in prompts]
            for r in reqs:
                if not r.done.wait(900) or r.error is not None:
                    raise RuntimeError(f"a request failed: {r.error}")
            s1 = engine.stats()
            decode_s = s1["decode_seconds"] - s0["decode_seconds"]
            tps.append((s1["decode_tokens"] - s0["decode_tokens"])
                       / decode_s)
            p50.append(float(np.median(cs._step_times(engine, s0, s1))))
    finally:
        engine.stop()
    return {"tree": tree, "package": veles_tpu_torch.__file__,
            "windows": windows,
            "decode_tokens_per_s": tps,
            "decode_tokens_per_s_median": float(np.median(tps)),
            "decode_step_s_p50": p50,
            "decode_step_s_p50_median": float(np.median(p50))}


def main(argv) -> int:
    windows = 5
    if "--windows" in argv:
        i = argv.index("--windows")
        windows = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1], windows)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available() or not argv:
        print("usage: serving_ab.py DIR [DIR ...] [--windows N] (needs a "
              "CUDA card)", file=sys.stderr)
        return 2
    rc = 0
    for tree in map(os.path.abspath, argv):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", tree, "--windows", str(windows)],
                           cwd=tree, capture_output=True, text=True)
        line = r.stdout.strip().splitlines()[-1:] or [""]
        print(line[0] if r.returncode == 0 else json.dumps(
            {"tree": tree, "returncode": r.returncode,
             "stderr": r.stderr[-2000:]}), flush=True)
        rc = rc or r.returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
