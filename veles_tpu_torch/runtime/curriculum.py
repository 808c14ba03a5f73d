"""Snapshot-phased curriculum runner — chained CLI training phases
(a copy of veles_tpu/runtime/curriculum.py, which holds no JAX; each
phase is a ``python -m veles_tpu_torch`` run on the caller's device).

Productizes the pattern that cleared the hard induction bar
(configs/induction_lm64_curriculum.sh, BASELINE.md): train in phases,
each an ordinary CLI run with its own config overrides and seeds, each
restoring from the BEST snapshot any earlier phase produced. The
reference's closest machinery is the rollback-to-best + lr-drop policy
(Znicz docs manualrst_veles_algorithms.rst:164, here
runtime/decision.py); a curriculum generalizes it across runs: fresh
data/mixture/lr per phase while weights carry forward.

Spec file (JSON)::

    {
      "common": ["loader.n_train=2000"],        # overrides for every phase
      "phases": [
        {"overrides": ["loader.repeat_fraction=1.0",
                       "workflow.max_epochs=170"],
         "random_seed": 1},
        {"repeat": 5,                            # expand to 5 phases
         "overrides": ["workflow.max_epochs={budget}",
                       "workflow.optimizer_args.lr=0.0003",
                       "loader.data_seed={1000+i}"],
         "epochs_increment": 150,                # {budget} += this/phase
         "random_seed": "{i}"}
      ]
    }

Placeholders inside override strings / random_seed: ``{i}`` = 1-based
phase index, ``{budget}`` = a running epoch budget that starts at the
first phase's ``workflow.max_epochs`` and grows by ``epochs_increment``
per expanded phase, and ``{N+i}`` = integer N plus the phase index.
"""

from __future__ import annotations

import glob
import json
import os
import re
import time
from typing import List, Optional, Sequence

from ..logger import Logger


class CurriculumError(RuntimeError):
    pass


def _subst(text: str, i: int, budget: int) -> str:
    def repl(m):
        expr = m.group(1)
        if expr == "i":
            return str(i)
        if expr == "budget":
            return str(budget)
        mm = re.fullmatch(r"(\d+)\+i", expr)
        if mm:
            return str(int(mm.group(1)) + i)
        raise CurriculumError(f"unknown curriculum placeholder {{{expr}}}")
    return re.sub(r"\{([^}]+)\}", repl, text)


def expand_phases(spec: dict) -> List[dict]:
    """Resolve repeats and placeholders into a flat phase list."""
    if not spec.get("phases"):
        raise CurriculumError("curriculum spec has no phases")
    budget = 0
    for ov in spec["phases"][0].get("overrides", []):
        m = re.fullmatch(r"workflow\.max_epochs=(\d+)", ov)
        if m:
            budget = int(m.group(1))
    out = []
    i = 0
    for phase in spec.get("phases", []):
        for _ in range(int(phase.get("repeat", 1))):
            i += 1
            budget += int(phase.get("epochs_increment", 0))
            ovs = [_subst(o, i, budget)
                   for o in (list(spec.get("common", []))
                             + list(phase.get("overrides", [])))]
            seed = phase.get("random_seed")
            if isinstance(seed, str):
                seed = int(_subst(seed, i, budget))
            out.append({"index": i, "overrides": ovs,
                        "random_seed": seed})
    if not out:
        raise CurriculumError("curriculum spec has no phases")
    return out


class CurriculumRunner(Logger):
    """Run phases serially via ``python -m veles_tpu_torch`` subprocesses
    (fresh interpreter state per phase, exactly like the hand-driven
    flow), threading the best snapshot forward."""

    def __init__(self, config: str, spec: dict, out_dir: str,
                 extra_argv: Sequence[str] = (), bar: Optional[float] = None,
                 initial_snapshot: Optional[str] = None,
                 default_seed: Optional[int] = None):
        self.config = config
        self.spec = spec
        self.out_dir = out_dir
        self.extra_argv = list(extra_argv)
        # optional early stop: best_value <= bar ends the curriculum
        self.bar = bar if bar is not None else spec.get("bar")
        # warm start: --snapshot seeds phase 1 (then per-phase bests)
        self.initial_snapshot = initial_snapshot
        # --random-seed forwarded to phases whose spec sets none
        self.default_seed = default_seed

    def _best_snapshot(self, phase_dir: str) -> Optional[str]:
        hits = glob.glob(os.path.join(phase_dir, "*_best.json"))
        if not hits:
            return None
        if len(hits) > 1:
            # a phase dir normally holds exactly one best snapshot; take
            # the newest and say so rather than an alphabetical accident
            hits.sort(key=os.path.getmtime)
            self.warning("phase dir %s holds %d *_best.json files; "
                         "using newest %s", phase_dir, len(hits),
                         os.path.basename(hits[-1]))
        return hits[-1]

    def run(self) -> dict:
        from ..parallel.pool import CliRunner
        os.makedirs(self.out_dir, exist_ok=True)
        phases = expand_phases(self.spec)
        # Serial phases: no card contention, so DON'T pin subprocesses
        # to the CPU — they use the card (or an explicit --device in
        # extra_argv).
        runner = CliRunner(n_workers=1, pin_cpu=False)
        best = None          # (value, phase index) — drives the bar
        best_snapshot = self.initial_snapshot
        best_snapshot_phase = None  # phase that wrote best_snapshot
        results = []
        for ph in phases:
            i = ph["index"]
            pdir = os.path.join(self.out_dir, f"p{i}")
            argv = [self.config, *ph["overrides"], *self.extra_argv,
                    "--snapshot-dir", pdir]
            seed = (ph["random_seed"] if ph["random_seed"] is not None
                    else self.default_seed)
            if seed is not None:
                argv += ["--random-seed", str(seed)]
            if best_snapshot:
                argv += ["--snapshot", best_snapshot]
            self.info("curriculum phase %d/%d%s: %s", i, len(phases),
                      f" (restore {best_snapshot})" if best_snapshot
                      else "", " ".join(argv))
            t0 = time.monotonic()
            res = runner.run_jobs([argv])[0]
            if "error" in res:
                raise CurriculumError(
                    f"phase {i} failed: {res['error']}")
            # the phase's wall (its process start-up included), its
            # training wall, median train step and the snapshot it
            # started from beside the reference's keys
            results.append({"phase": i, **{k: res[k] for k in
                            ("best_value", "best_epoch", "epochs",
                             "elapsed_s", "train_step_s_median")
                            if k in res},
                            "wall_s": time.monotonic() - t0,
                            "restored_from": best_snapshot})
            val = res.get("best_value")
            snap = self._best_snapshot(pdir)
            if val is not None and (best is None or val < best[0]):
                best = (val, i)
                if snap:
                    best_snapshot = snap
                    best_snapshot_phase = i
                else:
                    # value and snapshot advance atomically; a phase that
                    # improved the value but wrote no snapshot must not
                    # let the summary pair its value with an older,
                    # worse phase's snapshot silently
                    self.warning(
                        "phase %d improved best_value to %.4g but wrote "
                        "no *_best.json; best_snapshot stays at %s",
                        i, val,
                        f"phase {best_snapshot_phase}"
                        if best_snapshot_phase is not None
                        else (f"the initial snapshot {best_snapshot}"
                              if best_snapshot else "none"))
            elif best_snapshot is None and snap:
                best_snapshot = snap
                best_snapshot_phase = i
            if (self.bar is not None and best is not None
                    and best[0] <= float(self.bar)):
                self.info("bar %.4g reached at phase %d (%.4g) — stop",
                          float(self.bar), i, best[0])
                break
        summary = {
            "metric": "curriculum_best_value",
            "value": best[0] if best else None,
            "best_phase": best[1] if best else None,
            "phases_run": len(results),
            "phases": results,
            "best_snapshot": best_snapshot,
            "best_snapshot_phase": best_snapshot_phase,
        }
        with open(os.path.join(self.out_dir, "curriculum.json"),
                  "w") as f:
            json.dump(summary, f, indent=1)
        return summary
