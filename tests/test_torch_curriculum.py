"""The port's ``--curriculum`` against the contracts of
tests/test_curriculum.py:33,55,66,83: phases chain the best snapshot,
the bar stops early, placeholder expansion equals the JAX package's
``expand_phases`` on the same specs, and ``--snapshot`` warm-starts
phase 1 while ``--random-seed`` reaches phases whose spec sets none.
Each phase is a ``python -m veles_tpu_torch ... --device cpu``
subprocess at ``loader.n_train=40``, 1-2 epochs."""

import glob
import json
import logging
import os
import zipfile

import pytest

torch = pytest.importorskip("torch")

from veles_tpu.runtime.curriculum import \
    expand_phases as jax_expand_phases  # noqa: E402
from veles_tpu_torch.__main__ import main as port_main  # noqa: E402
from veles_tpu_torch.parallel.pool import CliRunner, ParallelMap  # noqa: E402
from veles_tpu_torch.runtime.curriculum import (CurriculumError,  # noqa: E402
                                                expand_phases)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: configs/induction_lm64.json narrowed (one block, dim 16, T 8)
LM = {"workflow": {
    "name": "CurLM",
    "layers": [
        {"type": "embedding", "vocab": 8, "dim": 16, "name": "emb"},
        {"type": "attention", "n_heads": 2, "rope": True,
         "residual": True, "name": "attn1"},
        {"type": "all2all", "output_size": 8, "per_position": True,
         "name": "out"}],
    "loss": "softmax", "optimizer": "adam",
    "optimizer_args": {"lr": 0.01}, "max_epochs": 1},
    "loader": {"name": "induction", "minibatch_size": 20, "seq_len": 8,
               "vocab": 8, "per_position": True, "n_train": 40,
               "n_valid": 20}}


@pytest.fixture
def config_file(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    p = tmp_path / "lm.json"
    p.write_text(json.dumps(LM))
    return str(p)


def write_spec(tmp_path, **kw):
    spec = {"common": ["loader.n_train=40"],
            "phases": [
                {"overrides": ["workflow.max_epochs=1"], "random_seed": 1},
                {"overrides": ["workflow.max_epochs=2",
                               "workflow.optimizer_args.lr={1+i}e-3",
                               "loader.data_seed={100+i}"],
                 "random_seed": "{i}"}]}
    spec.update(kw)
    p = tmp_path / "spec.json"
    p.write_text(json.dumps(spec))
    return str(p)


def _curriculum(cfg, spec, out, *extra):
    res = os.path.join(os.path.dirname(out), os.path.basename(out)
                       + ".json")
    assert port_main([cfg, "--curriculum", spec, "--curriculum-out", out,
                      "--result-file", res, "--device", "cpu",
                      *extra]) == 0
    with open(res) as f:
        return json.load(f)


def test_curriculum_runs_phases_and_chains_best(tmp_path, config_file,
                                                capsys, caplog):
    spec = write_spec(tmp_path)
    out = tmp_path / "cur"
    with caplog.at_level(logging.INFO):
        # overrides beside the spec reach every phase
        summary = _curriculum(config_file, spec, str(out),
                              "root.common.snapshot_keep=2")
    assert summary["phases_run"] == 2
    assert summary["value"] is not None and summary["value"] < 100.0
    assert summary["best_snapshot"] \
        and os.path.exists(summary["best_snapshot"])
    assert (out / "p1").is_dir()
    disk = json.loads((out / "curriculum.json").read_text())
    assert disk == summary
    first, second = disk["phases"]
    assert first["phase"] == 1 and second["phase"] == 2
    # phase 2 resumes phase 1's best snapshot: its epoch count goes on
    assert first["epochs"] == 1 and second["epochs"] == 2
    for ph in disk["phases"]:
        assert ph["wall_s"] > 0 and ph["train_step_s_median"] > 0
    log = caplog.text
    assert f"restore {out / 'p1'}" in log
    assert "loader.data_seed=102" in log and "--random-seed 2" in log
    assert log.count("root.common.snapshot_keep=2") == 2
    # the CLI stores its snapshots, not deflated
    for npz in glob.glob(str(out / "p*" / "*.npz")):
        with zipfile.ZipFile(npz) as z:
            assert {i.compress_type for i in z.infolist()} \
                == {zipfile.ZIP_STORED}
    tail = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tail["metric"] == "curriculum_best_value"
    assert "phases" not in tail


def test_curriculum_bar_stops_early(tmp_path, config_file):
    spec = write_spec(tmp_path, bar=100.0)  # any result clears it
    summary = _curriculum(config_file, spec, str(tmp_path / "cur2"))
    assert summary["phases_run"] == 1


@pytest.mark.parametrize("spec", [
    {"phases": [
        {"overrides": ["workflow.max_epochs=10"], "random_seed": 1},
        {"repeat": 3, "epochs_increment": 5,
         "overrides": ["workflow.max_epochs={budget}", "x.seed={100+i}"],
         "random_seed": "{i}"}]},
    "configs/induction_lm64_curriculum.json",
], ids=["reference_test_spec", "published_spec"])
def test_curriculum_placeholder_expansion_equals_jax(spec):
    if isinstance(spec, str):
        with open(os.path.join(REPO, spec)) as f:
            spec = json.load(f)
    ph = expand_phases(spec)
    assert ph == jax_expand_phases(spec)
    assert [p["index"] for p in ph] == list(range(1, len(ph) + 1))
    if "bar" in spec:                  # the published spec's budgets
        assert [o for p in ph for o in p["overrides"]
                if o.startswith("workflow.max_epochs=")] == [
            f"workflow.max_epochs={n}" for n in (170, 320, 470, 620, 770,
                                                 920)]
    with pytest.raises(CurriculumError):
        expand_phases({"phases": [{"overrides": ["a={nope}"]}]})
    with pytest.raises(CurriculumError):
        expand_phases({"phases": []})


def test_curriculum_warm_start_and_seed_forwarding(tmp_path, config_file,
                                                   caplog):
    """--snapshot seeds phase 1; --random-seed reaches phases whose spec
    sets none; the device flag is forwarded."""
    # the warm snapshot from a plain run (a subprocess: the CLI sets the
    # process-wide config and PRNG streams)
    res, = CliRunner().run_jobs([[config_file, "--snapshot-dir",
                                  str(tmp_path / "warm")]])
    assert res["epochs"] == 1, res
    warm = str(tmp_path / "warm" / "CurLM_best.json")
    spec = tmp_path / "s.json"
    spec.write_text(json.dumps(
        {"phases": [{"overrides": ["workflow.max_epochs=2"]}]}))
    with caplog.at_level(logging.INFO):
        summary = _curriculum(config_file, str(spec), str(tmp_path / "c3"),
                              "--snapshot", warm, "--random-seed", "7")
    assert summary["phases_run"] == 1
    assert summary["phases"][0]["epochs"] == 2   # resumed after epoch 0
    log = caplog.text
    assert f"restore {warm}" in log
    assert "--random-seed 7" in log and "--device cpu" in log


def test_cli_runner_reports_a_failed_job_and_parallel_map_keeps_order(
        tmp_path, config_file):
    runner = CliRunner(n_workers=2)
    ok, bad = runner.run_jobs([[config_file], ["/nonexistent.json"]])
    assert ok["workflow"] == "CurLM" and "best_value" in ok
    assert bad["returncode"] != 0 and "error" in bad
    assert ParallelMap(lambda x: x * x, n_workers=3)(range(6)) == [
        0, 1, 4, 9, 16, 25]
