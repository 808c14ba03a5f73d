"""The port's CLI against the JAX CLI (tests/test_cli.py:67, :320): the
train mode's ``--result-file`` carries every key of the JAX result for
the same config; ``--generate`` greedy and ``--beams 3`` give the JAX
CLI's tokens (beam scores within rtol 1e-5) on the same JAX-written
snapshot; the decode flags' checks refuse with the JAX CLI's messages;
``--export DIR`` writes the JAX CLI's package, ``--export DIR
--compiled`` a sealed artifact that ``--serve 0 --artifact DIR`` serves
with no config (the tokens of the port's ``generate()`` on the same
snapshot), and the export and artifact flags refuse what the JAX CLI
refuses.
Each CLI run is a subprocess on the CPU (a CLI sets its package's
process-wide config and PRNG streams); the port's runs cannot import
JAX."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from veles_tpu_torch.__main__ import (_check_generate_args,  # noqa: E402
                                      _parse_prompt, build_parser)
from veles_tpu_torch.__main__ import main as port_main  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: configs/induction_lm64.json narrowed: one block, dim 32, T 16
LM = {"workflow": {
    "name": "CliLM",
    "layers": [
        {"type": "embedding", "vocab": 16, "dim": 32, "name": "emb"},
        {"type": "attention", "n_heads": 2, "rope": True,
         "residual": True, "name": "attn1"},
        {"type": "layer_norm", "name": "ln1"},
        {"type": "ffn", "d_hidden": 64, "name": "ffn1"},
        {"type": "all2all", "output_size": 16, "per_position": True,
         "name": "out"}],
    "loss": "softmax", "optimizer": "adam",
    "optimizer_args": {"lr": 0.003}, "max_epochs": 2,
    "fail_iterations": 2},
    "loader": {"name": "induction", "minibatch_size": 20, "seq_len": 16,
               "vocab": 16, "per_position": True, "n_train": 60,
               "n_valid": 20}}


def _cli(tmp, package, *argv):
    """``python -m <package> argv`` in a fresh interpreter: the JAX CLI
    pinned to the CPU, the port's with ``--device cpu`` and JAX made
    unimportable (the port needs none)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp), REPO]),
               JAX_PLATFORMS="cpu")
    extra = []
    if package == "veles_tpu_torch":
        (tmp / "sitecustomize.py").write_text(
            "import sys\nsys.modules['jax'] = None\n")
        extra = ["--device", "cpu"]
    else:
        extra = ["--platform", "cpu"]
    r = subprocess.run([sys.executable, "-m", package, *argv, *extra],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX CLI's training run: its config, result dict and best
    snapshot."""
    d = tmp_path_factory.mktemp("cli")
    cfg = d / "lm.json"
    cfg.write_text(json.dumps(LM))
    (d / "jax").mkdir()
    res = d / "jax_result.json"
    _cli(d / "jax", "veles_tpu", str(cfg), "--random-seed", "1",
         "--snapshot-dir", str(d / "snap"), "--result-file", str(res))
    return str(cfg), json.loads(res.read_text()), \
        str(d / "snap" / "CliLM_best.json"), d


def test_result_file_has_the_jax_results_keys(trained):
    cfg, jax_res, _, d = trained
    res = d / "port_result.json"
    (d / "port").mkdir(exist_ok=True)
    out = _cli(d / "port", "veles_tpu_torch", cfg, "--random-seed", "1",
               "--result-file", str(res))
    port_res = json.loads(res.read_text())
    assert port_res == out
    assert set(jax_res) <= set(port_res), set(jax_res) - set(port_res)
    assert port_res["workflow"] == jax_res["workflow"] == "CliLM"
    assert port_res["checksum"] == jax_res["checksum"]
    assert port_res["epochs"] == jax_res["epochs"] == 2
    assert port_res["train_step_flops"] > 0
    assert port_res["train_mfu"] == 0.0 and port_res["peak_tflops"] == 0.0


@pytest.mark.parametrize("extra", [[], ["--beams", "3", "--length-penalty",
                                        "0.6", "--eos-id", "3"]],
                         ids=["greedy", "beams3_eos_penalty"])
def test_generate_equals_the_jax_cli(trained, extra):
    cfg, _, snap, d = trained
    rows = [[1, 2, 3, 4, 5, 6, 1, 2], [7, 8, 9, 10, 11, 12, 7, 8]]
    np.save(d / "prompt.npy", np.asarray(rows, np.int32))
    argv = [cfg, "--snapshot", snap, "--generate", "6", *extra]
    want = _cli(d / "jax", "veles_tpu", *argv, "--prompt",
                ";".join(",".join(map(str, r)) for r in rows))
    res = d / "p.json"
    # the port reads the same prompt from a .npy file
    got = _cli(d / "port", "veles_tpu_torch", *argv, "--prompt",
               f"@{d / 'prompt.npy'}", "--result-file", str(res))
    assert json.loads(res.read_text()) == got
    assert got["prompt_len"] == want["prompt_len"] == 8
    assert got["tokens"] == want["tokens"]
    assert len(got["tokens"]) == 2 and len(got["tokens"][0]) == 14
    if extra:
        np.testing.assert_allclose(got["scores"], want["scores"],
                                   rtol=1e-5)
    else:
        assert "scores" not in got


@pytest.mark.parametrize("argv,message", [
    (["--generate", "2"], "--generate needs --prompt"),
    (["--generate", "2", "--prompt", "1,2", "--top-k", "3"],
     "--top-k/--top-p filter SAMPLING and need --temperature > 0"),
    (["--generate", "2", "--prompt", "1,2", "--temperature", "1",
      "--top-k", "0"], "--top-k must be >= 1, got 0"),
    (["--generate", "2", "--prompt", "1,2", "--temperature", "1",
      "--top-p", "1.5"], "--top-p must be in (0, 1], got 1.5"),
    (["--generate", "2", "--prompt", "1,2", "--beams", "0"],
     "--beams must be >= 1, got 0"),
    (["--generate", "2", "--prompt", "1,2", "--length-penalty", "0.5"],
     "--length-penalty shapes BEAM scores and needs --beams > 1"),
    (["--generate", "2", "--prompt", "1,2", "--beams", "2",
      "--temperature", "0.5"], "--beams is deterministic search"),
], ids=["no_prompt", "topk_greedy", "topk0", "topp", "beams0",
        "penalty_greedy", "beams_sampled"])
def test_decode_flags_refused_with_the_jax_messages(argv, message):
    args = build_parser().parse_args(["cfg.json", *argv])
    with pytest.raises(SystemExit) as e:
        _check_generate_args(args)
    assert message in str(e.value)


@pytest.mark.parametrize("flag", [["--generate", "2"], ["--serve", "0"]],
                         ids=["generate", "serve"])
def test_curriculum_refuses_single_run_modes(flag):
    with pytest.raises(SystemExit) as e:
        port_main(["cfg.json", "--curriculum", "spec.json", *flag])
    assert "--curriculum is a training meta-mode" in str(e.value)


def test_prompt_parsing():
    assert _parse_prompt("1,2,3;4,5,6").tolist() == [[1, 2, 3], [4, 5, 6]]
    with pytest.raises(SystemExit, match="equal length"):
        _parse_prompt("1,2;3")


def test_export_writes_the_jax_cli_package(trained):
    """``CONFIG --snapshot SNAP --export DIR`` in both CLIs: the same
    ``contents.json`` and the same npy bytes."""
    cfg, _, snap, d = trained
    (d / "port").mkdir(exist_ok=True)
    _cli(d / "jax", "veles_tpu", cfg, "--snapshot", snap, "--export",
         str(d / "pkg_jax"))
    out = _cli(d / "port", "veles_tpu_torch", cfg, "--snapshot", snap,
               "--export", str(d / "pkg_port"))
    assert out["exported"] == str(d / "pkg_port")
    want = json.loads((d / "pkg_jax" / "contents.json").read_text())
    got = json.loads((d / "pkg_port" / "contents.json").read_text())
    assert got == want
    for u in got["units"]:
        for fname in u["weights"].values():
            assert (d / "pkg_port" / fname).read_bytes() == \
                (d / "pkg_jax" / fname).read_bytes()


def test_export_compiled_then_serve_the_artifact_with_no_config(trained):
    """``--export DIR --compiled`` seals the restored model; ``--serve 0
    --artifact DIR`` (no config, JAX unimportable) boots it and answers
    ``POST /generate`` with the port's ``generate()`` tokens on the same
    snapshot, then drains to exit 0 on ``POST /admin/drain``."""
    import urllib.request
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.runtime.generate import generate
    from veles_tpu_torch.runtime.snapshotter import wstate_from_snapshot
    from veles_tpu_torch.units.base import Spec
    cfg, _, snap, d = trained
    (d / "port").mkdir(exist_ok=True)
    art = str(d / "art")
    out = _cli(d / "port", "veles_tpu_torch", cfg, "--snapshot", snap,
               "--export", art, "--compiled")
    assert out["compiled"] and "programs/decode.pt2" in \
        out["manifest"]["programs"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(d / "port"),
                                                       REPO]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", "--serve", "0",
         "--artifact", art, "--device", "cpu"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        banner = json.loads(proc.stdout.readline())
        assert banner["artifact"] == art and banner["engine"]
        rows = [[1, 2, 3, 4, 5, 6, 1, 2], [7, 8, 9, 10, 11, 12, 7, 8]]

        def post(path, body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{banner['serving']}{path}",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read() or b"{}")

        got = post("/generate", {"prompt": rows, "steps": 6})["tokens"]
        post("/admin/drain", {})
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(60)
        proc.stdout.close()
    sw = StandardWorkflow(json.loads(open(cfg).read())["workflow"])
    wf = sw.workflow
    wf.build({"@input": Spec((20, 16), torch.int32),
              "@labels": Spec((20, 16), torch.int32),
              "@mask": Spec((20, 16), torch.float32)})
    ws = wstate_from_snapshot(snap, wf, device="cpu")
    assert got == generate(wf, ws, np.asarray(rows, np.int32),
                           6).tolist()


@pytest.mark.parametrize("argv,message", [
    (["cfg.json", "--compiled"], "--compiled modifies --export DIR"),
    (["cfg.json", "--export", "d", "--serve", "0"],
     "--export writes the (restored) model and exits"),
    (["--artifact", "d"], "--artifact serves a compiled artifact and "
                          "needs --serve PORT"),
    (["cfg.json", "--serve", "0", "--artifact", "d"],
     "a workflow config cannot apply"),
    (["--serve", "0", "--artifact", "d", "--export", "x"],
     "--export needs the model config to package"),
    (["--serve", "0", "--artifact", "d", "--snapshot", "s"],
     "--snapshot cannot apply"),
    (["--serve", "0", "--artifact", "d", "--generate", "2"],
     "--generate is a one-shot decode"),
], ids=["compiled_alone", "export_serve", "artifact_no_serve",
        "artifact_config", "artifact_export", "artifact_snapshot",
        "artifact_generate"])
def test_export_and_artifact_flags_refused(argv, message):
    with pytest.raises(SystemExit) as e:
        port_main(argv)
    assert message in str(e.value)
