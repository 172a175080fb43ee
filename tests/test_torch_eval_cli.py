"""``python -m runbookai_tpu_torch eval|simulate`` against the JAX CLI's
``runbook eval|simulate``, on the CPU.

Each command runs once per package on the same arguments; stdout, stderr
and every report file must be equal with only clock fields (``elapsed_s``,
``generated_at``), temporary paths and random ids masked. Without a model:
``eval --offline``, ``eval --all --offline`` (also sharded), ``simulate
faults|generate|provision``. Under the mock provider: ``eval`` live,
``simulate eval`` and ``simulate investigate``. On ``llama3-test`` with
the JAX params (``test_torch_cli.py``'s ``config.yaml``): ``eval`` and
``simulate eval``, both engines stepping in lockstep with the event loop
(``test_torch_evalsuite.py``), so that concurrent cases batch the same.
"""

import json
import os
import shutil
import time
from pathlib import Path

import pytest
import torch
import yaml

import runbookai_tpu.cli.main as j_main
import runbookai_tpu.cli.runtime as j_runtime
import runbookai_tpu_torch.__main__ as t_main
from test_torch_cli import _IDS, FROZEN_NOW, SIMULATED, engine_config, jax_client_without_monitors  # noqa: F401
from test_torch_evalsuite import DATASETS, FIXTURES, MINI, lockstep, masked  # noqa: F401

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores


@pytest.fixture()
def frozen_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: FROZEN_NOW)


def run(pkg: str, argv: list[str], capsys, config=None, out=None) -> tuple[int, str, str]:
    """One package's CLI on ``argv`` (the port's with ``--device cpu`` where
    the command serves a model): exit code, stdout and stderr, with ``out``
    written as ``<out>`` and ids masked."""
    serving = argv[:2] in (["simulate", "eval"], ["simulate", "investigate"]) or (
        argv[0] == "eval" and "--offline" not in argv)
    if pkg == "j":
        rc = j_main.main([*(["--config", str(config)] if config else []), *argv])
    else:
        extra = (["--config", str(config)] if config else []) + (
            ["--device", "cpu"] if serving else [])
        rc = t_main.main([*argv, *extra])
    cap = capsys.readouterr()

    def clean(text):
        if out is not None:
            text = text.replace(str(out), "<out>")
        return _IDS.sub("<id>", text)
    return rc, clean(cap.out), clean(cap.err)


def both(argv_of, capsys, tmp_path, config=None, as_json=False):
    """The command for each package (``argv_of(out_dir)``): equal exit
    codes, outputs and files; returns the port's (rc, stdout, files)."""
    results = {}
    for pkg in ("j", "t"):
        out = tmp_path / pkg
        rc, stdout, stderr = run(pkg, argv_of(out), capsys, config, out)
        if as_json:
            stdout = masked(json.loads(stdout))
        written = {}
        if out.exists():
            for p in sorted(out.rglob("*")):
                if p.is_file():
                    text = p.read_text().replace(str(out), "<out>")
                    written[str(p.relative_to(out))] = (
                        masked(json.loads(text)) if p.suffix == ".json" else text)
        results[pkg] = (rc, stdout, stderr, written)
    assert results["t"] == results["j"]
    rc, stdout, _, written = results["t"]
    return rc, stdout, written


def mini_tree(root: Path) -> Path:
    """The checked-in mini datasets, each in its benchmark's directory."""
    for bench, name in MINI.items():
        (root / bench).mkdir(parents=True)
        shutil.copy(DATASETS / name, root / bench / name)
    return root


# ------------------------------------------------------------ no model


def test_eval_offline_prints_jax_cli_output(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("RUNBOOK_WEIGHTS", raising=False)
    rc, out, files = both(lambda o: ["eval", "--offline", "--fixtures", str(FIXTURES),
                                     "--out", str(o)], capsys, tmp_path, as_json=True)
    assert rc == 0 and out["total"] == 3 and 0 < out["pass_rate"] < 1
    assert set(files) == {"investigation.json", "summary.json"}
    rc, _, _ = both(lambda o: ["eval", "--offline", "--fixtures", str(FIXTURES),
                               "--out", str(o), "--min-pass-rate", "0.9"],
                    capsys, tmp_path / "strict", as_json=True)
    assert rc == 1


@pytest.mark.parametrize("shard", [None, "1/2", "0/3"])
def test_eval_all_offline_prints_jax_cli_output(shard, tmp_path, capsys, monkeypatch):
    """``eval --all --offline`` over the mini datasets, whole and sharded."""
    monkeypatch.delenv("RUNBOOK_WEIGHTS", raising=False)
    datasets = mini_tree(tmp_path / "datasets")
    rc, out, files = both(lambda o: ["eval", "--all", "--offline", "--datasets-root",
                                     str(datasets), "--out", str(o),
                                     *(["--shard", shard] if shard else [])],
                          capsys, tmp_path, as_json=True)
    assert rc == 0 and out["passed"] == 3
    assert {"run-all.json", "summary.json", "rcaeval-fixtures.json"} <= set(files)


def test_eval_shard_errors(tmp_path, capsys):
    """A malformed shard prints the same error; ``auto`` is unported."""
    rc, _, _ = both(lambda o: ["eval", "--all", "--offline", "--shard", "3/2",
                               "--out", str(o)], capsys, tmp_path)
    assert rc == 1
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 6"):
        t_main.main(["eval", "--all", "--offline", "--shard", "auto",
                     "--out", str(tmp_path / "auto")])


def test_simulate_faults_generate_provision_print_jax_cli_output(tmp_path, capsys):
    rc, out, _ = both(lambda o: ["simulate", "faults"], capsys, tmp_path)
    assert rc == 0 and len(out.split()) == 11
    for args in (["--n", "4", "--seed", "7", "--reveal"],
                 ["--n", "3", "--adversarial", "mix", "--models", "a,b"],
                 ["--n", "2", "--fault", "disk_full", "--adversarial", "two_fault"]):
        rc, out, files = both(lambda o: ["simulate", "generate", *args, "--out", str(o)],
                              capsys, tmp_path / args[1])
        assert rc == 0 and len(files) == int(args[1])
    rc, _, _ = both(lambda o: ["simulate", "generate", "--fault", "gremlins"],
                    capsys, tmp_path / "bad")
    assert rc == 1
    scenario = tmp_path / "4" / "t" / "SIM-7.json"
    rc, out, _ = both(lambda o: ["simulate", "provision", str(scenario)], capsys,
                      tmp_path / "plan")
    assert rc == 0 and "teardown" in out and out.rstrip().endswith("to execute)")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 10"):
        t_main.main(["simulate", "provision", str(scenario), "--apply"])


# --------------------------------------------------------- the mock LLM


def mock_config(tmp_path: Path) -> Path:
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump({"runbook_dir": str(tmp_path / "rb")}))
    return config


def test_eval_and_simulate_eval_under_mock(tmp_path, capsys, monkeypatch, frozen_clock):
    """``llm.provider: mock`` (the default): ``eval`` live over the sample
    fixtures and ``simulate eval`` (breakdown, triage baseline on
    stderr) print what the JAX CLI prints."""
    monkeypatch.delenv("RUNBOOK_WEIGHTS", raising=False)
    monkeypatch.chdir(tmp_path)
    config = mock_config(tmp_path)
    rc, out, files = both(lambda o: ["eval", "--fixtures", str(FIXTURES), "--out", str(o)],
                          capsys, tmp_path / "eval", config=config, as_json=True)
    assert rc == 0 and [c["status"] for c in out["cases"]] == ["completed"] * 3
    rc, out, files = both(lambda o: ["simulate", "eval", "--n", "3", "--seed", "2",
                                     "--adversarial", "mix", "--out", str(o)],
                          capsys, tmp_path / "sim", config=config, as_json=True)
    assert rc == 0 and set(out["breakdown"]) == {"fault_family", "adversarial"}
    assert files["simulated-incidents.json"]["breakdown"] == out["breakdown"]


def test_simulate_investigate_under_mock(tmp_path, capsys, monkeypatch, frozen_clock):
    """The scenario's fixtures through ``providers.aws.fixtures_path``,
    every provider simulated; the ground truth printed last."""
    monkeypatch.chdir(tmp_path)
    config = mock_config(tmp_path)
    both(lambda o: ["simulate", "generate", "--n", "1", "--seed", "11", "--out", str(o)],
         capsys, tmp_path / "gen")
    scenario = tmp_path / "gen" / "t" / "SIM-11.json"
    rc, out, _ = both(lambda o: ["simulate", "investigate", "--scenario", str(scenario),
                                 "--yes"], capsys, tmp_path / "inv", config=config)
    assert rc == 0 and "── ground truth (SIM-11) ──" in out


# --------------------------------------------------------- llama3-test


@pytest.mark.parametrize("cmd", ["eval", "simulate_eval"])
def test_eval_on_engine_prints_jax_cli_output(cmd, engine_config, tmp_path, capsys,  # noqa: F811
                                              monkeypatch, frozen_clock, lockstep):  # noqa: F811
    """``eval`` over the sample fixtures and ``simulate eval --n 2`` at the
    default concurrency of 4 on ``llama3-test`` with the JAX params: the
    same report, case rows and files as the JAX CLI's."""
    monkeypatch.delenv("RUNBOOK_WEIGHTS", raising=False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(j_runtime, "create_llm_client", jax_client_without_monitors)
    argv = (["eval", "--fixtures", str(FIXTURES)] if cmd == "eval"
            else ["simulate", "eval", "--n", "2"])
    rc, out, files = both(lambda o: [*argv, "--out", str(o)], capsys, tmp_path,
                          config=engine_config, as_json=True)
    assert rc == 0 and all(c["status"] == "completed" for c in out["cases"])
    assert len(out["cases"]) == (3 if cmd == "eval" else 2)
