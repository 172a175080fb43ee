"""The port's ``knowledge`` commands, and ``investigate``/``ask`` over a
knowledge base, against the JAX package's CLI on the CPU.

One ``config.yaml`` a package: the generated tree of ``chip_smoke``'s phase
19 (a few documents and the three example runbooks) as a filesystem source,
``bge-test`` with the JAX package's params written out as an HF directory
(``model_path``, so both packages embed with the same weights) and, for the
agent, the simulated providers and a ``service-graph.json``. ``python -m
runbookai_tpu_torch knowledge ... --device cpu`` prints what ``runbook
knowledge ...`` prints; ``investigate`` and ``ask`` over the JAX-synced
``knowledge.db`` print what the JAX CLI prints, under the mock provider and
on ``llama3-test`` with the JAX params (time pinned, ids masked).
"""

import os
import shutil
from pathlib import Path

import jax
import pytest
import torch
import yaml

import chip_smoke
import runbookai_tpu.cli.main as j_main
import runbookai_tpu.cli.runtime as j_runtime
import runbookai_tpu.models.bge as j_bge
import runbookai_tpu_torch.__main__ as t_main
from runbookai_tpu.model.jax_tpu import JaxTpuClient
from test_torch_cli import (DESCRIPTION, FROZEN_NOW, QUERY, SIMULATED,
                            jax_client_without_monitors, run_cli, write_hf_dir)
from test_torch_knowledge import write_bert_dir

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores

HOWTO = "how to mitigate connection exhaustion on payment-api"
AGENT_ARGS = {"investigate": ["investigate", "PD-424242", "--description", DESCRIPTION],
              "ask": ["ask", QUERY], "ask_howto": ["ask", HOWTO]}


@pytest.fixture()
def frozen_clock(monkeypatch):
    """A fixed ``time.time``: the simulated fixtures stamp their records
    with it, and those stamps reach the prompts."""
    import time

    monkeypatch.setattr(time, "time", lambda: FROZEN_NOW)


@pytest.fixture(scope="module")
def kb(tmp_path_factory) -> dict:
    """The tree, the encoder's HF directory and a markdown file to add."""
    root = tmp_path_factory.mktemp("kbcli")
    chip_smoke.knowledge_tree(root / "tree", n_docs=6)
    extra = chip_smoke.knowledge_tree(root / "extra", n_docs=1, seed=7)
    assert extra["documents"] == 4
    cfg = j_bge.CONFIGS["bge-test"]
    bert = write_bert_dir(j_bge.init_params(jax.random.PRNGKey(0), cfg), cfg, root / "bert")
    return {"root": root, "tree": root / "tree", "bert": bert,
            "add": root / "extra" / "generated" / "doc-000.md"}


def write_config(path: Path, kb: dict, db: Path, extra: dict | None = None,
                 sources: list | None = None) -> Path:
    """A config with the tree as one filesystem source, ``db`` and the
    encoder of ``kb["bert"]``; ``extra`` laid over it."""
    if sources is None:
        sources = [{"type": "filesystem", "name": "runbooks", "path": str(kb["tree"])}]
    doc = {"knowledge": {"sources": sources, "db_path": str(db),
                         "embedder": {"model": "bge-test", "model_path": str(kb["bert"])}},
           **(extra or {})}
    path.write_text(yaml.safe_dump(doc))
    return path


def jax_knowledge(config: Path, *args: str) -> list[str]:
    return ["--config", str(config), "knowledge", *args]


def port_knowledge(config: Path, *args: str) -> list[str]:
    return ["knowledge", *args, "--config", str(config), "--device", "cpu"]


def test_knowledge_commands_print_jax_output(kb, tmp_path, capsys):
    """sync, stats, search (with its filters), add, an incremental sync and
    validate: each prints what the JAX CLI prints, each package on its own
    db from the same tree."""
    steps = [["sync"], ["stats"], ["search", "connection pool exhausted"],
             ["search", "certificate expiry", "--type", "runbook", "--service", "payment-api",
              "--limit", "3"],
             ["search", "kafka consumer lag", "--limit", "12"], ["search", "zzzz qqqq"],
             ["add", str(kb["add"])], ["search", "lock contention"], ["stats"],
             ["sync"], ["sync", "--force"], ["validate"]]
    outs = {}
    for name, main, argv in (("jax", j_main.main, jax_knowledge),
                             ("port", t_main.main, port_knowledge)):
        config = write_config(tmp_path / f"{name}.yaml", kb, tmp_path / f"{name}.db")
        outs[name] = [run_cli(main, argv(config, *step), capsys) for step in steps]
    for step, got, want in zip(steps, outs["port"], outs["jax"]):
        assert got == want, step
    got = outs["port"]
    assert got[0].startswith("runbooks: 9 documents synced\n") and '"embeddings":' in got[0]
    assert got[2].startswith("[") and got[5].startswith("[")  # vector hits alone
    assert got[6].startswith("added ") and got[9].startswith("runbooks: 0 documents")
    assert got[11] == "ok\n"


def test_knowledge_validate_prints_jax_problems(kb, tmp_path, capsys):
    sources = [{"type": "filesystem", "name": "gone", "path": str(tmp_path / "missing")}]
    config = write_config(tmp_path / "c.yaml", kb, tmp_path / "k.db", sources=sources)
    outs = []
    for main, argv in ((j_main.main, jax_knowledge), (t_main.main, port_knowledge)):
        assert main(argv(config, "validate")) == 1
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[1].endswith("1 problem(s)\n")


def test_knowledge_auth_and_remote_sources_raise(kb, tmp_path):
    """``knowledge auth`` and a Confluence or Google Drive source are not
    ported (HTTP clients, no device work): each raises naming item 10,
    before a db or an encoder is made."""
    config = write_config(tmp_path / "c.yaml", kb, tmp_path / "k.db")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 10"):
        t_main.main(port_knowledge(config, "auth", "google"))
    for source in ({"type": "confluence", "name": "wiki", "base_url": "https://x.atlassian.net",
                    "space": "OPS"},
                   {"type": "google-drive", "name": "drive", "folder_id": "f1"}):
        config = write_config(tmp_path / "r.yaml", kb, tmp_path / "r.db", sources=[source])
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 10"):
            t_main.main(port_knowledge(config, "stats"))
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 10"):
            t_main.main(["ask", QUERY, "--yes", "--config", str(config), "--device", "cpu"])
        assert not (tmp_path / "r.db").exists()


def test_knowledge_search_without_device_cpu_asks_for_the_card(kb, tmp_path):
    """Without ``--device cpu`` the encoder and the vectors go to the card;
    on a box without one, the command raises, nothing moves to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("the card is there: it would search on it")
    config = write_config(tmp_path / "c.yaml", kb, tmp_path / "k.db")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_main.main(["knowledge", "search", "pool", "--config", str(config)])


def agent_config(kb: dict, root: Path, extra: dict) -> Path:
    """The agent's config over a copy of a JAX-synced db, with the phase-19
    service graph in its runbook dir."""
    db = root / "knowledge.db"
    rb = root / "rb"
    rb.mkdir(parents=True)
    (rb / "service-graph.json").write_text(chip_smoke.knowledge_graph_json())
    config = write_config(root / "config.yaml", kb, db,
                          extra={**SIMULATED, "runbook_dir": str(rb), **extra})
    assert j_main.main(jax_knowledge(config, "sync")) == 0
    return config


def run_both(cmd: str, config: Path, tmp_path: Path, capsys) -> str:
    args = AGENT_ARGS[cmd]
    want = run_cli(j_main.main, ["--config", str(config), *args, "--yes"], capsys)
    for path in tmp_path.rglob("cp-*.json"):
        path.unlink()
    got = run_cli(t_main.main, [*args, "--yes", "--config", str(config), "--device", "cpu"],
                  capsys)
    assert got == want
    return got


@pytest.mark.parametrize("cmd", list(AGENT_ARGS))
def test_agent_over_knowledge_prints_jax_output_under_mock(cmd, kb, tmp_path, monkeypatch,
                                                          capsys, frozen_clock):
    """The mock provider over the knowledge base: the same events (the
    knowledge retrieval among them), tree and answer."""
    monkeypatch.chdir(tmp_path)
    config = agent_config(kb, tmp_path, {})
    capsys.readouterr()
    got = run_both(cmd, config, tmp_path, capsys)
    if cmd != "investigate":
        assert "⚲ knowledge retrieved" in got


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory) -> Path:
    jclient = JaxTpuClient.for_testing()
    return write_hf_dir(jclient.core.params, jclient.core.cfg,
                        tmp_path_factory.mktemp("llama") / "weights")


@pytest.mark.parametrize("cmd", ["investigate", "ask_howto"])
def test_agent_over_knowledge_on_engine_prints_jax_output(cmd, kb, llama_dir, tmp_path,
                                                          monkeypatch, capsys, frozen_clock):
    """``llama3-test`` with the JAX params on the engine, over the
    knowledge base: every streamed token, event and phase document as the
    JAX CLI prints them. ``ask`` asks the how-to question, which the agent
    answers from the retrieved knowledge alone; its prompt fits the context
    (phase 18's question with the five providers and the knowledge block does
    not, and both engines abort it)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(j_runtime, "create_llm_client", jax_client_without_monitors)
    llm = dict(provider="jax-tpu", model="llama3-test", model_path=str(llama_dir),
               dtype="float32", max_new_tokens=48, max_seq_len=8192, page_size=16,
               num_pages=1024, prefill_chunk=512, max_batch_slots=4)
    config = agent_config(kb, tmp_path, {"llm": llm, "agent": {
        "max_hypotheses": 2, "max_hypothesis_depth": 1, "max_investigation_iterations": 2}})
    capsys.readouterr()
    got = run_both(cmd, config, tmp_path, capsys)
    if cmd == "investigate":
        assert "\nroot cause:" in got and "== TRIAGE ==" in got
    else:
        assert "⚲ knowledge retrieved" in got and got.rstrip().endswith("✔ done")


def test_kb_copy_is_searched_by_the_port_as_by_jax(kb, tmp_path, capsys):
    """A ``knowledge.db`` synced by the JAX CLI, copied, then searched by
    each CLI: the same lines."""
    config = write_config(tmp_path / "c.yaml", kb, tmp_path / "k.db")
    assert j_main.main(jax_knowledge(config, "sync")) == 0
    shutil.copy(tmp_path / "k.db", tmp_path / "copy.db")
    copy = write_config(tmp_path / "copy.yaml", kb, tmp_path / "copy.db")
    capsys.readouterr()
    for query in ("redis clients maxed out", "OOMKilled restarts on checkout-web"):
        want = run_cli(j_main.main, jax_knowledge(config, "search", query), capsys)
        assert run_cli(t_main.main, port_knowledge(copy, "search", query), capsys) == want
