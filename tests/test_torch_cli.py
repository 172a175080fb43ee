"""The port's ``ask``/``investigate`` CLI and ``TorchCudaClient.from_config``
against the JAX package, on the CPU.

``from_config`` builds the ``EngineConfig`` that the JAX package's
``fleet/build.py::build_group`` builds for every field it reads, refuses each
unported feature with ``NotImplementedError`` naming its ROADMAP item, and
starts no thread. ``python -m runbookai_tpu_torch ask|investigate`` prints
what the JAX package's ``runbook ask|investigate`` prints: under the mock
provider, and on ``llama3-test`` whose JAX params are written out as an HF
weights directory that one ``config.yaml`` hands to both packages.
"""

import dataclasses
import json
import os
import re
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import runbookai_tpu.cli.main as j_main
import runbookai_tpu.cli.runtime as j_runtime
import runbookai_tpu.fleet.build as j_build
import runbookai_tpu.models.hf_loader as j_hf
import runbookai_tpu_torch.__main__ as t_main
from runbookai_tpu.engine.engine import EngineConfig as JEngineConfig
from runbookai_tpu.model.jax_tpu import JaxTpuClient
from runbookai_tpu.models.llama import CONFIGS as JCONFIGS
from runbookai_tpu.utils.config import LLMConfig as JLLMConfig
from runbookai_tpu_torch.engine.engine import EngineConfig
from runbookai_tpu_torch.model.client import MockLLMClient, create_llm_client
from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
from runbookai_tpu_torch.utils.config import Config, LLMConfig

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores

FIXTURES = Path(__file__).parent / "fixtures"
FROZEN_NOW = 1_790_000_000.0
DESCRIPTION = "checkout latency p99 elevated after deploy"
QUERY = "why is checkout latency high?"
SIMULATED = {
    "providers": {"aws": {"enabled": True, "simulated": True},
                  "kubernetes": {"enabled": True, "simulated": True},
                  "github": {"enabled": True, "simulated": True}},
    "observability": {"datadog": {"enabled": True, "simulated": True}},
    "incident": {"pagerduty": {"enabled": True, "simulated": True}},
}
# Every field from_config reads, away from its default.
EVERY_FIELD = dict(model="llama3-test", dtype="float32", kv_cache_dtype="fp8",
                   temperature=0.5, top_p=0.9, top_k=7, max_new_tokens=77, guided_json=False,
                   page_size=8, num_pages=300, max_batch_slots=3, prefill_chunk=48,
                   decode_steps=4, max_seq_len=1000, mesh={"model": 2})
_IDS = re.compile(r"\b(call_[0-9a-f]{12}|ask-[0-9a-f]{10}|session-[0-9a-f]{10}|"
                  r"ap-[0-9a-f]{10}|inv-[0-9a-f]{8}|cp-\d+-[0-9a-f]{6}|h\d+-[0-9a-f]{6})\b")


@pytest.fixture()
def frozen_clock(monkeypatch):
    """A fixed ``time.time``: the simulated fixtures stamp their records
    with it, and those stamps reach the prompts."""
    monkeypatch.setattr(time, "time", lambda: FROZEN_NOW)


# ------------------------------------------------------------ from_config


def jax_engine_config(llm_cfg, monkeypatch) -> JEngineConfig:
    """The ``EngineConfig`` JAX's ``build_group`` makes for ``llm_cfg``
    (weights and cores stubbed: only the config is wanted)."""
    seen = {}

    def load_or_init(name, path, **_):
        return (j_hf.config_from_hf(path, name) if path else JCONFIGS[name]), None

    class Core:
        def __init__(self, cfg, params, tokenizer, ecfg, **_):
            seen["ecfg"] = ecfg

    monkeypatch.setattr(j_hf, "load_or_init", load_or_init)
    monkeypatch.setattr(j_build, "EngineCore", Core)
    j_build.build_group(llm_cfg)
    return seen["ecfg"]


def port_build_kwargs(llm_cfg, monkeypatch) -> dict:
    """What ``from_config`` hands ``TorchCudaClient.build``."""
    seen = {}

    def build(cls, model, **kw):
        seen.update(kw, model=model)
        return seen

    monkeypatch.setattr(TorchCudaClient, "build", classmethod(build))
    TorchCudaClient.from_config(llm_cfg, device="cpu")
    return seen


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1] if isinstance(dtype, torch.dtype) else np.dtype(dtype).name


@pytest.mark.parametrize("fields", [{}, EVERY_FIELD], ids=["defaults", "every_field"])
def test_from_config_builds_jax_engine_config(fields, monkeypatch):
    """The fields the two ``EngineConfig``s share are equal (the KV dtype
    by name); the client settings are the config's."""
    monkeypatch.delenv("RUNBOOK_WEIGHTS", raising=False)
    want = jax_engine_config(JLLMConfig(provider="jax-tpu", **fields), monkeypatch)
    llm = LLMConfig(provider="jax-tpu", **fields)
    kw = port_build_kwargs(llm, monkeypatch)
    got = kw["engine_cfg"]
    shared = ({f.name for f in dataclasses.fields(EngineConfig)}
              & {f.name for f in dataclasses.fields(JEngineConfig)}) - {"kv_dtype"}
    assert len(shared) >= 15
    assert {n: getattr(got, n) for n in shared} == {n: getattr(want, n) for n in shared}
    assert dtype_name(got.kv_dtype) == dtype_name(want.kv_dtype)
    assert kw["model"] == llm.model and kw["tp"] == llm.mesh.model
    assert kw["dtype"] == {"bfloat16": torch.bfloat16, "float32": torch.float32}[llm.dtype]
    for name in ("temperature", "top_p", "top_k", "max_new_tokens", "guided_json",
                 "model_path", "tokenizer_path"):
        assert kw[name] == getattr(llm, name), name


def test_from_config_caps_the_context_at_the_model(monkeypatch):
    monkeypatch.delenv("RUNBOOK_WEIGHTS", raising=False)
    fields = dict(model="hf-tiny-untied", model_path=str(FIXTURES / "hf-tiny-untied"))
    want = jax_engine_config(JLLMConfig(provider="jax-tpu", **fields), monkeypatch)
    got = port_build_kwargs(LLMConfig(provider="jax-tpu", **fields), monkeypatch)["engine_cfg"]
    assert got.max_seq_len == want.max_seq_len == 512


@pytest.mark.parametrize("fields, item", [
    ({"models": [{"name": "a"}]}, "item 9"),
    ({"dp_replicas": 2}, "item 9"),
    ({"models": [{"name": "a", "adapters": {"x": "/nowhere"}}]}, "item 9"),
    ({"plan": "plan.json"}, "item 9"),
    ({"kv_spill_pages": 8}, "item 9"),
    ({"mesh": {"data": 2}}, "item 6"),
    ({"sched": {"policy": "wdrr"}}, "item 9"),
    ({"sched": {"feedback": True}}, "item 9"),
    ({"obs": {"enabled": False}}, "item 9"),
    ({"slo": {"ttft_p95_ms": 500}}, "item 9"),
    ({"tenants": {"enabled": True}}, "item 9"),
])
def test_from_config_refuses_unported_features(fields, item):
    """Each set field the port cannot honour raises, naming the ROADMAP
    item that ports it (an explicit ``sched``, even at the default
    values, included)."""
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1 {item}"):
        TorchCudaClient.from_config(LLMConfig(provider="jax-tpu", model="llama3-test",
                                              **fields), device="cpu")


def test_from_config_accepts_defaults_and_refuses_xla():
    """``obs``/``slo``/``tenants`` written out at their defaults are
    accepted; JAX's kernel-less ``xla`` route is refused."""
    llm = LLMConfig.model_validate({"provider": "jax-tpu", "model": "llama3-test",
                                    "dtype": "float32", "obs": {"enabled": True},
                                    "slo": {}, "tenants": {"enabled": False},
                                    "attn_impl": "pallas", "max_new_tokens": 4})
    assert isinstance(TorchCudaClient.from_config(llm, device="cpu"), TorchCudaClient)
    with pytest.raises(ValueError, match="xla"):
        TorchCudaClient.from_config(llm.model_copy(update={"qmm_impl": "xla"}), device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is there: it would serve")
@pytest.mark.parametrize("cmd", ["investigate", "ask"])
def test_cli_without_device_cpu_asks_for_the_card(cmd, tmp_path):
    """Without ``--device cpu`` the engine-backed commands serve on the
    card, and on a box without one they raise; nothing moves to the CPU."""
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump({"runbook_dir": str(tmp_path / "rb"), "llm": {
        "provider": "jax-tpu", "model": "llama3-test", "dtype": "float32"}}))
    args = [cmd, "PD-1"] if cmd == "investigate" else [cmd, QUERY]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_main.main([*args, "--yes", "--config", str(config)])


def test_from_config_starts_no_thread():
    """The JAX client starts its obs monitors here; the port's starts
    nothing, and a request served in its own event loop leaves none."""
    import asyncio

    before = threading.active_count()
    client = create_llm_client(Config(llm=LLMConfig(
        provider="jax-tpu", model="llama3-test", dtype="float32", max_new_tokens=4,
        max_seq_len=256, num_pages=64, prefill_chunk=32)), device="cpu")
    assert isinstance(client, TorchCudaClient)
    assert threading.active_count() == before

    async def serve():
        try:
            return await client.complete("ok", schema="triage")
        finally:
            await client.shutdown()

    asyncio.run(serve())
    assert threading.active_count() == before
    assert isinstance(create_llm_client(Config()), MockLLMClient)


def tiny_tokenizer(path: Path) -> Path:
    """A byte-level ``tokenizer.json`` of 256 ids for the fixtures' vocab:
    250 byte tokens (not the bytes 0xF8-0xFD, which UTF-8 text never
    holds) and the chat template's six special tokens."""
    from tokenizers import AddedToken, Tokenizer, decoders, models, pre_tokenizers

    from runbookai_tpu_torch.utils.tokens import _gpt2_byte_decoder

    chars = sorted((ch for ch, b in _gpt2_byte_decoder().items() if not 0xF8 <= b <= 0xFD),
                   key=lambda ch: _gpt2_byte_decoder()[ch])
    tok = Tokenizer(models.BPE(vocab={ch: i for i, ch in enumerate(chars)}, merges=[]))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.add_special_tokens([AddedToken(t, special=True) for t in (
        "<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>", "<|end_header_id|>",
        "<|eot_id|>", "<|python_tag|>")])
    assert tok.get_vocab_size() == 256
    tok.save(str(path))
    return path


async def test_from_config_serves_local_weights_as_jax(tmp_path):
    """``hf-tiny-untied`` through ``model_path`` (and a 256-id tokenizer,
    since the byte tokenizer's specials lie past the fixture's vocab):
    greedy ``complete()``, guided and not, equals the JAX client's on the
    engine ``build_group`` makes from the same config."""
    fields = dict(provider="jax-tpu", model="hf-tiny-untied",
                  model_path=str(FIXTURES / "hf-tiny-untied"),
                  tokenizer_path=str(tiny_tokenizer(tmp_path / "tokenizer.json")),
                  dtype="float32", max_new_tokens=24, page_size=4, num_pages=256,
                  prefill_chunk=32, max_batch_slots=4)
    built = j_build.build_group(JLLMConfig(**fields))
    jclient = JaxTpuClient(built.cores[0], built.tokenizer, max_new_tokens=24,
                           chat_format=built.chat_format)
    client = TorchCudaClient.from_config(LLMConfig(**fields), device="cpu")
    assert client.tokenizer.vocab_size == client.core.cfg.vocab_size == 256
    try:
        for kw in ({"schema": "triage"}, {"guided": False}):
            want = await jclient.complete("incident: checkout is slow", **kw)
            got = await client.complete("incident: checkout is slow", **kw)
            assert got == want and got
    finally:
        await jclient.shutdown()
        await client.shutdown()


# ------------------------------------------------------------- the CLIs


def run_cli(main, argv, capsys) -> str:
    assert main(argv) == 0
    return _IDS.sub("<id>", capsys.readouterr().out)


@pytest.mark.parametrize("cmd", ["investigate", "ask"])
def test_cli_prints_jax_cli_output_under_mock(cmd, tmp_path, monkeypatch, capsys,
                                              frozen_clock):
    """``llm.provider: mock`` (the default) with the simulated providers:
    both CLIs print the same lines; ``investigate`` leaves its final
    checkpoint under ``<runbook_dir>/checkpoints``."""
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump({**SIMULATED, "runbook_dir": str(tmp_path / "rb")}))
    monkeypatch.chdir(tmp_path)
    args = ([cmd, "PD-424242", "--description", DESCRIPTION] if cmd == "investigate"
            else [cmd, QUERY])
    want = run_cli(j_main.main, ["--config", str(config), *args, "--yes"], capsys)
    for path in (tmp_path / "rb").rglob("cp-*.json"):
        path.unlink()
    got = run_cli(t_main.main, [*args, "--yes", "--config", str(config), "--device", "cpu"],
                  capsys)
    assert got == want
    if cmd == "investigate":
        assert "root cause:" in got
        (saved,) = (tmp_path / "rb" / "checkpoints" / "PD-424242").glob("cp-*.json")
        snapshot = json.loads(saved.read_text())["snapshot"]
        assert snapshot["incident_id"] == "PD-424242" and snapshot["phase"] == "complete"


def write_hf_dir(params, cfg, path: Path) -> Path:
    """The JAX package's params as an HF Llama directory that its own
    ``hf_loader`` (and the port's) reads back."""
    from safetensors.numpy import save_file

    from runbookai_tpu.models.hf_loader import _LAYER_MAP

    p = jax.tree.map(np.asarray, params)
    tensors = {"model.embed_tokens.weight": p["embed"], "model.norm.weight": p["final_norm"],
               "lm_head.weight": p["lm_head"].T}
    for leaf, (tmpl, transpose) in _LAYER_MAP.items():
        for i in range(cfg.n_layers):
            w = p["layers"][leaf][i]
            tensors[tmpl.format(i=i)] = w.T if transpose else w
    path.mkdir()
    save_file({k: np.ascontiguousarray(v, dtype=np.float32) for k, v in tensors.items()},
              str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
        "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads, "intermediate_size": cfg.ffn_dim,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
        "max_position_embeddings": cfg.max_seq_len, "tie_word_embeddings": False}))
    return path


@pytest.fixture(scope="module")
def engine_config(tmp_path_factory):
    """A ``config.yaml`` serving ``llama3-test`` from the JAX params on the
    engine (the simulated providers, the e2e test's budgets)."""
    root = tmp_path_factory.mktemp("cli")
    jclient = JaxTpuClient.for_testing()
    weights = write_hf_dir(jclient.core.params, jclient.core.cfg, root / "weights")
    llm = dict(provider="jax-tpu", model="llama3-test", model_path=str(weights),
               dtype="float32", max_new_tokens=48, max_seq_len=8192, page_size=16,
               num_pages=1024, prefill_chunk=512, max_batch_slots=4)
    config = root / "config.yaml"
    config.write_text(yaml.safe_dump({
        **SIMULATED, "llm": llm, "runbook_dir": str(root / "rb"),
        "agent": {"max_hypotheses": 2, "max_hypothesis_depth": 1,
                  "max_investigation_iterations": 2}}))
    return config


def jax_client_without_monitors(config):
    """JAX's client on ``build_group``'s engine: ``from_config`` would also
    start the obs layer's monitor threads, which outlive the test."""
    built = j_build.build_group(config.llm)
    return JaxTpuClient(built.cores[0], built.tokenizer, max_new_tokens=config.llm.max_new_tokens,
                        guided_json=config.llm.guided_json, chat_format=built.chat_format)


@pytest.mark.parametrize("cmd", ["investigate", "ask"])
def test_cli_on_engine_prints_jax_cli_output(cmd, engine_config, monkeypatch, capsys,
                                             frozen_clock, tmp_path):
    """``investigate --device cpu`` and ``ask --device cpu`` on
    ``llama3-test`` with the JAX params: every streamed token, event,
    phase document, the tree and the root cause as the JAX CLI prints
    them."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(j_runtime, "create_llm_client", jax_client_without_monitors)
    args = ([cmd, "PD-424242", "--description", DESCRIPTION] if cmd == "investigate"
            else [cmd, QUERY])
    want = run_cli(j_main.main, ["--config", str(engine_config), *args, "--yes"], capsys)
    got = run_cli(t_main.main, [*args, "--yes", "--config", str(engine_config),
                                "--device", "cpu"], capsys)
    assert got == want
    if cmd == "investigate":
        assert "\nroot cause:" in got and "== TRIAGE ==" in got
    else:
        assert "-- iteration 1 --" in got and got.rstrip().endswith("✔ done")


def test_cli_investigate_on_random_weights(tmp_path, monkeypatch, capsys):
    """``investigate --device cpu`` on ``llama3-test`` drawn from the
    port's seed runs to its root cause and saves the checkpoint."""
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump({
        **SIMULATED, "runbook_dir": str(tmp_path / "rb"),
        "llm": dict(provider="jax-tpu", model="llama3-test", dtype="float32",
                    max_new_tokens=32, max_seq_len=4096, page_size=16, num_pages=512,
                    prefill_chunk=256),
        "agent": {"max_hypotheses": 2, "max_hypothesis_depth": 1,
                  "max_investigation_iterations": 2}}))
    monkeypatch.chdir(tmp_path)
    out = run_cli(t_main.main, ["investigate", "PD-1", "--yes", "--config", str(config),
                                "--device", "cpu"], capsys)
    assert "\nroot cause:" in out and "confidence:" in out
    assert list((tmp_path / "rb" / "checkpoints" / "PD-1").glob("cp-*.json"))


# ------------------------------------- chat, deploy and the session commands


def test_demo_script_plays_and_renders_as_jax():
    """The scripted demo's events and rendered lines equal the JAX package's
    (``tests/test_surfaces.py::test_demo_script_plays_and_renders``)."""
    from runbookai_tpu.demo.runner import render_event as j_render
    from runbookai_tpu.demo.runner import run_demo as j_run_demo
    from runbookai_tpu_torch.demo.runner import render_event, run_demo

    want, got = j_run_demo(sleep=lambda s: None), run_demo(sleep=lambda s: None)
    assert [(e.kind, e.data) for e in got] == [(e.kind, e.data) for e in want]
    assert [render_event(e) for e in got] == [j_render(e) for e in want]
    assert got[0].kind == "start" and got[-1].kind == "done"
    assert any("ROOT CAUSE" in render_event(e) for e in got)


def _both(argvs: list, tmp_path, monkeypatch, capsys, inputs=()) -> dict:
    """Each CLI runs ``argvs`` in turn in a directory of its own (its own
    ``.runbook/``), with ``inputs`` typed at its prompts; returns each one's
    stdout, ids masked, and exit codes."""
    out = {}
    for pkg, main in (("jax", j_main.main), ("port", t_main.main)):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        typed = iter(inputs)
        monkeypatch.setattr("builtins.input", lambda *a: next(typed))
        rcs = [main(argv) for argv in argvs]
        out[pkg] = (rcs, _IDS.sub("<id>", capsys.readouterr().out))
    return out


@pytest.mark.parametrize("template", ["minimal", "simulated", "tpu"])
def test_cli_init_status_config_print_jax_output(template, tmp_path, monkeypatch, capsys):
    """``init``, ``status`` and ``config --set/--show`` print what the JAX
    CLI prints and write the same config file
    (``tests/test_surfaces.py::test_cli_init_status_config``)."""
    out = _both([["init", "--template", template], ["init", "--template", template],
                 ["status"], ["config", "--set", "agent.max_iterations=4"],
                 ["config", "--set", "nonsense"], ["config", "--show"],
                 ["init", "--template", template, "--force"]],
                tmp_path, monkeypatch, capsys)
    assert out["port"] == out["jax"]
    assert out["port"][0][:2] == [0, 1] and '"max_iterations": 4' in out["port"][1]
    assert (tmp_path / "port" / ".runbook" / "config.yaml").read_text() == \
        (tmp_path / "jax" / ".runbook" / "config.yaml").read_text()


def test_cli_demo_prints_jax_output(tmp_path, monkeypatch, capsys):
    import runbookai_tpu.demo.runner as j_runner
    import runbookai_tpu_torch.demo.runner as t_runner

    for runner in (j_runner, t_runner):  # the demo's pauses, bound as a default
        monkeypatch.setattr(runner.run_demo, "__defaults__", (None, False, lambda s: None))
    out = _both([["demo", "--fast"]], tmp_path, monkeypatch, capsys)
    assert out["port"] == out["jax"] and "ROOT CAUSE" in out["port"][1]


def test_wizard_matches_jax(tmp_path):
    """The scripted onboarding wizard, its two files and their hydration, and
    a quick template equal the JAX package's
    (``tests/test_surfaces.py::test_wizard_scripted_flow_and_save``,
    ``::test_wizard_quick_template``)."""
    import runbookai_tpu.cli.wizard as j_wizard
    import runbookai_tpu_torch.cli.wizard as t_wizard

    script = ["custom", "jax-tpu", "llama3-8b-instruct", "multi", "prod,staging",
              "us-east-1,eu-west-1", "ecs,eks", "rds", "y", "pagerduty", "n",
              "./docs/runbooks"]
    got = {}
    for name, wiz in (("jax", j_wizard), ("port", t_wizard)):
        answers_script = iter(script)
        answers = wiz.run_wizard(ask=lambda q, d: next(answers_script))
        paths = wiz.save_wizard_configs(answers, tmp_path / name)
        got[name] = (dataclasses.asdict(answers), [p.read_text() for p in paths],
                     dataclasses.asdict(wiz.hydrate_answers(tmp_path / name)),
                     dataclasses.asdict(wiz.run_wizard(ask=lambda q, d: "kubernetes")))
    assert got["port"] == got["jax"]
    assert got["port"][0]["compute_services"] == ["ecs", "eks"]


@pytest.mark.parametrize("raw", [True, False], ids=["raw", "agent"])
def test_cli_chat_prints_jax_output(raw, tmp_path, monkeypatch, capsys, frozen_clock):
    """``chat`` without a prompt (the agent loop with its memory) and ``chat
    --raw`` (direct streaming), two turns typed in, under the mock provider
    with the simulated providers: the JAX CLI's output
    (``tests/test_surfaces.py::test_cli_chat_raw_streams``)."""
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump({**SIMULATED, "runbook_dir": str(tmp_path / "rb")}))
    flags = ["--raw"] if raw else []
    out = {}
    for pkg, argv in (("jax", ["--config", str(config), "chat", *flags]),
                      ("port", ["chat", *flags, "--config", str(config)])):
        typed = iter([QUERY, "and the database?", ""])
        monkeypatch.setattr("builtins.input", lambda *a: next(typed))
        main = j_main.main if pkg == "jax" else t_main.main
        out[pkg] = run_cli(main, argv, capsys)
    assert out["port"] == out["jax"]
    assert ("streaming model chat" if raw else "runbook chat") in out["port"]


@pytest.mark.parametrize("dry_run", [True, False], ids=["dry_run", "deploy"])
def test_cli_deploy_prints_jax_output(dry_run, tmp_path, monkeypatch, capsys, frozen_clock):
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump({**SIMULATED, "runbook_dir": str(tmp_path / "rb")}))
    monkeypatch.chdir(tmp_path)
    args = ["deploy", "payment-api", "-e", "staging", "--version", "v2",
            *(["--dry-run"] if dry_run else []), "--yes"]
    want = run_cli(j_main.main, ["--config", str(config), *args], capsys)
    got = run_cli(t_main.main, [*args, "--config", str(config), "--device", "cpu"], capsys)
    assert got == want and got.startswith("Deploying payment-api to staging...")


def test_cli_checkpoint_prints_jax_output(tmp_path, monkeypatch, capsys):
    """``checkpoint list|show|delete`` over the same investigation
    checkpoints print the JAX CLI's lines and exit codes."""
    from runbookai_tpu_torch.agent.state_machine import InvestigationStateMachine
    from runbookai_tpu_torch.session.checkpoint import CheckpointStore

    argvs = [["checkpoint", "list"], ["checkpoint", "show", "cp-missing"],
             ["checkpoint", "delete", "cp-missing"]]
    out = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        (d / ".runbook").mkdir(parents=True)
        m = InvestigationStateMachine(incident_id="PD-9")
        m.add_hypothesis("pool exhaustion", priority=0.7)
        meta = CheckpointStore(d / ".runbook" / "checkpoints").save_machine(m, label="mid")
        monkeypatch.chdir(d)
        main = j_main.main if pkg == "jax" else t_main.main
        runs = argvs + [["checkpoint", "list", "--investigation", "PD-9"],
                        ["checkpoint", "show", meta.checkpoint_id],
                        ["checkpoint", "delete", meta.checkpoint_id], ["checkpoint", "list"]]
        rcs = [main(argv) for argv in runs]
        text = capsys.readouterr().out.replace(meta.checkpoint_id, "<cp>")
        out[pkg] = (rcs, re.sub(r'"(created_at|timestamp|saved_at)": [0-9.e+]+', "<t>", text))
    assert out["port"] == out["jax"]
    assert out["port"][0] == [0, 1, 1, 0, 0, 0, 0] and "deleted" in out["port"][1]
