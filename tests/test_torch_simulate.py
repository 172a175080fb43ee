"""The port's incident simulator (``runbookai_tpu_torch/simulate``) against
the JAX package's, on the CPU.

Generated scenarios equal JAX's JSON for JSON for every fault family,
every adversarial mode and the seed mix; ``to_eval_case``,
``write_scenarios`` and the provision plans' rendering are equal;
``--apply`` is refused; the injected-fault agent run of
``tests/test_simulate.py`` runs on the port. ``time.time`` is pinned: the
simulated tools stamp their records with it.
"""

import dataclasses
import json
import os
import time

import pytest
import torch

import runbookai_tpu.simulate as j_sim
import runbookai_tpu.simulate.generator as j_gen
import runbookai_tpu.simulate.provision as j_prov
import runbookai_tpu_torch.simulate as t_sim
import runbookai_tpu_torch.simulate.provision as t_prov
from runbookai_tpu_torch.agent.agent import Agent
from runbookai_tpu_torch.agent.types import LLMResponse, ToolCall
from runbookai_tpu_torch.model.client import MockLLMClient
from runbookai_tpu_torch.tools import simulated as sim_tools
from runbookai_tpu_torch.tools.registry import ToolRegistry

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores

FROZEN_NOW = 1_790_000_000.0
FAULTS = sorted(j_sim.FAULT_TYPES)
MODES = [*j_sim.ADVERSARIAL_MODES, "mix", None]


@pytest.fixture(autouse=True)
def frozen_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: FROZEN_NOW)


def test_fault_families_and_modes_equal_jax():
    assert sorted(t_sim.FAULT_TYPES) == FAULTS and len(FAULTS) == 11
    assert t_sim.ADVERSARIAL_MODES == j_sim.ADVERSARIAL_MODES


@pytest.mark.parametrize("mode", MODES, ids=[str(m) for m in MODES])
@pytest.mark.parametrize("fault", FAULTS)
def test_generate_scenario_equal_jax(fault, mode):
    """One scenario per (fault family, adversarial mode): the same JSON."""
    for seed in (5, 1234):
        got = t_sim.generate_scenario(seed, fault_type=fault, adversarial=mode)
        want = j_sim.generate_scenario(seed, fault_type=fault, adversarial=mode)
        assert got.to_json() == want.to_json()
        assert t_sim.Scenario.from_json(got.to_json()).to_json() == got.to_json()


@pytest.mark.parametrize("mode", MODES, ids=[str(m) for m in MODES])
def test_generate_scenarios_seed_mix_equal_jax(mode):
    """The seed's own fault draw over 12 seeds, with served-model groups
    assigned round-robin."""
    for models in (None, ["a", "b"]):
        got = t_sim.generate_scenarios(12, seed=40, adversarial=mode, models=models)
        want = j_sim.generate_scenarios(12, seed=40, adversarial=mode, models=models)
        assert [s.to_json() for s in got] == [s.to_json() for s in want]
    assert len({s.truth["fault_type"] for s in got}) > 3


def test_unknown_adversarial_mode_raises_as_jax():
    with pytest.raises(ValueError) as got:
        t_sim.generate_scenario(1, adversarial="louder")
    with pytest.raises(ValueError) as want:
        j_sim.generate_scenario(1, adversarial="louder")
    assert str(got.value) == str(want.value)


def test_to_eval_case_and_write_scenarios_equal_jax(tmp_path):
    got = t_sim.generate_scenarios(6, seed=3, adversarial="mix", models=["m"])
    want = j_sim.generate_scenarios(6, seed=3, adversarial="mix", models=["m"])
    for g, w in zip(got, want):
        assert dataclasses.asdict(t_sim.to_eval_case(g)) == dataclasses.asdict(
            j_sim.to_eval_case(w))
    t_paths = t_sim.write_scenarios(got, tmp_path / "t")
    j_paths = j_gen.write_scenarios(want, tmp_path / "j")
    assert [p.name for p in t_paths] == [p.name for p in j_paths]
    for t, j in zip(t_paths, j_paths):
        assert t.read_text() == j.read_text()


@pytest.mark.parametrize("fault", FAULTS)
def test_provision_plan_renders_as_jax(fault):
    """Every family's plan, teardown before break, rendered the same."""
    s = t_sim.generate_scenario(100, fault_type=fault)
    got = t_prov.provision_plan(s)
    want = j_prov.provision_plan(j_sim.generate_scenario(100, fault_type=fault))
    assert got.render() == want.render()
    assert got.break_steps and got.teardown_steps
    rendered = got.render()
    assert rendered.index("teardown") < rendered.index("break:")


def test_provision_apply_is_unported():
    s = t_sim.generate_scenario(7, fault_type="throttling_quota")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 10"):
        t_prov.apply_plan(t_prov.provision_plan(s))


async def test_agent_investigates_injected_fault_end_to_end(tmp_path):
    """test_simulate.py's end-to-end run on the port: the agent's tools
    surface an injected fault that exists in no checked-in fixture."""
    s = t_sim.generate_scenario(77, fault_type="disk_full")
    root = s.truth["root_cause_service"]
    reg = ToolRegistry()
    sim = sim_tools.SimulatedCloud(s.fixtures)
    sim_tools.register_aws(reg, sim)
    sim_tools.register_kubernetes(reg, sim)
    sim_tools.register_incident(reg, sim, None)

    def tc(name, args):
        return ToolCall(id=f"c-{name}", name=name, args=args)

    llm = MockLLMClient([
        LLMResponse(content="", tool_calls=[
            tc("cloudwatch_alarms", {"state": "ALARM"}),
            tc("cloudwatch_logs", {"log_group": f"/ecs/{root}"}),
        ]),
        LLMResponse(content=f"Root cause: {root} disk full — writes "
                            "failing with ENOSPC. confidence high"),
    ])
    agent = Agent(llm, reg.all(), scratchpad_root=str(tmp_path), persist=False)
    events = [e async for e in agent.run(s.query, incident_id=s.scenario_id)]
    assert [e.kind for e in events].count("tool_result") == 2
    assert root in llm.calls[1]["user"]
    results = [e.data for e in events if e.kind == "tool_result"]
    assert any("disk" in json.dumps(r).lower() or "space" in json.dumps(r).lower()
               for r in results)
    answer = next(e for e in events if e.kind == "answer")
    assert "disk full" in answer.data["text"]
