"""The incident simulator (a copy of the JAX package's ``simulate/``).

``generator.py``: generated fault scenarios for the fixture providers. A
seeded generator perturbs the simulated-provider fixtures
(``tools/simulated.py``) into NOVEL failure states — random topology,
random root cause, fault-specific telemetry — so every investigation
faces an incident that exists in no checked-in fixture, with
machine-checkable ground truth for the eval suite. ``provision.py``: the
same scenarios as real-AWS break/teardown plans, dry run only.

The JAX package's traffic half (``traffic.py``: the seeded serving-workload
mix that its chaos soak drives) is ported with the soak, ROADMAP.md
queue 1 item 9.
"""

from runbookai_tpu_torch.simulate.generator import (
    ADVERSARIAL_MODES,
    FAULT_TYPES,
    Scenario,
    generate_scenario,
    generate_scenarios,
    to_eval_case,
    write_scenarios,
)

__all__ = [
    "ADVERSARIAL_MODES",
    "FAULT_TYPES",
    "Scenario",
    "generate_scenario",
    "generate_scenarios",
    "to_eval_case",
    "write_scenarios",
]
