"""Interactive onboarding wizard (``runbook init --interactive``).

Parity target: reference ``src/cli/setup-wizard.tsx`` +
``src/config/onboarding.ts`` — the answers model (:20-52), config generation
(`generateConfig` :57), dual-file save (services.yaml + config.yaml,
`saveConfig` :107-227), re-edit **hydration** of an existing config
(`loadServiceConfig` :229), and the quick-setup templates
(``config/services.ts`` ``EXAMPLE_CONFIGS`` :193).

The Ink select/multiselect UI becomes a prompt-driven flow with an
injectable ``ask`` callable so tests can script it; the provider enum gains
the ``jax-tpu`` backend (the north-star default).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

from runbookai_tpu_torch.utils.config import (
    Config,
    ServiceEntry,
    ServicesConfig,
    load_config,
    load_services,
    save_config,
)

Ask = Callable[[str, str], str]  # (question, default) -> answer


@dataclass
class OnboardingAnswers:
    llm_provider: str = "jax-tpu"  # jax-tpu | mock (hosted providers are replaced by the TPU backend)
    llm_model: str = "llama3-8b-instruct"
    account_setup: str = "single"  # single | multi | skip
    account_names: list[str] = field(default_factory=lambda: ["production"])
    regions: list[str] = field(default_factory=lambda: ["us-east-1"])
    compute_services: list[str] = field(default_factory=list)
    database_services: list[str] = field(default_factory=list)
    use_cloudwatch: bool = True
    use_kubernetes: bool = False
    incident_provider: str = "none"  # pagerduty | opsgenie | none
    use_slack_gateway: bool = False
    slack_mode: str = "socket"
    knowledge_path: str = "./docs/runbooks"
    simulated: bool = False


QUICK_TEMPLATES: dict[str, OnboardingAnswers] = {
    # EXAMPLE_CONFIGS parity: minimal web app / serverless / multi-account.
    "web-app": OnboardingAnswers(
        compute_services=["ecs", "ec2"], database_services=["rds"],
        incident_provider="pagerduty"),
    "serverless": OnboardingAnswers(
        compute_services=["lambda", "apprunner"],
        database_services=["dynamodb"]),
    "kubernetes": OnboardingAnswers(
        compute_services=["eks"], use_kubernetes=True,
        incident_provider="pagerduty"),
    "multi-account": OnboardingAnswers(
        account_setup="multi", account_names=["production", "staging"],
        compute_services=["ecs"], database_services=["rds", "elasticache"]),
    "simulated": OnboardingAnswers(llm_provider="mock", simulated=True,
                                   compute_services=["ecs"],
                                   incident_provider="pagerduty"),
}


def generate_configs(answers: OnboardingAnswers) -> tuple[Config, ServicesConfig]:
    """Answers → (config.yaml model, services.yaml model) (onboarding.ts:57)."""
    accounts = [
        {"name": name, "regions": answers.regions, "isDefault": i == 0}
        for i, name in enumerate(answers.account_names)
    ] if answers.account_setup != "skip" else []

    services = [
        ServiceEntry(name=f"{svc}-workloads", type=svc,
                     tags=["compute"], aws={"service": svc})
        for svc in answers.compute_services if svc != "none"
    ] + [
        ServiceEntry(name=f"{db}-primary", type=db, tags=["database"],
                     aws={"service": db})
        for db in answers.database_services if db != "none"
    ]
    services_config = ServicesConfig(accounts=accounts, services=services)

    kubernetes_enabled = answers.use_kubernetes or (
        "eks" in answers.compute_services)
    config = Config.model_validate({
        "llm": {"provider": answers.llm_provider, "model": answers.llm_model},
        "providers": {
            "aws": {"enabled": bool(accounts) or answers.simulated,
                    "simulated": answers.simulated,
                    "regions": answers.regions},
            "kubernetes": {"enabled": kubernetes_enabled or answers.simulated,
                           "simulated": answers.simulated},
        },
        "observability": {
            "datadog": {"enabled": False},
            "prometheus": {"enabled": False},
        },
        "incident": {
            "pagerduty": {"enabled": answers.incident_provider == "pagerduty",
                          "simulated": answers.simulated},
            "opsgenie": {"enabled": answers.incident_provider == "opsgenie"},
            "slack": {"enabled": answers.use_slack_gateway,
                      "mode": answers.slack_mode},
        },
        "knowledge": {"sources": [
            {"type": "filesystem", "name": "runbooks",
             "path": answers.knowledge_path},
        ]},
    })
    return config, services_config


def hydrate_answers(config_dir: str | Path = ".runbook") -> OnboardingAnswers:
    """Pre-fill the wizard from an existing config (re-edit flow, :229)."""
    answers = OnboardingAnswers()
    config_dir = Path(config_dir)
    try:
        config = load_config(config_dir / "config.yaml")
    except FileNotFoundError:
        return answers
    answers.llm_provider = config.llm.provider
    answers.llm_model = config.llm.model
    answers.use_kubernetes = config.providers.kubernetes.enabled
    answers.simulated = config.providers.aws.simulated
    if config.incident.pagerduty.enabled:
        answers.incident_provider = "pagerduty"
    elif config.incident.opsgenie.enabled:
        answers.incident_provider = "opsgenie"
    answers.use_slack_gateway = config.incident.slack.enabled
    answers.slack_mode = config.incident.slack.mode
    for src in config.knowledge.sources:
        if src.type == "filesystem" and src.path:
            answers.knowledge_path = src.path
            break
    try:
        services = load_services(config_dir / "services.yaml")
        if services.accounts:
            answers.account_names = [str(a.get("name", "account"))
                                     for a in services.accounts]
            answers.account_setup = ("multi" if len(services.accounts) > 1
                                     else "single")
            answers.regions = list(services.accounts[0].get(
                "regions", answers.regions))
        answers.compute_services = sorted({
            s.type for s in services.services if "compute" in s.tags})
        answers.database_services = sorted({
            s.type for s in services.services if "database" in s.tags})
    except FileNotFoundError:
        pass
    return answers


def _default_ask(question: str, default: str) -> str:
    suffix = f" [{default}]" if default else ""
    reply = input(f"{question}{suffix}: ").strip()
    return reply or default


def run_wizard(ask: Ask = _default_ask,
               base: Optional[OnboardingAnswers] = None) -> OnboardingAnswers:
    """Prompt-driven flow mirroring the Ink wizard's question order."""
    answers = base or OnboardingAnswers()
    template = ask("Quick template (web-app/serverless/kubernetes/"
                   "multi-account/simulated/custom)", "custom")
    if template in QUICK_TEMPLATES:
        return QUICK_TEMPLATES[template]

    answers.llm_provider = ask("LLM provider (jax-tpu/mock)", answers.llm_provider)
    answers.llm_model = ask("Model", answers.llm_model)
    answers.account_setup = ask("AWS accounts (single/multi/skip)",
                                answers.account_setup)
    if answers.account_setup == "multi":
        names = ask("Account names (comma-separated)",
                    ",".join(answers.account_names))
        answers.account_names = [n.strip() for n in names.split(",") if n.strip()]
    elif answers.account_setup == "skip":
        answers.account_names = []
    regions = ask("Regions (comma-separated)", ",".join(answers.regions))
    answers.regions = [r.strip() for r in regions.split(",") if r.strip()]
    compute = ask("Compute services (ecs,ec2,lambda,eks,apprunner,amplify or none)",
                  ",".join(answers.compute_services) or "none")
    answers.compute_services = [c.strip() for c in compute.split(",")
                                if c.strip() and c.strip() != "none"]
    databases = ask("Databases (rds,dynamodb,elasticache,documentdb or none)",
                    ",".join(answers.database_services) or "none")
    answers.database_services = [d.strip() for d in databases.split(",")
                                 if d.strip() and d.strip() != "none"]
    answers.use_kubernetes = ask("Use Kubernetes? (y/n)",
                                 "y" if answers.use_kubernetes else "n") == "y"
    answers.incident_provider = ask("Incident provider (pagerduty/opsgenie/none)",
                                    answers.incident_provider)
    answers.use_slack_gateway = ask("Enable Slack gateway? (y/n)",
                                    "y" if answers.use_slack_gateway else "n") == "y"
    if answers.use_slack_gateway:
        answers.slack_mode = ask("Slack mode (socket/http)", answers.slack_mode)
    answers.knowledge_path = ask("Runbooks directory", answers.knowledge_path)
    return answers


def save_wizard_configs(answers: OnboardingAnswers,
                        config_dir: str | Path = ".runbook") -> tuple[Path, Path]:
    """Write both YAMLs (onboarding.ts saveConfig :107-227)."""
    import yaml

    config_dir = Path(config_dir)
    config_dir.mkdir(parents=True, exist_ok=True)
    config, services = generate_configs(answers)
    config_path = config_dir / "config.yaml"
    save_config(config, config_path)
    services_path = config_dir / "services.yaml"
    services_path.write_text(yaml.safe_dump(
        services.model_dump(mode="json"), sort_keys=False))
    return config_path, services_path
