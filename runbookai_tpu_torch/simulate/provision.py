"""Real-infrastructure incident mode: the plan and its dry-run rendering
(from the JAX package's ``simulate/provision.py``).

The reference's simulator can provision ACTUAL broken AWS resources and
open a live PagerDuty incident (``scripts/simulate/setup-incidents.sh:1-624``,
``docs/SIMULATE_INCIDENTS.md``). The simulator is fixtures-first by design
(credential-free, deterministic ground truth); this module maps every
generated fault family onto a concrete break/observe/teardown recipe over
boto3 and prints it as a dry-run plan, offline.

    python -m runbookai_tpu_torch simulate provision scenario.json   # plan

``--apply``, which executes the break steps against real AWS, raises
``NotImplementedError`` (ROADMAP.md queue 1 item 10, the real-provider
tools). The plan keeps the JAX package's safety marks:

- The CLI prints the FULL plan — teardown steps first.
- Resources the recipe CREATES carry the ``runbook-simulate=<id>`` tag.
  Steps that MUTATE pre-existing resources by name cannot be tag-scoped;
  ``render()`` marks each of them ``[mutates existing]``.
- Steps with site-specific inputs (certificate bodies, instance ids,
  original security groups) carry ``needs``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from runbookai_tpu_torch.unported import unported


@dataclass
class ProvisionStep:
    service: str
    action: str
    params: dict[str, Any]
    purpose: str
    creates: bool = False  # True: makes a tagged resource; False: mutates
    needs: tuple[str, ...] = ()  # operator inputs required before apply

    def describe(self) -> str:
        marks = []
        if not self.creates:
            marks.append("[mutates existing]")
        if self.needs:
            marks.append(f"[needs: {', '.join(self.needs)}]")
        suffix = (" " + " ".join(marks)) if marks else ""
        return (f"{self.service}:{self.action} {self.params} — "
                f"{self.purpose}{suffix}")


@dataclass
class ProvisionPlan:
    scenario_id: str
    fault_type: str
    break_steps: list[ProvisionStep] = field(default_factory=list)
    teardown_steps: list[ProvisionStep] = field(default_factory=list)

    def render(self) -> str:
        lines = [f"provision plan for {self.scenario_id} "
                 f"({self.fault_type}) — created resources tagged "
                 f"runbook-simulate={self.scenario_id}"]
        lines.append("  teardown (run these to undo, in order):")
        for s in self.teardown_steps:
            lines.append(f"    {s.describe()}")
        lines.append("  break:")
        for s in self.break_steps:
            lines.append(f"    {s.describe()}")
        return "\n".join(lines)


def _tag(scenario_id: str) -> list[dict]:
    return [{"Key": "runbook-simulate", "Value": scenario_id}]


def provision_plan(scenario) -> ProvisionPlan:
    """Map a generated scenario onto real-AWS break/teardown steps.

    Each fault family gets the smallest real mutation that reproduces its
    signal chain (mirroring setup-incidents.sh's scenarios: broken
    security group, broken task revision, expired-cert import, throttled
    table, clamped connection pool)."""
    root = scenario.truth["root_cause_service"]
    sid = scenario.scenario_id
    fault = scenario.truth["fault_type"]
    p = ProvisionPlan(scenario_id=sid, fault_type=fault)

    def step(lst, _svc, _action, _purpose, _creates=False, _needs=(),
             **params):
        lst.append(ProvisionStep(_svc, _action, params, _purpose,
                                 creates=_creates, needs=tuple(_needs)))

    if fault in ("db_pool_exhaustion", "slow_downstream", "cache_stampede"):
        step(p.break_steps, "rds", "modify_db_parameter_group",
             "clamp max_connections so the pool exhausts under load",
             _needs=("DBParameterGroupName of the live instance",),
             Parameters=[{"ParameterName": "max_connections",
                          "ParameterValue": "8",
                          "ApplyMethod": "immediate"}])
        step(p.teardown_steps, "rds", "reset_db_parameter_group",
             "restore engine-default max_connections",
             _needs=("DBParameterGroupName of the live instance",),
             ResetAllParameters=True)
    elif fault in ("memory_leak_oom", "crashloop_bad_config",
                   "bad_deploy_5xx"):
        step(p.break_steps, "ecs", "register_task_definition",
             "register a broken revision (bad env/limits)", _creates=True,
             family=f"{root}-sim", memory="128",
             containerDefinitions=[{"name": root, "memory": 128,
                                    "environment": [
                                        {"name": "SIM_FAULT",
                                         "value": fault}]}],
             tags=[{"key": "runbook-simulate", "value": sid}])
        step(p.break_steps, "ecs", "update_service",
             "point the service at the broken revision",
             _needs=("cluster name",),
             service=root, taskDefinition=f"{root}-sim")
        step(p.teardown_steps, "ecs", "update_service",
             "roll back to the previous task definition",
             _needs=("cluster name", "previous taskDefinition revision"),
             service=root)
        step(p.teardown_steps, "ecs", "deregister_task_definition",
             "remove the broken revision",
             _needs=("broken revision ARN from the apply output",))
    elif fault == "cert_expiry":
        step(p.break_steps, "acm", "import_certificate",
             "import an already-expired certificate onto the listener",
             _creates=True,
             _needs=("Certificate/PrivateKey PEM of an expired cert",
                     "listener ARN to swap"),
             Tags=_tag(sid))
        step(p.teardown_steps, "elbv2", "modify_listener",
             "restore the valid certificate on the listener",
             _needs=("listener ARN", "original certificate ARN"))
        step(p.teardown_steps, "acm", "delete_certificate",
             "remove the expired certificate",
             _needs=("imported certificate ARN from the apply output",))
    elif fault == "disk_full":
        step(p.break_steps, "ssm", "send_command",
             "fallocate a file filling the data volume to >95%",
             _needs=("InstanceIds of the service hosts",),
             DocumentName="AWS-RunShellScript",
             Parameters={"commands": [
                 f"fallocate -l 95% /var/data/runbook-sim-{sid}.fill"]})
        step(p.teardown_steps, "ssm", "send_command",
             "remove the fill file",
             _needs=("InstanceIds of the service hosts",),
             DocumentName="AWS-RunShellScript",
             Parameters={"commands": [
                 f"rm -f /var/data/runbook-sim-{sid}.fill"]})
    elif fault == "throttling_quota":
        step(p.break_steps, "dynamodb", "update_table",
             "drop provisioned throughput to 1 RCU/WCU",
             TableName=f"{root}-table",
             ProvisionedThroughput={"ReadCapacityUnits": 1,
                                    "WriteCapacityUnits": 1})
        step(p.break_steps, "dynamodb", "tag_resource",
             "tag the throttled table for audit",
             _needs=("table ARN",), Tags=_tag(sid))
        step(p.teardown_steps, "dynamodb", "update_table",
             "restore provisioned throughput",
             _needs=("original RCU/WCU from the apply output",),
             TableName=f"{root}-table")
    elif fault in ("network_partition", "dns_failure"):
        step(p.break_steps, "ec2", "create_security_group",
             "empty security group (denies everything) for the partition",
             _creates=True, _needs=("VpcId",),
             GroupName=f"runbook-sim-{sid}",
             Description="simulated partition",
             TagSpecifications=[{"ResourceType": "security-group",
                                 "Tags": _tag(sid)}])
        step(p.break_steps, "ec2", "modify_instance_attribute",
             "swap the service's instances onto the deny-all group",
             _needs=("InstanceId per host", "deny-all group id from step 1"))
        step(p.teardown_steps, "ec2", "modify_instance_attribute",
             "restore the original security groups",
             _needs=("InstanceId per host", "original group ids"))
        step(p.teardown_steps, "ec2", "delete_security_group",
             "delete the deny-all group",
             _needs=("deny-all group id from the apply output",))
    else:  # future families land here explicitly, not silently
        raise ValueError(f"no real-infra recipe for fault {fault!r}")
    return p


def apply_plan(plan: ProvisionPlan) -> str:
    """Execute the break steps: refused. The real-infrastructure mode
    drives boto3, which waits for the real-provider tools."""
    raise unported("`simulate provision --apply` (real AWS infrastructure over boto3)",
                   "queue 1 item 10")

