"""Seeded incident-scenario generator (a copy of the JAX package's
``simulate/generator.py``; see the package docstring).

A scenario is built in three steps:

1. **Topology** — sample 3-5 services from a name pool into a call chain
   (edge service → mid tier → stateful backend), so blast radius and
   "which service do the symptoms point at" differ per seed.
2. **Fault** — sample a fault template and a root-cause service. Each
   template emits the full signal chain the real incident would leave:
   alarms, fault-specific log lines, k8s state, a metric step-change,
   a PagerDuty incident, and (for deploy-caused faults) the culprit PR.
3. **Propagation** — upstream services get secondary symptoms (latency
   alarms, timeout logs) so the agent must walk the chain instead of
   pattern-matching the first alarm.

Ground truth rides in :class:`Scenario.truth` and converts straight into
an :class:`~runbookai_tpu_torch.evalsuite.scoring.EvalCase` (fixtures override +
expected root cause + keywords), so ``simulate eval --n N`` scores
investigations against incidents that exist in no checked-in fixture.

Reference parity: scripts/simulate/setup-incidents.sh (real-infra mode);
this generator is the credential-free equivalent covering eleven fault
families instead of one.
"""

from __future__ import annotations

import json
import random
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

# ----------------------------------------------------------------- pools

_EDGE = ["checkout-api", "storefront-web", "mobile-gateway", "partner-api",
         "admin-portal"]
_MID = ["cart-service", "pricing-service", "auth-service", "search-api",
        "billing-worker", "notification-service", "inventory-sync"]
_BACKEND = ["orders-db", "ledger-db", "session-cache", "catalog-db",
            "events-queue", "blob-store"]

_REGIONS = ["us-east-1", "us-west-2", "eu-central-1"]


_BASE_EPOCH = 1_767_225_600  # 2026-01-01T00:00:00Z

# Seed-derived clock base, set per generate_scenario call: same seed →
# byte-identical scenarios (files regenerate reproducibly; the
# determinism test cannot flake across a wall-clock second boundary).
# Module-global + lock (not a threaded-through parameter) keeps the
# eleven fault templates' signatures flat; generation is cheap enough
# that serializing concurrent callers costs nothing.
_ts_base = [_BASE_EPOCH]
_gen_lock = threading.Lock()


def _ts(minutes_ago: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ",
                         time.gmtime(_ts_base[0] - minutes_ago * 60))


@dataclass
class Scenario:
    scenario_id: str
    query: str
    fixtures: dict[str, Any]
    truth: dict[str, Any] = field(default_factory=dict)
    # Served model group this investigation should run against (multi-
    # model fleets): `runbook eval --simulate` / `simulate eval --models`
    # assign groups round-robin so the generated load exercises
    # model-field routing; None = the default model (single-model runs
    # are unchanged).
    model: str | None = None

    def to_json(self) -> str:
        doc = {"scenario_id": self.scenario_id,
               "query": self.query, "truth": self.truth,
               "fixtures": self.fixtures}
        if self.model is not None:
            doc["model"] = self.model
        return json.dumps(doc, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Scenario":
        d = json.loads(text)
        return cls(scenario_id=d["scenario_id"], query=d["query"],
                   fixtures=d["fixtures"], truth=d.get("truth", {}),
                   model=d.get("model"))


# ------------------------------------------------------------ fault kit
#
# Each fault template returns the ROOT service's telemetry:
#   alarms, logs, k8s pod states, metric shape, pd description, keywords
# and whether a deploy/PR is the culprit.

def _f_db_pool(svc, dep, rng):
    size = rng.choice([10, 15, 20])
    return {
        "alarm_metric": ("DatabaseConnections", 90, 99),
        "logs": [
            ("ERROR", f"connection pool exhausted: size {size} "
                      f"(reduced in last deploy), 214 waiting"),
            ("ERROR", "FATAL: remaining connection slots are reserved"),
        ],
        "pods": "Running",
        "deploy_culprit": True,
        "diff_hint": f"max_pool_size: 50 -> {size}",
        "pd": f"{svc} database connection pool exhausted",
        "keywords": ["connection pool", "deploy"],
        "root_cause": f"{svc} deploy shrank the DB connection pool to "
                      f"{size}, exhausting connections under load",
    }


def _f_oom(svc, dep, rng):
    mb = rng.choice([512, 1024, 2048])
    return {
        "alarm_metric": ("MemoryUtilization", 90, 99),
        "logs": [
            ("ERROR", f"java.lang.OutOfMemoryError: Java heap space "
                      f"(limit {mb}M)"),
            ("WARN", "GC overhead limit: 97% time in GC, 2% heap "
                     "recovered"),
        ],
        "pods": "OOMKilled",
        "deploy_culprit": False,
        "pd": f"{svc} pods OOMKilled repeatedly",
        "keywords": ["oom", "memory"],
        "root_cause": f"{svc} memory leak — heap exhaustion "
                      f"({mb}M limit) causing OOMKilled restarts",
    }


def _f_bad_deploy(svc, dep, rng):
    ver = f"{rng.randint(2, 9)}.{rng.randint(0, 30)}.{rng.randint(0, 9)}"
    return {
        "alarm_metric": ("HTTPCode_Target_5XX_Count", 25, rng.randint(300, 900)),
        "logs": [
            ("ERROR", f"NullPointerException at FeatureFlagResolver.get "
                      f"(introduced in {svc}:{ver})"),
            ("ERROR", "500 Internal Server Error on 38% of requests"),
        ],
        "pods": "Running",
        "deploy_culprit": True,
        "diff_hint": "feature-flag resolver refactor",
        "pd": f"{svc} 5xx spike after deploy {ver}",
        "keywords": ["deploy", "5xx"],
        "root_cause": f"bad deploy {svc}:{ver} — NPE in feature-flag "
                      f"resolver returning 500s",
    }


def _f_cert_expiry(svc, dep, rng):
    return {
        "alarm_metric": ("TLSNegotiationErrorCount", 10, rng.randint(200, 600)),
        "logs": [
            ("ERROR", "SSLHandshakeException: certificate expired "
                      f"(notAfter={_ts(110)})"),
            ("ERROR", f"outbound call to {dep or 'upstream'} failed: "
                      "x509: certificate has expired"),
        ],
        "pods": "Running",
        "deploy_culprit": False,
        "pd": f"{svc} TLS certificate expired",
        "keywords": ["certificate", "expired"],
        "root_cause": f"{svc} TLS certificate expired; all downstream "
                      "calls failing handshake",
    }


def _f_disk_full(svc, dep, rng):
    return {
        "alarm_metric": ("FreeStorageSpace", 5.0, 0.3),
        "logs": [
            ("ERROR", "No space left on device: cannot write WAL segment"),
            ("WARN", "disk usage 99.7% on /var/lib/data"),
        ],
        "pods": "Running",
        "deploy_culprit": False,
        "pd": f"{svc} storage exhausted",
        "keywords": ["disk", "space"],
        "root_cause": f"{svc} disk full (WAL/log growth); writes failing "
                      "with ENOSPC",
    }


def _f_cache_stampede(svc, dep, rng):
    return {
        "alarm_metric": ("CacheMisses", 1000, rng.randint(40000, 90000)),
        "logs": [
            ("WARN", "cache hit rate dropped 98% -> 3% after key "
                     "namespace flush"),
            ("ERROR", f"backend {dep or 'db'} latency 40x baseline under "
                      "stampede load"),
        ],
        "pods": "Running",
        "deploy_culprit": False,
        "pd": f"{svc} cache stampede overloading backend",
        "keywords": ["cache", "stampede"],
        "root_cause": f"{svc} cache flush caused a stampede; "
                      f"{dep or 'the backend'} overloaded by miss traffic",
    }


def _f_throttling(svc, dep, rng):
    return {
        "alarm_metric": ("ThrottledRequests", 50, rng.randint(2000, 8000)),
        "logs": [
            ("ERROR", "ThrottlingException: Rate exceeded (quota 1000 rps)"),
            ("WARN", "retry storm: 6.4x request amplification from "
                     "aggressive retries"),
        ],
        "pods": "Running",
        "deploy_culprit": False,
        "pd": f"{svc} hitting provider rate limits",
        "keywords": ["throttl", "quota"],
        "root_cause": f"{svc} exceeding API quota; retry storm amplifying "
                      "throttled traffic",
    }


def _f_crashloop_config(svc, dep, rng):
    key = rng.choice(["DATABASE_URL", "REDIS_ENDPOINT", "OAUTH_ISSUER"])
    return {
        "alarm_metric": ("HealthyHostCount", 2, 0),
        "logs": [
            ("FATAL", f"config error: required key {key} is unset"),
            ("ERROR", "container exited with code 1 during startup"),
        ],
        "pods": "CrashLoopBackOff",
        "deploy_culprit": True,
        "diff_hint": f"config map refactor dropped {key}",
        "pd": f"{svc} pods crashlooping after config change",
        "keywords": ["config", "crashloop"],
        "root_cause": f"config change dropped {key}; {svc} crashloops at "
                      "startup",
    }


def _f_network_partition(svc, dep, rng):
    az = rng.choice(["a", "b", "c"])
    return {
        "alarm_metric": ("TargetConnectionErrorCount", 20, rng.randint(400, 2000)),
        "logs": [
            ("ERROR", f"connect timeout to {dep or 'peer'}:5432 "
                      f"(az-{az} unreachable)"),
            ("WARN", f"50% of cross-az traffic failing in az-{az}"),
        ],
        "pods": "Running",
        "deploy_culprit": False,
        "pd": f"{svc} network errors to {dep or 'backend'} in az-{az}",
        "keywords": ["network", "timeout"],
        "root_cause": f"network partition in az-{az} between {svc} and "
                      f"{dep or 'its backend'}",
    }


def _f_slow_downstream(svc, dep, rng):
    return {
        "alarm_metric": ("TargetResponseTime", 1.5, round(rng.uniform(4, 9), 2)),
        "logs": [
            ("WARN", f"call to {dep or 'downstream'} took 8214ms "
                     "(budget 800ms)"),
            ("ERROR", "request queue saturated: 412 in-flight, shedding "
                      "load"),
        ],
        "pods": "Running",
        "deploy_culprit": False,
        "pd": f"{svc} latency SLO breach",
        "keywords": ["latency", "downstream"],
        "root_cause": f"{dep or 'a downstream dependency'} slowdown "
                      f"saturating {svc}'s request queue",
    }


def _f_dns_failure(svc, dep, rng):
    return {
        "alarm_metric": ("DNSResolutionErrors", 5, rng.randint(100, 900)),
        "logs": [
            ("ERROR", f"getaddrinfo ENOTFOUND {dep or 'internal'}"
                      ".prod.svc.cluster.local"),
            ("WARN", "ndots/resolv.conf misconfiguration after node image "
                     "rollout"),
        ],
        "pods": "Running",
        "deploy_culprit": False,
        "pd": f"{svc} DNS resolution failures",
        "keywords": ["dns", "resolution"],
        "root_cause": f"DNS resolution broken for {svc} after node image "
                      "rollout (resolv.conf misconfiguration)",
    }


FAULT_TYPES: dict[str, Any] = {
    "db_pool_exhaustion": _f_db_pool,
    "memory_leak_oom": _f_oom,
    "bad_deploy_5xx": _f_bad_deploy,
    "cert_expiry": _f_cert_expiry,
    "disk_full": _f_disk_full,
    "cache_stampede": _f_cache_stampede,
    "throttling_quota": _f_throttling,
    "crashloop_bad_config": _f_crashloop_config,
    "network_partition": _f_network_partition,
    "slow_downstream": _f_slow_downstream,
    "dns_failure": _f_dns_failure,
}


# ------------------------------------------------------------- generator

# Adversarial variants (VERDICT r4 next-round #4): the base templates and
# causal_query's patterns were written by the same hand, so a keyword-
# overlap "investigation" can score well without reasoning. These modes
# are built to break that strategy:
#   misleading_symptom — a louder, WRONG-family signal chain on a visible
#     non-culprit service, STALE relative to incident start (the tell a
#     parrot ignores); parroting the loudest log names the decoy and
#     scores 0 on keywords/services.
#   two_fault — an independent second fault on an off-chain service; the
#     paged incident (and scoring) is the primary's, so "found A fault"
#     is not "found THE fault".
#   signal_dropout — a whole telemetry modality is missing, with a meta
#     signal explaining why (broken log shipper / alarm delivery);
#     the answer must be inferred from the remaining modalities.
ADVERSARIAL_MODES = ("misleading_symptom", "two_fault", "signal_dropout")


def generate_scenario(seed: int, fault_type: str | None = None,
                      adversarial: str | None = None) -> Scenario:
    """One seeded scenario: novel topology + fault + full signal chain.

    ``adversarial`` picks a hardening transform from
    :data:`ADVERSARIAL_MODES` (or ``"mix"`` to rotate by seed)."""
    with _gen_lock:
        s = _generate_locked(seed, fault_type)
        if adversarial:
            mode = adversarial
            if mode == "mix":
                mode = ADVERSARIAL_MODES[seed % len(ADVERSARIAL_MODES)]
            if mode not in ADVERSARIAL_MODES:
                raise ValueError(f"unknown adversarial mode {mode!r}; "
                                 f"valid: {ADVERSARIAL_MODES + ('mix',)}")
            rng = random.Random(seed ^ 0xADE5A1)
            s = _ADVERSARIAL[mode](s, rng)
        return s


def _apply_misleading_symptom(s: Scenario, rng: random.Random) -> Scenario:
    """Red-herring signal chain on a non-culprit service.

    The decoy's fault family differs from the real one and its signals
    are LOUDER (bigger alarm value, FATAL logs) but stale: alarm state
    changed hours before the incident, log timestamps predate it, and a
    recovery event closes the story. An agent that checks timestamps
    walks past it; a keyword parrot reports the decoy and scores 0."""
    root = s.truth["root_cause_service"]
    chain = s.truth["chain"]
    decoy = chain[0] if chain[0] != root else (
        chain[1] if len(chain) > 2 and chain[1] != root else chain[-1])
    if decoy == root:  # degenerate 2-chain with root at the edge
        decoy = chain[-1]
    decoy_fault = rng.choice(sorted(set(FAULT_TYPES)
                                    - {s.truth["fault_type"]}))
    f = FAULT_TYPES[decoy_fault](decoy, None, rng)
    metric, threshold, value = f["alarm_metric"]
    stale = 190 + rng.randint(0, 90)  # minutes before the real incident
    s.fixtures["cloudwatch_alarms"].insert(0, {
        "alarmName": f"{decoy}-{metric}", "state": "ALARM",
        "metric": metric, "threshold": threshold,
        # Louder than the real alarm — the parrot's first pick.
        "currentValue": value if not isinstance(value, (int, float))
        else value * 3,
        "stateChangedAt": _ts(stale), "service": decoy})
    s.fixtures["cloudwatch_logs"][f"/ecs/{decoy}"] = [
        {"ts": _ts(stale + 2 + i), "level": "FATAL" if i == 0 else lvl,
         "message": msg}
        for i, (lvl, msg) in enumerate(f["logs"])]
    # The decoy story CLOSES before the incident starts: self-recovery
    # event visible in datadog — the tell that it is history, not cause.
    s.fixtures["datadog"]["events"].append(
        {"ts": _ts(stale - 12), "title": f"{decoy} recovered",
         "tags": [f"service:{decoy}", "auto-recovery"],
         "text": f"{f['pd']} — self-recovered; no action taken"})
    s.truth["adversarial"] = "misleading_symptom"
    s.truth["decoy_service"] = decoy
    s.truth["decoy_fault_type"] = decoy_fault
    s.truth["decoy_keywords"] = f["keywords"]
    return s


def _apply_two_fault(s: Scenario, rng: random.Random) -> Scenario:
    """Independent concurrent fault on an off-chain service.

    Both faults are live RIGHT NOW; only the primary is what the page is
    about (the query and PD incident are unchanged), so naming the
    secondary is finding A fault, not THE fault. Scoring stays anchored
    to the primary's root cause; the secondary rides in truth for
    per-split reporting."""
    chain = s.truth["chain"]
    candidates = sorted((set(_MID) | set(_BACKEND)) - set(chain))
    second_svc = rng.choice(candidates)
    second_fault = rng.choice(sorted(set(FAULT_TYPES)
                                     - {s.truth["fault_type"]}))
    f = FAULT_TYPES[second_fault](second_svc, None, rng)
    metric, threshold, value = f["alarm_metric"]
    start = rng.randint(10, 45)
    s.fixtures["cloudwatch_alarms"].append({
        "alarmName": f"{second_svc}-{metric}", "state": "ALARM",
        "metric": metric, "threshold": threshold, "currentValue": value,
        "stateChangedAt": _ts(start), "service": second_svc})
    s.fixtures["cloudwatch_logs"][f"/ecs/{second_svc}"] = [
        {"ts": _ts(start + 1 + i), "level": lvl, "message": msg}
        for i, (lvl, msg) in enumerate(f["logs"])]
    s.fixtures["kubernetes"]["pods"].append(
        {"name": f"{second_svc}-{rng.randrange(16**6):06x}-0",
         "namespace": "prod", "status": f["pods"],
         "restarts": rng.randint(3, 11) if f["pods"] != "Running" else 0,
         "age": f"{start + 30}m"})
    s.fixtures["aws"]["ecs"].append(
        {"service": second_svc, "status": "ACTIVE",
         "runningCount": 2 if f["pods"] != "Running" else 3,
         "desiredCount": 3, "pendingCount": 0})
    s.truth["adversarial"] = "two_fault"
    s.truth["secondary"] = {"fault_type": second_fault,
                            "service": second_svc,
                            "root_cause": f["root_cause"]}
    return s


def _apply_signal_dropout(s: Scenario, rng: random.Random) -> Scenario:
    """Drop a whole telemetry modality, with a meta signal saying why.

    Logs/alarms/metrics vanish the way they do in real incidents (broken
    shipper, alarm delivery outage) — the investigation must cross to the
    surviving modalities instead of failing on the empty one."""
    root = s.truth["root_cause_service"]
    dropped = rng.choice(("logs", "alarms", "metrics"))
    if dropped == "logs":
        s.fixtures["cloudwatch_logs"].pop(f"/ecs/{root}", None)
        s.fixtures["kubernetes"]["events"].append(
            {"ts": _ts(30), "type": "Warning", "reason": "DaemonSetDegraded",
             "object": "daemonset/fluent-bit",
             "message": f"log shipper degraded on nodes running {root}; "
                        f"/ecs/{root} not receiving entries"})
    elif dropped == "alarms":
        s.fixtures["cloudwatch_alarms"] = []
        s.fixtures["datadog"]["events"].append(
            {"ts": _ts(35), "title": "CloudWatch alarm delivery degraded",
             "tags": ["provider:aws", "alarms"],
             "text": "alarm actions delayed/dropped; rely on raw metrics "
                     "and prometheus alerts"})
    else:
        s.fixtures["datadog"]["metrics"] = {}
        s.fixtures["datadog"]["events"].append(
            {"ts": _ts(35), "title": "datadog agent fleet degraded",
             "tags": ["provider:datadog"],
             "text": "metric intake gap; dashboards empty for ~1h"})
    s.truth["adversarial"] = "signal_dropout"
    s.truth["dropped"] = dropped
    return s


_ADVERSARIAL = {
    "misleading_symptom": _apply_misleading_symptom,
    "two_fault": _apply_two_fault,
    "signal_dropout": _apply_signal_dropout,
}


def _generate_locked(seed: int, fault_type: str | None) -> Scenario:
    rng = random.Random(seed)
    _ts_base[0] = _BASE_EPOCH + rng.randrange(0, 300 * 24 * 3600)
    edge = rng.choice(_EDGE)
    mids = rng.sample(_MID, rng.randint(1, 2))
    backend = rng.choice(_BACKEND)
    chain = [edge, *mids, backend]
    region = rng.choice(_REGIONS)

    fault_name = fault_type or rng.choice(sorted(FAULT_TYPES))
    # Root cause sits mid-chain or at the backend; symptoms propagate up.
    root_idx = rng.randint(1, len(chain) - 1)
    root = chain[root_idx]
    dep = chain[root_idx + 1] if root_idx + 1 < len(chain) else None
    f = FAULT_TYPES[fault_name](root, dep, rng)

    start = rng.randint(18, 70)  # minutes ago
    metric, threshold, value = f["alarm_metric"]

    alarms = [{"alarmName": f"{root}-{metric}", "state": "ALARM",
               "metric": metric, "threshold": threshold,
               "currentValue": value, "stateChangedAt": _ts(start - 2),
               "service": root}]
    logs = {f"/ecs/{root}": [
        {"ts": _ts(start - 3 - i), "level": lvl, "message": msg}
        for i, (lvl, msg) in enumerate(f["logs"])
    ]}
    pods = [{"name": f"{root}-{rng.randrange(16**6):06x}-{j}",
             "namespace": "prod",
             "status": f["pods"] if j == 0 else "Running",
             # Only the faulted pod of a non-Running fault restarts; a
             # healthy-pod fault must not plant a crashloop red herring.
             "restarts": (rng.randint(4, 19)
                          if f["pods"] != "Running" and j == 0 else 0),
             "age": f"{start + 20}m"} for j in range(2)]
    events = [{"ts": _ts(start - 1), "type": "Warning",
               "reason": "Unhealthy" if f["pods"] == "Running" else "BackOff",
               "object": f"pod/{pods[0]['name']}",
               "message": f["logs"][0][1][:90]}]

    # Upstream propagation: every service above the root sees latency.
    for up in chain[:root_idx]:
        alarms.append({"alarmName": f"{up}-TargetResponseTime",
                       "state": "ALARM", "metric": "TargetResponseTime",
                       "threshold": 1.5,
                       "currentValue": round(rng.uniform(3, 8), 2),
                       "stateChangedAt": _ts(start - 4), "service": up})
        logs[f"/ecs/{up}"] = [
            {"ts": _ts(start - 5), "level": "WARN",
             "message": f"upstream call to {chain[chain.index(up) + 1]} "
                        f"timing out ({rng.randint(2, 9)}s)"}]

    healthy = rng.choice(sorted(set(_MID) - set(chain)))
    ecs = [{"service": s, "status": "ACTIVE",
            "runningCount": 2 if s == root and f["pods"] != "Running" else 3,
            "desiredCount": 3, "pendingCount": 0} for s in chain]
    ecs.append({"service": healthy, "status": "ACTIVE", "runningCount": 2,
                "desiredCount": 2, "pendingCount": 0})

    base = rng.randint(200, 400)
    spike = base * rng.randint(8, 20)
    datadog = {
        "metrics": {f"{edge}.request.latency.p99": {
            "unit": "ms",
            "points": [[_ts(start + 30), base], [_ts(start + 15), base + 20],
                       [_ts(start - 10), spike], [_ts(start - 2), spike],
                       [_ts(5), spike - rng.randint(0, 200)]]}},
        "events": [], "monitors": [
            {"name": f"{edge} p99 latency", "status": "Alert",
             "query": f"avg(last_5m):p99:{edge}.latency > 1500"}],
    }
    github = {}
    if f.get("deploy_culprit"):
        pr = rng.randint(1000, 9999)
        datadog["events"].append(
            {"ts": _ts(start + 3), "title": f"Deployed {root}",
             "tags": [f"service:{root}", "env:prod", "deploy"],
             "text": f"change: {f.get('diff_hint', 'config change')} "
                     f"(PR #{pr})"})
        github[root] = [{"number": pr, "title": f.get("diff_hint", "change"),
                         "mergedAt": _ts(start + 8), "author": "dev-x",
                         "files": ["config/app.yaml"],
                         "diff_hint": f.get("diff_hint", "")}]

    incident_id = f"SIM-{seed}"
    fixtures = {
        "aws": {"ecs": ecs, "rds": [], "lambda": [], "ec2": []},
        "cloudwatch_alarms": alarms,
        "cloudwatch_logs": logs,
        "kubernetes": {
            "pods": pods,
            "deployments": [{"name": s, "namespace": "prod",
                             "replicas": "3/3"} for s in chain],
            "events": events,
            "nodes": [{"name": "node-1", "status": "Ready",
                       "cpu": "58%", "memory": "66%"}],
        },
        "datadog": datadog,
        "prometheus": {"alerts": [
            {"name": metric, "state": "firing",
             "labels": {"service": root, "severity": "page"},
             "activeAt": _ts(start - 2)}], "queries": {}},
        "pagerduty": [{"id": incident_id, "title": f["pd"],
                       "status": "triggered", "urgency": "high",
                       "createdAt": _ts(start), "service": edge,
                       "description": f"{f['pd']} in {region}; users "
                                      f"report failures on {edge}",
                       "notes": []}],
        "github": github,
    }
    truth = {
        "fault_type": fault_name,
        "root_cause_service": root,
        "root_cause": f["root_cause"],
        "keywords": f["keywords"],
        "chain": chain,
        "region": region,
        "incident_id": incident_id,
    }
    query = (f"Investigate {incident_id}: {f['pd']} — users report "
             f"failures on {edge} in {region}")
    return Scenario(scenario_id=incident_id, query=query,
                    fixtures=fixtures, truth=truth)


def generate_scenarios(n: int, seed: int = 0,
                       fault_type: str | None = None,
                       adversarial: str | None = None,
                       models: list[str] | None = None) -> list[Scenario]:
    """``models`` assigns each scenario a served model group round-robin
    (deterministic in i, so the same seed+models always produces the
    same assignment) — multi-model fleet runs then exercise the
    model-field routing path on every case."""
    out = [generate_scenario(seed + i, fault_type, adversarial=adversarial)
           for i in range(n)]
    if models:
        for i, s in enumerate(out):
            s.model = models[i % len(models)]
    return out


def to_eval_case(s: Scenario):
    """Scenario → EvalCase (fixtures override + scored ground truth)."""
    from runbookai_tpu_torch.evalsuite.scoring import EvalCase

    return EvalCase(
        case_id=s.scenario_id,
        description=s.query,
        expected_root_cause=s.truth["root_cause"],
        root_cause_keywords=list(s.truth["keywords"]),
        expected_services=[s.truth["root_cause_service"]],
        incident_id=s.scenario_id,
        fixtures=s.fixtures,
        model=s.model,
    )


def write_scenarios(scenarios: list[Scenario], out_dir: str | Path) -> list[Path]:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for s in scenarios:
        p = out / f"{s.scenario_id}.json"
        p.write_text(s.to_json())
        paths.append(p)
    return paths
