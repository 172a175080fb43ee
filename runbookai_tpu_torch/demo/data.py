"""Canned demo investigation data (reference ``src/demo/demo-data.ts``).

A fully scripted payment-api latency investigation: phases, tool outputs,
hypothesis tree updates, and the final conclusion — zero model, zero network.
This is the CPU baseline config in BASELINE.md (config 1).
"""

from __future__ import annotations

DEMO_INCIDENT = {
    "id": "PD-12345",
    "title": "High p99 latency on payment-api",
    "severity": "high",
    "service": "payment-api",
}

# Each step: (delay_s, kind, payload) — delays scaled by speed factor.
DEMO_SCRIPT: list[tuple[float, str, dict]] = [
    (0.2, "phase", {"name": "triage", "text": "Triaging incident PD-12345…"}),
    (0.7, "tool_call", {"name": "pagerduty_get_incident",
                        "args": {"incident_id": "PD-12345"}}),
    (0.5, "tool_result", {"name": "pagerduty_get_incident",
                          "summary": "triggered 38m ago: p99 latency above 1.5s SLO, "
                                     "customer checkout failures reported"}),
    (0.6, "tool_call", {"name": "cloudwatch_alarms", "args": {"state": "ALARM"}}),
    (0.5, "tool_result", {"name": "cloudwatch_alarms",
                          "summary": "2 alarms firing: payment-api-p99-latency "
                                     "(4.82s vs 1.5s), payments-db-connections (98/100)"}),
    (0.4, "triage", {"severity": "high",
                     "summary": "payment-api p99 latency 3x above SLO; "
                                "db connections near limit",
                     "services": ["payment-api", "payments-db"]}),
    (0.3, "phase", {"name": "hypothesize", "text": "Generating hypotheses…"}),
    (0.8, "hypothesis_created", {"id": "H1", "statement":
                                 "DB connection pool exhaustion is throttling requests",
                                 "priority": 0.9}),
    (0.3, "hypothesis_created", {"id": "H2", "statement":
                                 "Recent deployment introduced a performance regression",
                                 "priority": 0.8}),
    (0.3, "hypothesis_created", {"id": "H3", "statement":
                                 "Node CPU saturation is slowing all pods",
                                 "priority": 0.4}),
    (0.3, "phase", {"name": "investigate", "text": "Investigating H1 (priority 0.9)…"}),
    (0.7, "tool_call", {"name": "cloudwatch_logs",
                        "args": {"log_group": "/ecs/payment-api",
                                 "filter_pattern": "connection"}}),
    (0.8, "tool_result", {"name": "cloudwatch_logs",
                          "summary": "HikariPool-1 exhausted: total=20 active=20 "
                                     "waiting=142; 'pool size 20 (was 50 before deploy "
                                     "payment-api:57)'"}),
    (0.5, "tool_call", {"name": "aws_query", "args": {"service": "rds"}}),
    (0.5, "tool_result", {"name": "aws_query",
                          "summary": "payments-db: 98/100 connections, cpu 41% — "
                                     "connection-bound, not cpu-bound"}),
    (0.5, "hypothesis_updated", {"id": "H1", "action": "branch", "confidence": 0.6,
                                 "reason": "pool exhausted — but why now?"}),
    (0.3, "hypothesis_created", {"id": "H4", "parent": "H1", "statement":
                                 "Deploy payment-api:57 shrank the pool from 50 to 20",
                                 "priority": 0.95}),
    (0.3, "phase", {"name": "investigate", "text": "Investigating H4 (priority 0.95)…"}),
    (0.6, "tool_call", {"name": "datadog", "args": {"action": "events"}}),
    (0.6, "tool_result", {"name": "datadog",
                          "summary": "42m ago: 'Deployed payment-api v2.31.0 — config "
                                     "change: db pool max_size 50 -> 20 (PR #4312)'"}),
    (0.5, "hypothesis_updated", {"id": "H4", "action": "confirm", "confidence": 0.92,
                                 "reason": "deploy event matches alarm onset; config "
                                           "change directly explains pool exhaustion"}),
    (0.4, "hypothesis_updated", {"id": "H2", "action": "merged",
                                 "reason": "subsumed by H4"}),
    (0.4, "hypothesis_updated", {"id": "H3", "action": "prune",
                                 "reason": "node cpu 55-61%, not saturated"}),
    (0.3, "phase", {"name": "conclude", "text": "Forming conclusion…"}),
    (0.9, "conclusion", {
        "root_cause": "Deploy payment-api v2.31.0 (PR #4312) reduced the database "
                      "connection pool max_size from 50 to 20. Under normal load the "
                      "pool saturates, requests queue for connections, and p99 latency "
                      "breaches the SLO.",
        "confidence": "high",
        "services": ["payment-api", "payments-db"],
    }),
    (0.3, "phase", {"name": "remediate", "text": "Planning remediation…"}),
    (0.6, "remediation_step", {"description": "Rollback payment-api to v2.30.x "
                                              "(task definition :56)", "risk": "high"}),
    (0.3, "remediation_step", {"description": "Revert PR #4312 pool configuration",
                               "risk": "low"}),
    (0.3, "remediation_step", {"description": "Add alert on connection-pool saturation "
                                              ">80%", "risk": "low"}),
    (0.2, "done", {"elapsed": "investigation complete"}),
]

DEMO_CHART = [310, 340, 330, 2900, 4400, 4820, 4710]
