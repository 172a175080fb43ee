"""Investigation scoring: weighted root-cause / services / confidence / phrases
(a copy of the JAX package's ``evalsuite/scoring.py``).

Parity target: reference ``src/eval/scoring.ts`` — fixture schema (:3-35),
``scoreInvestigationResult`` (:134): root cause exact + keyword matching,
service alias coverage (:75-123), confidence ordinal distance (:54-58),
required/forbidden phrase checks; pass threshold from the fixture (default
0.7, ``examples/evals/investigation-fixtures.sample.json:3``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Optional

DEFAULT_WEIGHTS = {
    "root_cause": 0.45,
    "services": 0.2,
    "confidence": 0.15,
    "phrases": 0.2,
}

_CONFIDENCE_ORD = {"low": 0, "medium": 1, "high": 2}


@dataclass
class EvalCase:
    case_id: str
    description: str
    expected_root_cause: str
    root_cause_keywords: list[str] = field(default_factory=list)
    expected_services: list[str] = field(default_factory=list)
    service_aliases: dict[str, list[str]] = field(default_factory=dict)
    expected_confidence: str = "medium"
    required_phrases: list[str] = field(default_factory=list)
    forbidden_phrases: list[str] = field(default_factory=list)
    pass_threshold: float = 0.7
    incident_id: str = ""
    fixtures: Optional[dict[str, Any]] = None  # simulated-cloud fixture override
    mock_result: Optional[dict[str, Any]] = None  # offline mode
    # Served model group to run this case against (multi-model fleets);
    # None = the client's default model, exactly the historical behavior.
    model: Optional[str] = None

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "EvalCase":
        return cls(
            case_id=str(raw.get("case_id") or raw.get("id") or "case"),
            description=str(raw.get("description", "")),
            expected_root_cause=str(raw.get("expected_root_cause", "")),
            root_cause_keywords=[str(k) for k in raw.get("root_cause_keywords", [])],
            expected_services=[str(s) for s in raw.get("expected_services", [])],
            service_aliases={k: list(v) for k, v in raw.get("service_aliases", {}).items()},
            expected_confidence=str(raw.get("expected_confidence", "medium")),
            required_phrases=[str(p) for p in raw.get("required_phrases", [])],
            forbidden_phrases=[str(p) for p in raw.get("forbidden_phrases", [])],
            pass_threshold=float(raw.get("pass_threshold", 0.7)),
            incident_id=str(raw.get("incident_id", "")),
            fixtures=raw.get("fixtures"),
            mock_result=raw.get("mock_result") or raw.get("mockResult"),
            model=raw.get("model"),
        )


@dataclass
class CaseScore:
    case_id: str
    total: float
    passed: bool
    dimensions: dict[str, float]
    notes: list[str] = field(default_factory=list)


def _normalize(text: str) -> str:
    return re.sub(r"\s+", " ", text.lower()).strip()


def score_root_cause(expected: str, keywords: list[str], actual: str) -> tuple[float, str]:
    actual_n = _normalize(actual)
    if not actual_n:
        return 0.0, "empty root cause"
    if expected and _normalize(expected) in actual_n:
        return 1.0, "exact root-cause match"
    if keywords:
        hit = sum(1 for k in keywords if _normalize(k) in actual_n)
        return hit / len(keywords), f"{hit}/{len(keywords)} keywords"
    # fall back to token overlap with the expected statement
    exp_words = set(_normalize(expected).split())
    if not exp_words:
        return 0.0, "no expected root cause defined"
    overlap = sum(1 for w in exp_words if len(w) > 3 and w in actual_n)
    return min(1.0, overlap / max(1, len([w for w in exp_words if len(w) > 3]))), "token overlap"


def score_services(expected: list[str], aliases: dict[str, list[str]],
                   actual: list[str], answer_text: str = "") -> tuple[float, str]:
    if not expected:
        return 1.0, "no expected services"
    actual_n = {_normalize(s) for s in actual}
    text_n = _normalize(answer_text)
    covered = 0
    for svc in expected:
        names = [svc] + aliases.get(svc, [])
        if any(_normalize(n) in actual_n or _normalize(n) in text_n for n in names):
            covered += 1
    return covered / len(expected), f"{covered}/{len(expected)} services covered"


def score_confidence(expected: str, actual: str) -> float:
    """Ordinal distance (scoring.ts:54-58): exact 1.0, adjacent 0.5, else 0."""
    e = _CONFIDENCE_ORD.get(_normalize(expected))
    a = _CONFIDENCE_ORD.get(_normalize(actual))
    if e is None or a is None:
        return 0.0
    dist = abs(e - a)
    return 1.0 if dist == 0 else (0.5 if dist == 1 else 0.0)


def score_phrases(required: list[str], forbidden: list[str], text: str) -> tuple[float, list[str]]:
    notes = []
    text_n = _normalize(text)
    score = 1.0
    if required:
        hit = sum(1 for p in required if _normalize(p) in text_n)
        score = hit / len(required)
        if hit < len(required):
            notes.append(f"missing required phrases: {len(required) - hit}")
    for p in forbidden:
        if _normalize(p) in text_n:
            score = max(0.0, score - 0.5)
            notes.append(f"forbidden phrase present: {p!r}")
    return score, notes


def score_investigation_result(case: EvalCase, result: dict[str, Any],
                               weights: Optional[dict[str, float]] = None) -> CaseScore:
    """``result`` needs: root_cause, confidence, affected_services, summary."""
    w = weights or DEFAULT_WEIGHTS
    answer_text = " ".join(str(result.get(k, "")) for k in
                           ("root_cause", "summary", "conclusion_summary"))
    rc_score, rc_note = score_root_cause(
        case.expected_root_cause, case.root_cause_keywords,
        str(result.get("root_cause", "")))
    svc_score, svc_note = score_services(
        case.expected_services, case.service_aliases,
        list(result.get("affected_services", [])), answer_text)
    conf_score = score_confidence(case.expected_confidence,
                                  str(result.get("confidence", "")))
    phrase_score, phrase_notes = score_phrases(
        case.required_phrases, case.forbidden_phrases, answer_text)

    dims = {
        "root_cause": rc_score,
        "services": svc_score,
        "confidence": conf_score,
        "phrases": phrase_score,
    }
    total = sum(w[k] * dims[k] for k in w)
    return CaseScore(
        case_id=case.case_id,
        total=round(total, 4),
        passed=total >= case.pass_threshold,
        dimensions=dims,
        notes=[rc_note, svc_note, *phrase_notes],
    )
