"""Human and JSON reporters over one analysis run."""
from __future__ import annotations

import json
from pathlib import Path


def summarize(findings, suppressed: int, new=None, matched=None,
              stale=None) -> dict:
    by_sev: dict = {}
    by_rule: dict = {}
    for f in findings:
        by_sev[f.severity] = by_sev.get(f.severity, 0) + 1
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    out = {"total": len(findings), "by_severity": by_sev,
           "by_rule": dict(sorted(by_rule.items())),
           "suppressed_inline": suppressed}
    if new is not None:
        out["new"] = len(new)
        out["baselined"] = len(matched or ())
        out["stale_baseline_entries"] = len(stale or ())
    return out


def render_human(findings, suppressed: int, new=None, matched=None,
                 stale=None) -> str:
    lines = []
    newset = set(new or ())        # Finding is frozen, hence hashable
    for f in findings:
        tag = " (new)" if new is not None and f in newset else ""
        lines.append(f.format() + tag)
        if f.snippet:
            lines.append(f"    | {f.snippet}")
    s = summarize(findings, suppressed, new, matched, stale)
    parts = [f"{s['total']} finding(s)"]
    parts += [f"{n} {sev}" for sev, n in sorted(s["by_severity"].items())]
    parts.append(f"{suppressed} inline-suppressed")
    if new is not None:
        parts.append(f"{s['baselined']} baselined")
        parts.append(f"{s['new']} NEW")
    lines.append("schedlint: " + ", ".join(parts))
    for e in (stale or ()):
        lines.append(f"schedlint: stale baseline entry ({e['rule']} "
                     f"{e['path']}: {e['match'][:60]!r}) — source is "
                     "gone; drop it from the baseline")
    return "\n".join(lines)


def write_json(path, findings, suppressed: int, new=None, matched=None,
               stale=None):
    body = {
        "summary": summarize(findings, suppressed, new, matched, stale),
        "findings": [f.to_json() for f in findings],
    }
    if new is not None:
        body["new"] = [f.to_json() for f in new]
        body["stale_baseline_entries"] = list(stale or ())
    Path(path).write_text(json.dumps(body, indent=2) + "\n")
    return path
