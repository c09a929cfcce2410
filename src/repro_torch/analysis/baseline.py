"""Baseline file: the checked-in set of accepted findings.

Each entry pins one finding by ``(rule, path suffix, stripped source
line)`` — line numbers are deliberately NOT part of the key, so
unrelated edits above a pinned site don't invalidate the baseline —
and carries a mandatory one-line ``reason``.  ``compare`` splits a run
into new findings (fail), matched findings (accepted), and stale
entries (pinned source no longer exists; reported, never fatal, so a
fix doesn't break the gate).
"""
from __future__ import annotations

import json
from pathlib import Path

#: the port's baseline, relative to the repository root
DEFAULT_BASELINE = "src/repro_torch/analysis/baseline.json"


class Baseline:
    """Load/compare/update the accepted-finding set."""

    def __init__(self, entries=()):
        self.entries = list(entries)

    @classmethod
    def load(cls, path) -> "Baseline":
        p = Path(path)
        if not p.exists():
            return cls()
        data = json.loads(p.read_text())
        entries = data.get("entries", [])
        for e in entries:
            missing = {"rule", "path", "match"} - set(e)
            if missing:
                raise ValueError(
                    f"baseline entry {e!r} missing keys {sorted(missing)}")
        return cls(entries)

    @staticmethod
    def _matches(entry, finding) -> bool:
        if entry["rule"] != finding.rule:
            return False
        path = finding.path
        if not (path == entry["path"] or path.endswith("/" + entry["path"])
                or entry["path"].endswith("/" + path)):
            return False
        return entry["match"].strip() == finding.snippet.strip()

    def compare(self, findings):
        """``(new, matched, stale_entries)`` for this run's findings."""
        used = [False] * len(self.entries)
        new, matched = [], []
        for f in findings:
            hit = None
            for i, e in enumerate(self.entries):
                if self._matches(e, f):
                    hit = i
                    break
            if hit is None:
                new.append(f)
            else:
                used[hit] = True
                matched.append(f)
        stale = [e for e, u in zip(self.entries, used) if not u]
        return new, matched, stale

    def updated(self, findings, root=None) -> "Baseline":
        """New baseline covering exactly this run's findings: entries
        still matched keep their hand-written reason; new findings get a
        TODO reason to be filled in by the committer."""
        entries = []
        seen = set()
        for f in findings:
            reason = None
            for e in self.entries:
                if self._matches(e, f):
                    reason = e.get("reason")
                    break
            path = f.path
            if root is not None:
                try:
                    path = Path(f.path).relative_to(
                        Path(root).resolve()).as_posix()
                except ValueError:
                    pass
            key = (f.rule, path, f.snippet.strip())
            if key in seen:
                continue
            seen.add(key)
            entries.append({
                "rule": f.rule, "path": path, "match": f.snippet.strip(),
                "reason": reason or "TODO: justify this suppression "
                                    "or fix the finding"})
        return Baseline(entries)

    def save(self, path):
        body = {"comment": "schedlint accepted findings — every entry "
                           "needs a one-line reason (docs/ANALYSIS.md)",
                "entries": self.entries}
        Path(path).write_text(json.dumps(body, indent=2) + "\n")
