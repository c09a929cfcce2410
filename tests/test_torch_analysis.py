"""The port's schedlint (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``): the copied passes give the reference's
findings on its fixtures (``tests/analysis_fixtures/``, read only), the
CLI behaves as ``tests/test_analysis.py`` holds the reference's, the
torch hot-path pass matches its own fixtures
(``tests/torch_analysis_fixtures/``), and a scan of ``src/repro_torch``
equals the committed port baseline."""
import json
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import run_analysis as ref_run  # noqa: E402
from repro.analysis.passes.determinism import \
    DeterminismPass as RefDeterminism  # noqa: E402
from repro.analysis.passes.int32_overflow import \
    Int32OverflowPass as RefInt32  # noqa: E402
from repro.analysis.passes.telemetry_parity import \
    TelemetryParityPass as RefTelemetry  # noqa: E402
from repro_torch.analysis import default_passes, run_analysis  # noqa: E402
from repro_torch.analysis.baseline import Baseline  # noqa: E402
from repro_torch.analysis.cli import DEFAULT_ROOT, main  # noqa: E402
from repro_torch.analysis.passes.determinism import \
    DeterminismPass  # noqa: E402
from repro_torch.analysis.passes.int32_overflow import \
    Int32OverflowPass  # noqa: E402
from repro_torch.analysis.passes.telemetry_parity import \
    DEFAULT_BACKENDS, TelemetryParityPass  # noqa: E402
from repro_torch.analysis.passes.torch_hotpath import \
    TorchHotpathPass  # noqa: E402

ROOT = Path(__file__).parents[1]
FIX = Path(__file__).parent / "analysis_fixtures"
TFIX = Path(__file__).parent / "torch_analysis_fixtures"
SRC = ROOT / "src" / "repro_torch"
BASELINE = SRC / "analysis" / "baseline.json"

EXPECT_RE = re.compile(r"#\s*expect:\s*([A-Z0-9-]+)")


def expected_markers(path):
    """{(rule, line)} parsed from ``# expect: RULE`` comments."""
    return {(rule, i) for i, line in enumerate(path.read_text().splitlines(),
                                               1)
            for rule in EXPECT_RE.findall(line)}


def as_rows(findings):
    return [(f.rule, f.severity, f.path, f.line, f.col, f.message,
             f.snippet) for f in findings]


def tel_kw(kinds, good, bad):
    return dict(kinds_file=f"tel/{kinds}.py",
                backends={"good": (f"tel/{good}.py",),
                          "bad": (f"tel/{bad}.py",)},
                tests_dir=FIX / "tel" / "tests")


# (fixture path, the port's pass, the reference's pass)
PARITY_CASES = {
    "det_bad": (FIX / "det_bad.py", DeterminismPass, RefDeterminism, {}),
    "det_good": (FIX / "det_good.py", DeterminismPass, RefDeterminism, {}),
    "det_suppressed": (FIX / "det_suppressed.py", DeterminismPass,
                       RefDeterminism, {}),
    "int32_bad": (FIX / "int32_bad.py", Int32OverflowPass, RefInt32,
                  dict(scope=("analysis_fixtures/",))),
    "int32_good": (FIX / "int32_good.py", Int32OverflowPass, RefInt32,
                   dict(scope=("analysis_fixtures/",))),
    "int32_default_scope": (FIX / "int32_bad.py", Int32OverflowPass,
                            RefInt32, {}),
    "tel": (FIX / "tel", TelemetryParityPass, RefTelemetry,
            tel_kw("kinds", "good_backend", "bad_backend")),
    "tel_chaos": (FIX / "tel", TelemetryParityPass, RefTelemetry,
                  tel_kw("chaos_kinds", "chaos_good_backend",
                         "chaos_bad_backend")),
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_copied_passes_give_the_reference_findings(case):
    """Rule, severity, path, line, column, message and snippet of every
    finding, and the inline-suppressed count, equal the reference's."""
    path, port_pass, ref_pass, kw = PARITY_CASES[case]
    got, got_sup = run_analysis([path], [port_pass(**kw)])
    want, want_sup = ref_run([path], [ref_pass(**kw)])
    assert as_rows(got) == as_rows(want)
    assert got_sup == want_sup
    if case.endswith("_bad") and case != "int32_default_scope":
        assert {(f.rule, f.line) for f in got} == expected_markers(path)


def test_telemetry_backends_name_the_port():
    assert sorted(DEFAULT_BACKENDS) == ["des", "tick", "torch", "vector"]
    assert DEFAULT_BACKENDS["torch"] == ("serving/cluster.py",
                                         "serving/torch_cluster.py")


def test_syntax_error_becomes_parse_finding(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def oops(:\n")
    findings, _ = run_analysis([bad], [DeterminismPass()])
    assert [f.rule for f in findings] == ["PARSE"]


# -- torch hot path ----------------------------------------------------------

def fixture_pass(**kw):
    return TorchHotpathPass(dtype_scope=("torch_analysis_fixtures/",), **kw)


def test_torch_bad_matches_markers():
    p = fixture_pass(roots=(("torch_bad.py", "table_root"),))
    findings, _ = run_analysis([TFIX / "torch_bad.py"], [p])
    assert {(f.rule, f.line) for f in findings} == \
        expected_markers(TFIX / "torch_bad.py")


def test_torch_capture_roots_need_no_table():
    """torch.compile and torch.cuda.graph make roots by themselves: with
    an empty table only ``table_root``'s finding goes."""
    findings, _ = run_analysis([TFIX / "torch_bad.py"],
                               [fixture_pass(roots=())])
    lines = (TFIX / "torch_bad.py").read_text().splitlines()
    table = lines.index("def table_root(x: torch.Tensor):") + 1
    want = {m for m in expected_markers(TFIX / "torch_bad.py")
            if not table < m[1] < table + 4}
    assert {(f.rule, f.line) for f in findings} == want


def test_torch_cold_path_not_flagged():
    p = fixture_pass(roots=(("torch_bad.py", "table_root"),))
    findings, _ = run_analysis([TFIX / "torch_bad.py"], [p])
    cold_start = (TFIX / "torch_bad.py").read_text().splitlines().index(
        "def cold_path(x):") + 1
    assert findings and all(f.line < cold_start for f in findings)


def test_torch_good_is_clean():
    findings, _ = run_analysis([TFIX / "torch_good.py"], [fixture_pass()])
    assert findings == []


def test_torch_dtype_rule_is_scoped():
    """Outside the tick-state scope a constructor without a dtype is
    not flagged; the host syncs still are."""
    findings, _ = run_analysis([TFIX / "torch_bad.py"], [TorchHotpathPass()])
    rules = {f.rule for f in findings}
    assert "TORCHHP-DTYPE" not in rules and "TORCHHP-HOSTSYNC" in rules


def test_default_roots_reach_the_hot_paths():
    """The default table reaches the fleet's tick body and the decode
    step's helpers through the call graph."""
    from repro_torch.analysis.framework import load_project
    from repro_torch.analysis.passes.torch_hotpath import (_FileInfo,
                                                           _qualname)
    project = load_project([SRC])
    p = TorchHotpathPass()
    hot = {(sf.rel, _qualname(fn)) for fn, sf in p._reachable(
        project, {f: _FileInfo(f) for f in project.files})
        if hasattr(fn, "name")}
    for want in [("serving/torch_cluster.py", "_tick_core"),
                 ("serving/torch_cluster.py", "_count"),
                 ("models/transformer.py", "Transformer.decode_step"),
                 ("models/transformer.py", "Transformer._logits"),
                 ("models/transformer.py", "_commit_layer"),
                 ("kernels/group_pick/kernel.py", "pick_order_cuda"),
                 ("kernels/decode_attention/kernel.py",
                  "decode_attention_cuda")]:
        assert want in hot, want


# -- the port's own tree ------------------------------------------------------

def test_port_scan_matches_committed_baseline():
    assert DEFAULT_ROOT == SRC
    findings, _ = run_analysis([SRC])
    new, matched, stale = Baseline.load(BASELINE).compare(findings)
    assert new == [], "\n".join(f.format() for f in new)
    assert stale == []
    entries = json.loads(BASELINE.read_text())["entries"]
    assert len(matched) == len(entries)
    assert all(e["reason"] and "TODO" not in e["reason"] for e in entries)


def test_port_cli_gate_passes(capsys):
    assert main(["--baseline", str(BASELINE)]) == 0
    assert "0 NEW" in capsys.readouterr().out


# -- CLI ---------------------------------------------------------------------

@pytest.fixture()
def violation_dir(tmp_path):
    (tmp_path / "code.py").write_text(
        "import random\n\n\ndef f():\n    return random.random()\n")
    return tmp_path


def test_cli_exit_codes_without_baseline(violation_dir, tmp_path, capsys):
    assert main([str(violation_dir)]) == 1
    clean = tmp_path / "clean.py"
    clean.write_text("def f():\n    return 1\n")
    assert main([str(clean)]) == 0
    capsys.readouterr()


def test_cli_baseline_round_trip(violation_dir, capsys):
    bl = violation_dir / "baseline.json"
    code = violation_dir / "code.py"
    assert main([str(code), "--baseline", str(bl),
                 "--update-baseline"]) == 0
    assert main([str(code), "--baseline", str(bl)]) == 0
    code.write_text(code.read_text()
                    + "\n\ndef g(jobs):\n    return id(jobs)\n")
    assert main([str(code), "--baseline", str(bl)]) == 1
    out = capsys.readouterr().out
    assert "DET-ID-ORDER" in out and "(new)" in out
    code.write_text("def f():\n    return 1\n")
    assert main([str(code), "--baseline", str(bl)]) == 0
    assert "stale baseline entry" in capsys.readouterr().out


def test_cli_json_report(violation_dir, capsys):
    report = violation_dir / "report.json"
    assert main([str(violation_dir / "code.py"),
                 "--json", str(report)]) == 1
    body = json.loads(report.read_text())
    assert body["summary"]["total"] == 1
    assert body["findings"][0]["rule"] == "DET-SEED"
    capsys.readouterr()


def test_cli_list_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in ("DET-SEED", "TORCHHP-HOSTSYNC", "TORCHHP-BRANCH",
                 "TORCHHP-DTYPE", "INT32-CAST", "TEL-KINDS"):
        assert rule in out
    assert "JAXHP" not in out
    assert [p.name for p in default_passes()] == [
        "determinism", "int32-overflow", "telemetry-parity",
        "torch-hotpath"]


def test_cli_select_pass(violation_dir, capsys):
    assert main([str(violation_dir / "code.py"),
                 "--select", "int32-overflow"]) == 0
    assert main([str(violation_dir / "code.py"),
                 "--select", "nope"]) == 2
    capsys.readouterr()
