"""schedlint over the port — determinism & torch hot-path static analysis.

A copy of ``repro.analysis`` (the JAX package's lint, docs/ANALYSIS.md)
whose default scan root is ``src/repro_torch``.  The port's
correctness claim — its ``torch`` fleet backend equals ``vector`` and
``tick`` event for event, and the DES equals the reference's — lives in
runtime tests, which only catch a nondeterminism bug on the seeds they
run.  This package is the static layer in front of them: an AST-based
pass suite that flags the bug *classes* that break bit-exactness before
any sweep runs.

Four passes ship by default:

* ``determinism`` — unseeded ``random``/``np.random`` global-state
  calls, ``set`` iteration feeding ordered state, float ``==``,
  ``id()``-based ordering, ``time.time()`` used for durations.
* ``torch-hotpath`` — for functions statically reachable from a hot
  root (the fleet's tick body ``_tick_core`` and gap jump
  ``_advance_core``, ``Transformer.decode_step``, the kernels' launch
  wrappers, and anything handed to ``torch.compile``,
  ``torch.cuda.graph`` or ``make_graphed_callables``): host syncs
  (``.item()``, ``.cpu()``, ``float()`` on a tensor, ``np.*``),
  Python branches on tensor values, and tensor constructors without a
  dtype where the int32 tick state lives.
* ``int32-overflow`` — products/accumulations of tick x lane x request
  quantities narrowed to int32 in the array backends.
* ``telemetry-parity`` — all four backends (des, tick, vector, torch)
  emit the same set of lifecycle event kinds, every emission site
  carries the single ``is not None`` guard, and every registered
  scheduler/dispatch/predictor name is exercised under ``tests/``.

Run it with ``python -m repro_torch.analysis --baseline
src/repro_torch/analysis/baseline.json`` (or ``make lint-torch``); new
findings exit non-zero.  Suppress a deliberate site inline with
``# schedlint: disable=<rule>`` or record it in the baseline with a
reason.  This package imports only the standard library.
"""
from repro_torch.analysis.baseline import Baseline
from repro_torch.analysis.findings import Finding, Rule
from repro_torch.analysis.framework import (AnalysisPass, PASS_REGISTRY,
                                            Project, load_project,
                                            register_pass)

__all__ = ["AnalysisPass", "Baseline", "Finding", "PASS_REGISTRY",
           "Project", "Rule", "load_project", "register_pass",
           "run_analysis", "default_passes"]


def default_passes():
    """Instances of every registered pass, in registration order."""
    import repro_torch.analysis.passes  # noqa: F401  (registers the suite)
    return [cls() for cls in PASS_REGISTRY.values()]


def run_analysis(paths, passes=None):
    """Load ``paths``, run ``passes`` (default: all), return the sorted
    finding list with inline suppressions already applied, plus the
    count of inline-suppressed findings: ``(findings, n_suppressed)``."""
    project = load_project(paths)
    findings = list(project.parse_failures)
    for p in (passes if passes is not None else default_passes()):
        findings.extend(p.run(project))
    kept, suppressed = [], 0
    for f in findings:
        sf = project.file_by_path(f.path)
        if sf is not None and sf.suppresses(f):
            suppressed += 1
        else:
            kept.append(f)
    kept.sort(key=lambda f: f.sort_key())
    return kept, suppressed
