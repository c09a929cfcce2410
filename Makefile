# Tier-1 verify + CI conveniences.  All targets assume the repo root.
PY ?= python
export PYTHONPATH := src$(if $(PYTHONPATH),:$(PYTHONPATH),)

.PHONY: test test-fast test-jax lint lint-torch bench-smoke bench-predict \
  bench-fleet bench-elastic bench-chaos bench bench-json bench-gate \
  trace-demo

# the tier-1 command (ROADMAP.md)
test:
	$(PY) -m pytest -x -q

# jax-light subset: scheduler/simulator/cluster/spec/workload logic only
test-fast:
	$(PY) -m pytest -q tests/test_simulator.py tests/test_workload.py \
	  tests/test_serving.py tests/test_cluster.py tests/test_agreement.py \
	  tests/test_predict.py tests/test_spec.py \
	  tests/test_vector_cluster.py tests/test_jax_cluster.py \
	  tests/test_telemetry.py tests/test_analysis.py

# schedlint: determinism & jax hot-path static analysis over src/repro,
# gated on the committed baseline (docs/ANALYSIS.md) — new findings fail
lint:
	$(PY) -m repro.analysis --baseline schedlint_baseline.json

# the same lint over the PyTorch port (src/repro_torch), with its torch
# hot-path pass, gated on the port's own baseline
lint-torch:
	$(PY) -m repro_torch.analysis --baseline \
	  src/repro_torch/analysis/baseline.json

# jax-backend agreement + edge suites, pinned to the CPU backend (what
# CI runs across the python-version matrix)
test-jax:
	JAX_PLATFORMS=cpu $(PY) -m pytest -q tests/test_agreement.py \
	  tests/test_jax_cluster.py

# <60 s cluster-dispatch smoke check (asserts the short-P99 headline)
bench-smoke:
	$(PY) benchmarks/cluster_sweep.py --smoke

# <60 s duration-predictor smoke check (asserts history <= blind on
# short P99 and the oracle == hinted=True bit-exact back-compat)
bench-predict:
	$(PY) benchmarks/predict_sweep.py --smoke

# <60 s 1024-engine jax-backend fleet scenario (own invocation so it
# gets its own budget; 1M requests total across sfs-aware + hash)
bench-fleet:
	$(PY) benchmarks/cluster_sweep.py --fleet1024

# <60 s lifecycle scenario: cold starts + keep-alive, flash crowd,
# failure/drain and autoscaling at once (asserts the short-P99 headline
# survives elasticity; docs/CLUSTER.md "Production realism")
bench-elastic:
	$(PY) benchmarks/cluster_sweep.py --elastic

# <60 s chaos scenario: correlated fault episodes with recovery,
# request timeouts/retries with backoff, and admission shedding
# (asserts the short-P99 headline survives faults; docs/CLUSTER.md
# "Chaos and graceful degradation")
bench-chaos:
	$(PY) benchmarks/cluster_sweep.py --chaos

# CI perf trajectory: smoke cluster+predict suites with machine-readable
# BENCH_*.json output (uploaded as artifacts), then the regression gate
# against benchmarks/baselines/.  fleet1024, elastic and chaos run
# first so their artifacts are fresh when the cluster suite distills
# BENCH_cluster.json.
bench-json:
	$(PY) -m benchmarks.run --smoke --json fleet1024 elastic chaos \
	  cluster predict

bench-gate:
	$(PY) benchmarks/check_regression.py

# one sfs-aware-vs-hash Perfetto lifecycle trace of the fleet64 smoke
# scenario (docs/OBSERVABILITY.md) — load the JSON in ui.perfetto.dev
# or chrome://tracing
trace-demo:
	mkdir -p artifacts/bench
	$(PY) benchmarks/cluster_sweep.py --trace \
	  artifacts/bench/trace_fleet64.json --n 10000

# full benchmark suite (paper figures + cluster sweep)
bench:
	$(PY) -m benchmarks.run
