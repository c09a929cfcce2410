"""Quickstart on the PyTorch port: the paper in 60 seconds.

1. Generate an Azure-sampled FaaS workload (FaaSBench, §VII).
2. Run it under CFS and under SFS on a simulated 12-core host.
3. Print the headline comparison (turnaround, RTE, context switches).

The discrete-event simulator is host Python: no device is needed.

  PYTHONPATH=src python examples/quickstart_torch.py
"""
import numpy as np

from repro_torch.core import metrics, policies
from repro_torch.core.simulator import simulate
from repro_torch.core.workload import FaaSBenchConfig, generate

print(__doc__)
reqs = generate(FaaSBenchConfig(n_requests=3000, cores=12, load=1.0,
                                seed=42))
print(f"workload: {len(reqs)} requests, "
      f"mean service {np.mean([r.service for r in reqs])*1e3:.0f} ms, "
      f"100% offered load on 12 cores\n")

results = {}
for pol in ["ideal", "srtf", "sfs", "cfs"]:
    results[pol] = simulate(reqs, policies.make(pol, 12))
    ta = metrics.turnarounds(results[pol])
    rte = metrics.rtes(results[pol])
    print(f"{pol:6s} median {np.median(ta)*1e3:8.0f} ms   "
          f"p99 {np.percentile(ta, 99):7.2f} s   "
          f"RTE>=0.95: {(rte >= 0.95).mean()*100:5.1f}%   "
          f"ctx switches: {results[pol].n_ctx_total:,}")

hc = metrics.compare(results["sfs"], results["cfs"])
print(f"\nSFS vs CFS: {hc.frac_improved*100:.0f}% of functions improved "
      f"{hc.mean_speedup_improved:.1f}x on average "
      f"(geomean {hc.geomean_speedup_improved:.1f}x); the remaining "
      f"{hc.frac_regressed*100:.0f}% run {hc.mean_slowdown_regressed:.2f}x "
      f"longer — the paper's short-jobs-win trade, reproduced.")
