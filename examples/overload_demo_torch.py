"""Transient-overload demo on the PyTorch port (paper §V-E / Fig. 12).

Injects arrival spikes into a bursty trace and shows the queuing-delay
timeline with and without SFS's hybrid FILTER->CFS bypass.  The
discrete-event simulator is host Python: no device is needed.

  PYTHONPATH=src python examples/overload_demo_torch.py
"""
import numpy as np

from repro_torch.core import metrics, policies
from repro_torch.core.simulator import simulate
from repro_torch.core.workload import FaaSBenchConfig, generate

print(__doc__)
reqs = generate(FaaSBenchConfig(n_requests=3000, cores=12, load=0.95,
                                iat="trace", seed=3))

for name, cfg in [("hybrid (bypass ON)", policies.sfs(12)),
                  ("bypass OFF", policies.sfs(12, overload_factor=None)),
                  ("pure CFS", policies.cfs(12))]:
    res = simulate(reqs, cfg)
    qd = np.array([d for _, d in res.queue_delay_timeline])
    ta = metrics.turnarounds(res)
    # coarse ASCII timeline of queue delay (20 buckets)
    buckets = np.array_split(qd, 20)
    bars = "".join(" .:-=+*#%@"[min(int(b.mean() * 10), 9)]
                   for b in buckets if len(b))
    print(f"{name:18s} |{bars}|  qdelay max {qd.max():6.2f}s  "
          f"median TA {np.median(ta)*1e3:6.0f} ms")

print("\nthe bypass drains spike backlog through CFS, so the delay "
      "timeline flattens after each burst instead of persisting.")
