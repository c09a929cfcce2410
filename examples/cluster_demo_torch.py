"""Cluster scheduling demo on the PyTorch port: experiment specs, one
entry point.

Declares each cluster experiment as a ``repro_torch.ExperimentSpec`` —
4 SFS engines behind each dispatch policy, then a *heterogeneous* mixed
pool (two FILTER-rich 6-lane SFS servers + two small fair-share-only
CFS servers) that ``sfs-aware`` exploits and shape-blind ``hash``
cannot — and runs everything through ``repro_torch.run_experiment``.
Synthetic engine mode (``engine="tick"``, no model): identical
scheduling behaviour, host code only, so it runs with ``device="cpu"``.

  PYTHONPATH=src python examples/cluster_demo_torch.py
"""
import repro_torch
from repro_torch.core.dispatch import POLICIES

print(__doc__)

WORKLOAD = repro_torch.TickWorkloadSpec(n=800, load=0.9, seed=7)


def show(res: repro_torch.ExperimentResult):
    print(f"\n{res.policy}  (dispatch {res.dispatch_counts}, "
          f"{res.overload_bypasses} overload bypasses)")
    for label, row in res.buckets().items():
        print(f"  {label:8s} n={row['n']:4d}  p50={row['p50']:6.1f}  "
              f"p99={row['p99']:7.1f}  mean RTE={row['mean_rte']:.3f}")


def run(spec: repro_torch.ExperimentSpec) -> repro_torch.ExperimentResult:
    # the tick engines are synthetic: nothing is placed on a device
    return repro_torch.run_experiment(spec, device="cpu")


print("== uniform pool: 4 engines x 4 lanes ==")
for policy in POLICIES:
    show(run(repro_torch.ExperimentSpec(
        engine="tick",
        servers=tuple(repro_torch.ServerSpec(cores=4) for _ in range(4)),
        dispatch=policy, workload=WORKLOAD)))

print("\n== mixed pool: 6+6 sfs / 2+2 cfs (heterogeneous, same total "
      "lanes) ==")
MIXED = (repro_torch.ServerSpec(cores=6),
         repro_torch.ServerSpec(cores=6),
         repro_torch.ServerSpec(cores=2, scheduler="cfs"),
         repro_torch.ServerSpec(cores=2, scheduler="cfs"))
for policy in ("hash", "sfs-aware"):
    show(run(repro_torch.ExperimentSpec(
        engine="tick", servers=MIXED, dispatch=policy,
        workload=WORKLOAD)))
