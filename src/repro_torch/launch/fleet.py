"""Fleet launcher: ``python -m repro_torch.launch.fleet [--engines 1024]
[--lanes 8] [--load 0.9] [--n 500000] [--seed 11] [--policy sfs-aware]
[--device cuda]``.

Runs one bimodal tick workload (``TickWorkloadSpec``) across a uniform
fleet through the fleet-stepping backend
(:class:`~repro_torch.serving.torch_cluster.TorchCluster`) and prints the
short- and long-bucket turnaround P50/P99, the ticks, the wall time, the
host-loop phases and the result's fingerprint.  The defaults are the
1024-engine fleet scenario of the JAX package's benchmark
(``benchmarks/cluster_sweep.py``, ``run_fleet1024``: 1024 engines x 8
lanes at load 0.9, 500,000 requests, seed 11).  Runs on the CUDA card
unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.dispatch import POLICIES
from repro_torch.core.spec import (ExperimentSpec, ServerSpec,
                                   TickWorkloadSpec, run_experiment)
from repro_torch.core.telemetry import Telemetry
from repro_torch.device import resolve_device


def run(policy: str, engines: int, lanes: int, load: float, n: int,
        seed: int, device="cuda", workload=None, lifecycle=None,
        faults=None, retry=None) -> dict:
    """One fleet run with profile-only telemetry (which keeps every fast
    path live); returns its metrics, phases and fingerprint."""
    device = resolve_device(device)
    spec = ExperimentSpec(
        servers=tuple(ServerSpec(cores=lanes) for _ in range(engines)),
        dispatch=policy,
        workload=(workload if workload is not None
                  else TickWorkloadSpec(n=n, load=load, seed=seed)),
        lifecycle=lifecycle, faults=faults, retry=retry)
    tel = Telemetry(profile=True)
    res = run_experiment(spec, max_ticks=50_000_000, telemetry=tel,
                         device=device)
    b = res.buckets()
    keys = list(b)
    short, long_ = b[keys[0]], b[keys[-1]]
    phases = tel.profile.summary()
    return {
        "policy": policy, "engines": engines, "lanes": lanes, "load": load,
        "n": res.n, "shed": res.shed, "device": str(device),
        "short_bucket": keys[0], "long_bucket": keys[-1],
        "short_p50": short["p50"], "short_p99": short["p99"],
        "long_p50": long_["p50"], "long_p99": long_["p99"],
        "ticks": int(res.finish.max()) if res.n else 0,
        "wall_s": res.wall_s,
        "stepped_ticks": phases.get("torch_step", {}).get("calls", 0),
        "scan_chunks": phases.get("torch_commit", {}).get("calls", 0),
        "phases": phases, "fingerprint": res.fingerprint(),
    }


def report(r: dict) -> str:
    steps = r["stepped_ticks"]
    step_s = r["phases"].get("torch_step", {}).get("total_s", 0.0)
    lines = [
        f"[fleet] {r['policy']} engines={r['engines']} lanes={r['lanes']} "
        f"load={r['load']} n={r['n']} shed={r['shed']} on {r['device']}",
        f"[fleet]   short({r['short_bucket']}) p50={r['short_p50']} "
        f"p99={r['short_p99']}  long({r['long_bucket']}) "
        f"p50={r['long_p50']} p99={r['long_p99']}",
        f"[fleet]   finish max tick={r['ticks']} wall={r['wall_s']:.3f} s "
        f"stepped ticks={steps} scan chunks={r['scan_chunks']} "
        f"ms/stepped tick={1e3 * step_s / max(steps, 1):.3f}",
        "[fleet]   phases " + json.dumps(r["phases"]),
        f"[fleet]   fingerprint {r['fingerprint']}",
    ]
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engines", type=int, default=1024)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--load", type=float, default=0.9)
    ap.add_argument("--n", type=int, default=500_000)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--policy", default="sfs-aware", choices=POLICIES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(args.policy, args.engines, args.lanes, args.load, args.n,
            args.seed, device=args.device)
    print(report(r))
    return r


if __name__ == "__main__":
    main()
