"""Torch hot-path fixture: a compiled tick body, a graph-captured step
and a table-named root (plus a helper one of them calls) committing
every hot-path sin.  Self-contained — schedlint resolves the call graph
statically, nothing here ever runs."""
import numpy as np
import torch


def helper(x):
    # reachable from the compiled root through the call below
    return np.maximum(x, 0)                       # expect: TORCHHP-HOSTSYNC


@torch.compile
def tick(state: torch.Tensor, n: int):
    total = torch.sum(state)
    if total > 0:                                 # expect: TORCHHP-BRANCH
        state = state + 1
    flag = float(total)                           # expect: TORCHHP-HOSTSYNC
    host = total.item()                           # expect: TORCHHP-HOSTSYNC
    rows = state.tolist()                         # expect: TORCHHP-HOSTSYNC
    back = state.cpu()                            # expect: TORCHHP-HOSTSYNC
    torch.cuda.synchronize()                      # expect: TORCHHP-HOSTSYNC
    while total < n:                              # expect: TORCHHP-BRANCH
        total = total + 1
    if state.dim() == 2 and state.shape[0] > n:   # metadata: not flagged
        state = state[0]
    return helper(state), flag, host, rows, back


def step_body(x):
    buf = torch.zeros(4)                          # expect: TORCHHP-DTYPE
    return buf + x.numpy()                        # expect: TORCHHP-HOSTSYNC


def capture(g, x):
    with torch.cuda.graph(g):
        step_body(x)


def table_root(x: torch.Tensor):
    # hot only through the root table the tests pass
    for row in x:                                 # expect: TORCHHP-BRANCH
        print(row)


def cold_path(x):
    # NOT reachable from any root: none of this is flagged
    if x.sum() > 0:
        return float(x) * 0.5
    return np.maximum(x, 0).item()
