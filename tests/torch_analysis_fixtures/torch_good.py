"""Torch hot-path fixture: the clean twin of torch_bad.py — device-side
idiom throughout, zero findings expected."""
import torch


def helper(x):
    return torch.clamp_min(x, 0)


@torch.compile
def tick(state: torch.Tensor, n: int):
    total = torch.sum(state)
    state = torch.where(total > 0, state + 1, state)
    buf = torch.zeros(n, dtype=torch.int32)
    if state.dim() == 2 and state.shape[0] > n:   # metadata is static
        state = state[0]
    for name, t in (("state", state), ("buf", buf)):
        assert t.is_contiguous(), name
    return helper(state), buf


def step_body(carry: torch.Tensor, x: torch.Tensor):
    if carry is None:
        return x
    return carry + x


def run(xs):
    # make_graphed_callables root: step_body is hot and must stay clean
    return torch.cuda.make_graphed_callables(step_body, (xs, xs))
