from repro_torch.kernels.group_pick.ops import pick_order

__all__ = ["pick_order"]
