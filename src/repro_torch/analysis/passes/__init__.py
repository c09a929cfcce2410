"""The shipped pass suite — importing this module registers all four
passes with :data:`repro_torch.analysis.framework.PASS_REGISTRY`."""
from repro_torch.analysis.passes import (determinism,  # noqa: F401
                                         int32_overflow, telemetry_parity,
                                         torch_hotpath)
