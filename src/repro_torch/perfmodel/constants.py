"""Hardware constants for the analytic performance model and roofline.

These describe the accelerators of the *simulated* cloud: the perf model
turns LM jobs into twin jobs as if they ran on this chip, with the JAX
package's constants, so that both packages derive the same workloads.
They are not the H100's, and nothing here is measured on a card.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class Chip:
    name: str
    peak_flops_bf16: float     # FLOP/s
    hbm_bw: float              # bytes/s
    ici_bw: float              # bytes/s per link
    hbm_bytes: float
    idle_w: float
    dyn_w: float               # extra W at full utilization


V5E = Chip(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    hbm_bytes=16 * 2**30,
    idle_w=90.0,
    dyn_w=130.0,
)
