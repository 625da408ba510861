"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version in the same module.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: a wrapper
adds one where it launches its kernel and nowhere else, so a run can
show that the main path went through the kernel.
"""

LAUNCHES: dict[str, int] = {"power_scatter": 0, "rack_thermal": 0,
                             "node_power": 0, "flash_attn": 0,
                             "selective_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
