"""Print the virtual cloud's pins for ``repro_torch.configs.acceptance``:
what the JAX package gives on the CPU.

- ``PINNED_VIRTUAL_CLOUD``: for each of ``acceptance.VIRTUAL_CLOUD_PINNED``,
  ``run_episode(..., VIRTUAL_CLOUD_TICKS, "easy", summary_only=True)`` +
  ``summary`` on ``tx_gaia(max_jobs=64, max_nodes_per_job=16, **what_if)``
  with the JAX package's ``lm_jobs_workload``; and under ``"digest"`` the
  ``acceptance.workload_digest`` of that workload.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_perfmodel_pins.py

Not a test module: it takes ~15 s on the CPU. It prints the assignment
to paste into ``acceptance.py`` on standard output.
"""

from __future__ import annotations

import sys
import time

import jax

import repro.configs.sim as rcfg
import repro.core as R
from repro.perfmodel import lm_jobs_workload
from repro_torch.configs import acceptance as A


def reference_workload():
    cfg = rcfg.tx_gaia(max_jobs=64, max_nodes_per_job=16)
    return lm_jobs_workload(cfg, list(A.VIRTUAL_CLOUD_ARCHS),
                            **A.VIRTUAL_CLOUD_JOBS)


def scenario_summary(name: str, jobs, bank) -> dict:
    cfg = rcfg.tx_gaia(max_jobs=64, max_nodes_per_job=16,
                       **A.VIRTUAL_CLOUD_WHAT_IFS[name])
    st = R.build_statics(cfg, bank)
    s = R.load_jobs(R.init_state(cfg, st, jax.random.key(A.SEED)), jobs)
    fs, tel = jax.jit(lambda s: R.run_episode(
        cfg, st, s, A.VIRTUAL_CLOUD_TICKS, A.VIRTUAL_CLOUD_SCHEDULER,
        summary_only=True))(s)
    return R.summary(fs, tel)


def pins() -> dict:
    jobs, bank = reference_workload()
    out = {"digest": A.workload_digest(jobs, bank)}
    for name in A.VIRTUAL_CLOUD_PINNED:
        t0 = time.perf_counter()
        out[name] = scenario_summary(name, jobs, bank)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return out


def literal(got: dict) -> str:
    lines = ["PINNED_VIRTUAL_CLOUD = {"]
    for k, v in got.items():
        if not isinstance(v, dict):
            lines.append(f"    {k!r}: {v!r},")
            continue
        lines.append(f"    {k!r}: {{")
        lines += [f"        {kk!r}: {vv!r}," for kk, vv in v.items()]
        lines.append("    },")
    return "\n".join(lines + ["}"]).replace("'", '"')


if __name__ == "__main__":
    print(literal(pins()))
