"""Print the macro-stepping pins for ``repro_torch.configs.acceptance``:
what the JAX package's macro path (``macro=True``) gives on the CPU.

- ``PINNED_MACRO``: ``run_episode(..., "replay", macro=True)`` +
  ``summary`` for each replay hour (``acceptance.MACRO_CASES``);
- ``PINNED_FLEET_MACRO``: the vmapped ``run_fleet(..., macro=True)`` over
  the fleet case's grid (72 replicas of the hour), per replica;
- ``PINNED_RL_MACRO``: ``SchedEnv(macro=True)`` driven by the script for
  ``rl_tx_gaia`` and one ``ppo_train`` iteration, in ``PINNED_RL``'s form.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_macro_pins.py \\
        [replay] [fleet] [rl]

Not a test module: all three take a few minutes on 8 CPU cores. Each part
prints a Python literal on standard output.
"""

from __future__ import annotations

import math
import sys
import textwrap
import time

import jax

import repro.configs.sim as rcfg
import repro.core as R
from repro.core.fleet import fleet_summary, run_fleet
from repro.data import synth_workload
from repro_torch.configs import acceptance as A

import torch_fleet_pins
import torch_rl_pins


def replay() -> dict:
    pins = {}
    for case in A.MACRO_CASES:
        cfg = rcfg.tx_gaia(max_jobs=256, max_nodes_per_job=16,
                           **A.CASES[A.base_case(case)])
        jobs, bank = synth_workload(cfg, 200, 3600.0, seed=A.SEED)
        st = R.build_statics(cfg, bank)
        s = R.load_jobs(R.init_state(cfg, st, jax.random.key(A.SEED)), jobs)
        fs, tel = jax.jit(lambda s, cfg=cfg, st=st: R.run_episode(
            cfg, st, s, A.N_STEPS, A.SCHEDULER, macro=True))(s)
        got = R.summary(fs, tel)
        keys = A.MACRO_KEYS + (A.MACRO_THERMAL_KEYS if cfg.thermal_enabled
                               else ())
        pins[case] = {k: float(got[k]) for k in keys}
    return pins


def fleet() -> dict:
    cfg = rcfg.tx_gaia(max_jobs=256, max_nodes_per_job=16)
    jobs, bank = synth_workload(cfg, 200, 3600.0, seed=A.SEED)
    st = R.build_statics(cfg, bank)
    s = R.load_jobs(R.init_state(cfg, st, jax.random.key(A.SEED)), jobs)
    pols, scns = torch_fleet_pins.reference_grid(cfg)
    fs, tel = run_fleet(cfg, st, s, A.N_STEPS, policies=pols,
                        scenarios=scns, summary_only=True, macro=True)
    rows = fleet_summary(fs, tel)
    pins = {k: [r[k] for r in rows]
            for k in ("completed",) + A.FLEET_KEYS + ("macro_steps_taken",)}
    assert all(math.isfinite(v) for vs in pins.values() for v in vs)
    return pins


def rl() -> dict:
    kw = A.rl_env_kwargs(macro=True)
    return {"rl_tx_gaia": torch_rl_pins.scripted("rl_tx_gaia", kw),
            "ppo": torch_rl_pins.ppo(kw, n_iterations=1)}


def literal(pins: dict, name: str) -> str:
    """``name = {...}``: each key's value (a number or a list, one entry
    per case or replica) wrapped to 79 columns."""
    lines = [f"{name} = {{"]
    for key, v in pins.items():
        if isinstance(v, dict):
            lines.append(f'    "{key}": {{')
            lines += [f'        "{k}": {x!r},' for k, x in v.items()]
            lines.append("    },")
            continue
        lines.append(f'    "{key}": [')
        lines.append(textwrap.fill(", ".join(repr(x) for x in v) + ",",
                                   width=79, initial_indent=" " * 8,
                                   subsequent_indent=" " * 8))
        lines.append("    ],")
    lines.append("}")
    return "\n".join(lines)


def main(argv) -> int:
    parts = argv or ["replay", "fleet", "rl"]
    for part in parts:
        t0 = time.time()
        pins = {"replay": replay, "fleet": fleet, "rl": rl}[part]()
        print(f"# {part}: {time.time() - t0:.1f} s, jax {jax.__version__}",
              file=sys.stderr)
        if part == "rl":
            print(torch_rl_pins.literal(pins, "PINNED_RL_MACRO"))
        else:
            print(literal(pins, "PINNED_MACRO" if part == "replay"
                          else "PINNED_FLEET_MACRO"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
