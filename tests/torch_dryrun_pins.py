"""Print the dry-run pins for ``repro_torch.configs.acceptance``
(``PINNED_DRYRUN``): the JAX package's dry-run records of the cells
``acceptance.DRYRUN_CELLS``, made by ``python -m repro.launch.dryrun
--no-probes`` in a subprocess (its 512 fake XLA devices must be set before
jax starts), one cell at a time, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_dryrun_pins.py

Not a test module: a cell takes ~45 s (gemma3-1b train_4k) or ~6 s
(qwen3-4b decode_32k) on an 8-core CPU. It prints the assignment to paste
into ``acceptance.py`` on standard output: the records' keys, and per
cell the memory that the port's dry-run is held to and the fields the JAX
package computes without a trace; then ``PINNED_DRYRUN_FIELDS``, those
fields for ``acceptance.DRYRUN_CHIP_CELLS`` from the JAX package's
functions (no compile).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import jax

from repro_torch.configs import acceptance as A

HELD = ("status", "n_chips", "optimizer", "params_b", "active_params_b",
        "tokens_per_step", "model_flops_total")


def jax_fields(arch: str, shape: str, mesh: str) -> dict:
    """The JAX dry-run's fields that need no trace (its ``run_cell``'s
    lines), from the JAX package's own functions, in this process."""
    from repro.configs import SHAPES, get_arch, shape_applicable
    from repro.models import count_params_analytic
    from repro.optim import default_optimizer_for

    cfg, sh = get_arch(arch), SHAPES[shape]
    ok, why = shape_applicable(cfg, sh)
    if not ok:
        return {"status": "SKIP", "reason": why}
    n = count_params_analytic(cfg)
    active = count_params_analytic(cfg, active_only=True)
    tokens = sh.global_batch * (1 if sh.mode == "decode" else sh.seq_len)
    per = 6.0 if sh.mode == "train" else 2.0
    return {"status": "OK", "n_chips": 512 if mesh == "multi" else 256,
            "optimizer": default_optimizer_for(n), "params_b": n / 1e9,
            "active_params_b": active / 1e9,
            "tokens_per_step": float(tokens),
            "model_flops_total": per * active * tokens}


def jax_record(arch: str, shape: str, mesh: str) -> dict:
    with tempfile.TemporaryDirectory() as out:
        subprocess.run([sys.executable, "-m", "repro.launch.dryrun",
                        "--arch", arch, "--shape", shape, "--mesh", mesh,
                        "--no-probes", "--out", out], check=True,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"},
                       stdout=sys.stderr)
        with open(os.path.join(out, f"{arch}__{shape}__{mesh}.json")) as f:
            return json.load(f)


def literal(records: dict) -> str:
    """``DRYRUN_KEYS`` (the records' keys, one set for every cell) and
    ``PINNED_DRYRUN`` as Python source."""
    keys = sorted({k for rec in records.values() for k in rec})
    out, row = ["DRYRUN_KEYS = ("], "   "
    for k in keys:
        if len(row) + len(k) + 4 > 76:
            out.append(row)
            row = "   "
        row += f' "{k}",'
    out += [row, ")", "PINNED_DRYRUN = {"]
    for cell, rec in records.items():
        m = rec["memory"]
        out += [f'    "{cell}": {{',
                f'        "memory": {{"argument_bytes": {m["argument_bytes"]},'
                f' "output_bytes": {m["output_bytes"]},',
                f'                   "temp_bytes": {m["temp_bytes"]},'
                f' "alias_bytes": {m["alias_bytes"]}}},']
        out += [f'        "{k}": {json.dumps(rec[k])},' for k in HELD]
        out.append("    },")
    return "\n".join(out + ["}"])


def fields_literal(cells: dict) -> str:
    """``PINNED_DRYRUN_FIELDS`` as Python source."""
    out = ["PINNED_DRYRUN_FIELDS = {"]
    for cell, fields in cells.items():
        out.append(f'    "{cell}": {{')
        row = "        "
        for k, v in fields.items():
            item = f'"{k}": {json.dumps(v)}'
            if len(row) + len(item) + 2 > 78:
                out.append(row.rstrip())
                row = "        "
            row += item + ", "
        out += [row.rstrip(), "    },"]
    return "\n".join(out + ["}"])


def main() -> None:
    records = {f"{a}__{s}__{m}": jax_record(a, s, m)
               for a, s, m in A.DRYRUN_CELLS}
    print(f"# jax {jax.__version__}")
    print(literal(records))
    print(fields_literal({f"{a}__{s}__{m}": jax_fields(a, s, m)
                          for a, s, m in A.DRYRUN_CHIP_CELLS}))


if __name__ == "__main__":
    main()
