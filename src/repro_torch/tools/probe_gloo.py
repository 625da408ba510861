"""Which collectives gloo runs on card tensors: each of the four that
DTensor's redistributions issue (all-gather into one tensor,
reduce-scatter, all-reduce, all-to-all), both as a ``torch.distributed``
call and as the functional collective DTensor itself issues, in a fresh
gloo world of two ranks sharing ``cuda:0`` of its own, so a rank that
crashes (a signal) spoils no other probe. Prints one JSON line: probe ->
"ok", the exception's text, or the signal that ended a rank.

  PYTHONPATH=src python3 -m repro_torch.tools.probe_gloo [--device cpu]
  PYTHONPATH=src python3 -m repro_torch.tools.probe_gloo --subgroups

``launch.mesh.stage_collectives_through_host`` routes DTensor's
collectives around whatever this finds refused on the card.

``--subgroups``: a gloo world of 8 CPU ranks on a (4, 2) mesh, SUBGROUP_
REPS reduce-scatters over the model axis (a subgroup of 2) of fresh
(2, 32, 64) products in bfloat16 and in float32, each result checked
finite on every rank; prints the non-finite results by dtype. The
sharded training step in bfloat16 on a mesh with both axes over 1 runs
such collectives.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

PROBES = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
          "all_to_all_single")
SUBGROUP_REPS = 400


def _probe(rank: int, name: str, functional: bool, device: str, store: str,
           out: str) -> None:
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc

    if device.startswith("cuda"):
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    x = torch.arange(8, dtype=torch.float32, device=device) + rank
    group = dist.group.WORLD
    try:
        if functional:
            fn = {"all_gather_into_tensor":
                  lambda: fc.all_gather_tensor(x, 0, group),
                  "reduce_scatter_tensor":
                  lambda: fc.reduce_scatter_tensor(x, "sum", 0, group),
                  "all_reduce": lambda: fc.all_reduce(x, "sum", group),
                  "all_to_all_single":
                  lambda: fc.all_to_all_single(x, None, None, group)}[name]
            y = fn()
            y = y.wait() if hasattr(y, "wait") else y
        else:
            y = torch.empty(16 if name == "all_gather_into_tensor" else
                            4 if name == "reduce_scatter_tensor" else 8,
                            device=device)
            if name == "all_reduce":
                y.copy_(x)
                dist.all_reduce(y)
            else:
                getattr(dist, name)(y, x)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        result = "ok" if torch.isfinite(y).all() else "non-finite"
    except Exception as e:     # a refusal is the finding
        result = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    with open(os.path.join(out, f"{rank}.txt"), "w") as f:
        f.write(result)
    dist.destroy_process_group()


def probe(name: str, functional: bool, device: str) -> str:
    import torch.multiprocessing as mp

    work = tempfile.mkdtemp(prefix="probe_gloo-")
    ctx = mp.start_processes(
        _probe, args=(name, functional, device, os.path.join(work, "store"),
                      work), nprocs=2, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=60):
            pass
    except Exception as e:     # a rank ended by a signal
        return f"{type(e).__name__}: {str(e).strip()[:200]}"
    with open(os.path.join(work, "0.txt")) as f:
        return f.read()


def _subgroup_rank(rank: int, dtype, store: str, out: str) -> None:
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=8)
    group = init_device_mesh("cpu", (4, 2),
                             mesh_dim_names=("data", "model")).get_group(1)
    bad = 0
    for rep in range(SUBGROUP_REPS):
        gen = torch.Generator().manual_seed(rank * 100_000 + rep)
        a, b = (torch.randn(shape, generator=gen).to(dtype)
                for shape in ((64, 32), (32, 64)))
        y = fc.reduce_scatter_tensor((a @ b).reshape(2, 32, 64), "sum", 1,
                                     group)
        y = y.wait() if hasattr(y, "wait") else y
        bad += int(not bool(torch.isfinite(y.float()).all()))
    with open(os.path.join(out, f"{rank}.txt"), "w") as f:
        f.write(str(bad))
    dist.destroy_process_group()


def subgroups() -> dict:
    """Non-finite reduce-scatter results over a subgroup, by dtype, summed
    over the 8 ranks (see the module docstring)."""
    import torch.multiprocessing as mp

    found = {}
    for dtype in (torch.bfloat16, torch.float32):
        work = tempfile.mkdtemp(prefix="probe_gloo-")
        mp.start_processes(_subgroup_rank, args=(
            dtype, os.path.join(work, "store"), work), nprocs=8, join=True,
            start_method="spawn")
        found[str(dtype)] = sum(int(open(os.path.join(work, f"{r}.txt"))
                                    .read()) for r in range(8))
    return found


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--subgroups", action="store_true")
    args = ap.parse_args(argv)
    if args.subgroups:
        found = subgroups()
        print(json.dumps({"torch": torch.__version__, "reps_a_rank":
                          SUBGROUP_REPS, "non_finite": found}), flush=True)
        return found
    found = {f"{'functional' if fn else 'c10d'} {name}":
             probe(name, fn, args.device)
             for fn in (False, True) for name in PROBES}
    print(json.dumps({"device": args.device, "torch": torch.__version__,
                      "probes": found}), flush=True)
    return found


if __name__ == "__main__":
    main()
