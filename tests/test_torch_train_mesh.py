"""Sharded LM training on ``torch.distributed`` (DTensor meshes) against
the JAX package's unsharded training, on the CPU.

One gloo world of 8 CPU ranks (``launch.mesh.spawn_world``, the rank
programs in ``tests/_torch_train_mesh_workers.py``) runs every case while
this process computes the JAX package's references:

- reduced qwen3-4b on (2, 4), 3 AdamW steps: q's 4 heads split over the
  model axis, the 2 KV heads whole (each rank hands the kernel the KV head
  of its q head);
- reduced gemma3-1b with 8 layers (6 window layers of 16, 2 global; Kv 1)
  on (4, 2): 2 local q heads a rank;
- reduced granite-3-8b with Adafactor on (8, 1): FSDP alone;
- the other families: reduced mixtral on (2, 4) (expert parallelism, 4
  experts over a model axis of 4, G = 2 groups, capacity factor 1 so
  that slots drop), reduced grok-1 on (1, 8) (4 experts over 8: d_ff
  split inside the experts), reduced jamba cut to the first 4 layers of
  its period on (4, 2) (Mamba on 64 local channels, attention, experts
  over 2), reduced xlstm, the VLM (xgate opened) and whisper on (2, 4);

each held by ``acceptance.check_train`` at ``TRAIN_TOLS`` to the JAX
package's unsharded run with ``dp_size`` the mesh's data axis (an MoE
layer's groups; ``torch_train_pins.jax_train_summary``), as
``tests/test_torch_train_launch.py`` holds the one-card port. The
mixtral case's first forward drops, layer by layer, the slots the JAX
package's drops. ``local_scan`` against the plain fused scan: the output
and the final state bit for bit, the gradients within SCAN_TOL (measured:
xb's, dt's and z's bit for bit; B's and C's, partial sums over the model
axis, 4.0e-8 to 1.3e-7; dt_b's, A's and D_skip's, partial sums over the
data axis, 1.1e-7 to 3.2e-7). Then
``local_attention`` against the plain attention, the largest difference
over the largest value within ATTN_TOL (measured: the output and q's
gradient bit for bit; k's and v's 1.0e-7 to 3.7e-7 where their gradients
are partial sums over the model axis); the guard, remat "layer" and what
a bf16 model's forward receives on (2, 4) (no bf16 step runs here:
gloo's bf16 collectives on the CPU return non-finite values now and
then, ``tools/probe_gloo.py --subgroups``); the elastic restore (2, 4)
-> (8, 1) and ->
one device (1, 1), bit for bit, for a dense state and for an MoE state
saved under expert parallelism; and ``launch.train.main --model-axis 2``
on (4, 2), reduced qwen3-4b and reduced jamba, trained whole and resumed
from its checkpoint, bit for bit, and within LAUNCH_TOL of the unsharded
launcher. Every one of the ten archs builds a sharded train step.
"""

import dataclasses
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced

from repro_torch.configs import acceptance as A
from repro_torch.configs import get_arch, reduced
from repro_torch.optim import AdamW
from repro_torch.sharding.ctx import make_ctx
from repro_torch.train import make_train_step

sys.path.insert(0, os.path.dirname(__file__))
import _torch_train_mesh_workers as W  # noqa: E402
import torch_train_pins  # noqa: E402

ATTN_TOL = 1e-6
SCAN_TOL = 1e-6
LAUNCH_TOL = 1e-5
WORLD = 8
ARCHS = ("gemma3-1b", "qwen3-4b", "granite-3-8b", "internlm2-20b",
         "mixtral-8x22b", "grok-1-314b", "jamba-1.5-large-398b",
         "xlstm-125m", "llama-3.2-vision-11b", "whisper-small")


def _jax_config(arch, cfg):
    jcfg = jax_reduced(jax_get_arch(arch))
    return dataclasses.replace(
        jcfg, n_layers=cfg.n_layers, swa_window=cfg.swa_window,
        moe=dataclasses.replace(jcfg.moe, **dataclasses.asdict(cfg.moe)))


def _jax_dropped() -> list:
    """The slots each MoE layer of the JAX package's forward drops, on
    the mixtral case's weights and first batch, with ``dp_size`` its
    mesh's data axis."""
    from repro.data.synth_lm import lm_batch_at as jax_lm_batch_at
    from repro.models.model import forward_train as jax_forward_train
    from repro.sharding.ctx import ShardCtx

    from _torch_moe_ref import jax_dropped_slots

    arch, cfg, (data, _), _, _ = W.case_configs()["mixtral"]
    params = jax.tree.map(jnp.asarray, W.case_tree(cfg))
    batch = jax_lm_batch_at(0, vocab=cfg.vocab, batch=W.BATCH,
                            seq_len=W.SEQ, seed=A.TRAIN_DATA_SEED)
    with jax_dropped_slots() as counts:
        jax_forward_train(params, batch, _jax_config(arch, cfg),
                          ShardCtx(enabled=False, dp_size=data))
        jax.effects_barrier()
    return list(counts)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the world's results on rank 0 and on every rank, the JAX
    package's summaries by case): the world runs in a thread while the
    references are computed here."""
    from repro_torch.launch.mesh import spawn_world

    work = str(tmp_path_factory.mktemp("train_mesh"))
    done = {}

    def run():
        try:
            done["ranks"] = spawn_world(
                W.mesh_cases, WORLD, backend="gloo", devices=["cpu"] * WORLD,
                args=(work,), timeout=600)
        except BaseException as e:      # re-raised below
            done["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    refs = {}
    for name, (arch, cfg, (data, _), opt, leaves) in \
            W.case_configs().items():
        refs[name] = torch_train_pins.jax_train_summary(
            _jax_config(arch, cfg), W.case_tree(cfg), steps=W.STEPS,
            batch=W.BATCH, seq=W.SEQ, optimizer=opt, leaves=leaves,
            dp_size=data)
    refs["dropped"] = _jax_dropped()
    thread.join()
    if "error" in done:
        raise done["error"]
    return done["ranks"], refs, work


@pytest.mark.parametrize("case", sorted(W.case_configs()))
def test_sharded_steps_meet_the_jax_package(world, case):
    ranks, refs, _ = world
    got = ranks[0][case]["summary"]
    report = A.check_train(got, refs[case])
    assert report["dist_loss"] <= A.TRAIN_TOLS["loss"]
    assert got["skipped"] == [0.0] * W.STEPS
    # every rank saw the same whole metrics and leaves
    assert all(r[case]["summary"] == got for r in ranks)


def test_dropped_slots_equal_the_jax_package(world):
    """Expert parallelism with G = 2 and a capacity factor of 1: the
    slots each MoE layer drops, summed over the data axis (the model
    axis's ranks route the same tokens), equal the JAX package's, and
    some drop."""
    ranks, refs, _ = world
    seen = {}
    for r in ranks:
        d = r["dropped"]
        seen.setdefault(d["coordinate"][1], []).append(d["dropped"])
    totals = {m: [sum(x) for x in zip(*per)] for m, per in seen.items()}
    assert len(totals) == 4
    assert all(t == refs["dropped"] for t in totals.values()), (
        totals, refs["dropped"])
    assert min(refs["dropped"]) > 0


def test_local_scan_matches_the_plain_scan(world):
    ranks, _, _ = world
    got = ranks[0]["scan"]
    assert sorted(got) == ["tp2", "tp4"]
    for name, errs in got.items():
        assert errs["out"] == 0.0 and errs["final"] == 0.0, (name, errs)
        assert errs["placements"] == "(Shard(dim=0), Shard(dim=2))"
        assert max(v for k, v in errs.items() if k.startswith("d")) \
            <= SCAN_TOL, (name, errs)


def test_local_attention_matches_the_plain_attention(world):
    ranks, _, _ = world
    got = ranks[0]["attention"]
    assert sorted(got) == ["H12/Kv3/tp2", "H4/Kv2/tp4", "H8/Kv2/tp4",
                           "H8/Kv4/tp4"]
    for name, errs in got.items():
        assert max(errs.values()) <= ATTN_TOL, (name, errs)


def test_guard_remat_and_the_bf16_cast_on_a_mesh(world):
    """A NaN parameter skips the sharded step and keeps the state bit for
    bit (the step count still advances); remat "layer" equals "block" bit
    for bit; a bf16 model's forward receives its masters cast on their
    shards (bf16, each laid out as its f32 master) with
    ``cast_params_bf16``, the f32 masters without it."""
    ranks, _, _ = world
    got = ranks[0]["steps"]
    assert got["guard"] == {"skipped": 1.0, "step": 1, "kept": True}
    assert got["block = layer"]
    masters = got["masters"]
    assert {d for d, _ in masters.values()} == {"torch.float32"}
    assert got["cast False"] == masters
    assert got["cast True"] == {n: ("torch.bfloat16", p)
                                for n, (_, p) in masters.items()}
    assert any("Shard" in p for _, p in masters.values())


def test_elastic_restore_is_bit_for_bit(world):
    """Saved on (2, 4), restored onto (8, 1) in the world and onto one
    device there and here: every leaf's bytes equal the saved state's."""
    from repro_torch.checkpoint import restore

    ranks, _, work = world
    _, _, state = W.elastic_state()
    for r in ranks:
        e = r["elastic"]
        assert e["on_8x1"] == e["saved"] == e["on_1x1"]
    # (tp, fsdp) and (None, fsdp, tp): data splits the fsdp dim, the model
    # axis of 1 the tp dim
    assert ranks[0]["elastic"]["placements_8x1"] == {
        "emb": "(Shard(dim=1), Shard(dim=0))",
        "opt/m/body/0/wq": "(Shard(dim=1), Shard(dim=2))"}
    here = restore(os.path.join(work, "elastic"), 3, state)
    assert W._digest(here) == W._digest(state) == ranks[0]["elastic"][
        "saved"]


def _launched(world, key: str, arch: str) -> None:
    """The launcher's run ``key`` of the world (``arch`` with
    ``--model-axis 2``): 4 steps, then steps 2-3 again from the
    checkpoint after step 2 with ``--resume``: equal metrics and final
    checkpoints, bit for bit; the losses within LAUNCH_TOL of the
    unsharded launcher's."""
    from repro_torch.launch import train

    ranks, _, work = world
    run = ranks[0][key]
    assert [h["step"] for h in run["whole"]] == [0, 1, 2, 3]
    assert [h["step"] for h in run["resumed"]] == [2, 3]
    assert run["resumed"] == [
        {**h, "tok_per_s": r["tok_per_s"]}
        for h, r in zip(run["whole"][2:], run["resumed"])]
    at = os.path.join(work, arch)
    for f in sorted(os.listdir(os.path.join(at, "whole",
                                            "step_0000000003"))):
        if f.endswith(".npy"):
            a, b = (np.load(os.path.join(at, d, "step_0000000003", f))
                    for d in ("whole", "resumed"))
            assert a.tobytes() == b.tobytes(), f
    args = W.launcher_args(os.path.join(at, "one"), arch=arch)
    one = train.main(args[:args.index("--model-axis")])
    for h, w in zip(run["whole"], one):
        for k in ("loss", "grad_norm"):
            assert abs(h[k] - w[k]) <= LAUNCH_TOL * abs(w[k]), (k, h, w)


def test_launcher_trains_and_resumes_on_a_mesh(world):
    """``--model-axis 2`` in a world of 8 (``_launched``), qwen3-4b."""
    _launched(world, "launcher", "qwen3-4b")


def test_launcher_trains_and_resumes_jamba_on_a_mesh(world):
    """The same for reduced jamba: Mamba on local channels and experts
    (capacity factor 4: nothing drops, so the groups of the mesh's data
    axis route as the unsharded launcher's one group)."""
    _launched(world, "launcher_jamba", "jamba-1.5-large-398b")


def test_staged_all_gather_equals_gloo(world):
    """The host route DTensor's all-gathers take on card tensors under
    gloo equals the collective itself, one counted call of 24 bytes a
    rank; and it is the CUDA kernel of the op once installed."""
    from repro_torch.launch.mesh import STAGED_OPS, stage_collectives_through_host

    ranks, _, _ = world
    for r in ranks:
        assert r["staged"] == {"equal": True, "shape": (48,), "calls": 1,
                               "bytes": 24}
    stage_collectives_through_host()
    for name in STAGED_OPS:
        assert torch._C._dispatch_has_kernel_for_dispatch_key(
            f"_c10d_functional::{name}", "CUDA")


def test_meshes_refuse_a_small_world(world):
    """The production meshes need 256 and 512 ranks: a world of 8 is
    refused loudly, as the JAX package refuses too few devices; with no
    process group at all, so is ``make_mesh_for``."""
    from repro_torch.launch.mesh import make_mesh_for

    ranks, _, _ = world
    assert ranks[0]["production"] == [
        "the production mesh (16, 16): need 256 ranks, have 8",
        "the production mesh (2, 16, 16): need 512 ranks, have 8"]
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh_for(model_axis=2, device="cpu")


def test_model_axis_needs_a_world():
    from repro_torch.launch import train

    with pytest.raises(ValueError, match="world of ranks"):
        train.main(["--arch", "qwen3-4b", "--reduced", "--model-axis", "2",
                    "--device", "cpu", "--steps", "1"])


@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_is_taken_under_a_mesh(arch):
    for cfg in (get_arch(arch), reduced(get_arch(arch))):
        assert callable(make_train_step(cfg, AdamW(),
                                        make_ctx(False, tp_size=2)))
        assert callable(make_train_step(cfg, AdamW()))


def test_kv_heads_of_local_q_heads():
    from repro_torch.models.layers import kv_heads_of

    # H 4, Kv 2 over 4 ranks: q head r reads KV head r // 2
    assert [kv_heads_of(r, 1, 4, 2) for r in range(4)] == [[0], [0], [1],
                                                            [1]]
    # gemma3-1b over 2: both local q heads read the one KV head
    assert kv_heads_of(2, 2, 4, 1) == [0]
    # whole groups: H 8, Kv 4 over 2 -> two KV heads a rank
    assert kv_heads_of(4, 4, 8, 4) == [2, 3]
    # straddling: H 12, Kv 3 (groups of 4) over 2 -> one KV head a q head
    assert kv_heads_of(0, 6, 12, 3) == [0, 0, 0, 0, 1, 1]
    assert kv_heads_of(6, 6, 12, 3) == [1, 1, 2, 2, 2, 2]


def test_moe_elastic_restore_is_bit_for_bit(world):
    """A reduced mixtral state saved on (2, 4) under expert parallelism
    (4 experts over the model axis of 4), restored onto (8, 1) (FSDP
    alone) in the world and onto one device there and here: every leaf's
    bytes equal the saved state's."""
    from repro_torch.checkpoint import restore

    ranks, _, work = world
    _, _, state = W.elastic_state("mixtral-8x22b")
    for r in ranks:
        e = r["elastic_moe"]
        assert e["on_8x1"] == e["saved"] == e["on_1x1"]
    # (None, tp, fsdp, None) for the stacked experts: data splits dim 2,
    # the model axis of 1 dim 1 (the experts)
    assert ranks[0]["elastic_moe"]["placements_8x1"] == {
        "emb": "(Shard(dim=1), Shard(dim=0))",
        "opt/m/body/0/e_wg": "(Shard(dim=2), Shard(dim=1))"}
    here = restore(os.path.join(work, "elastic_moe"), 3, state)
    assert W._digest(here) == W._digest(state) == ranks[0]["elastic_moe"][
        "saved"]


def test_scan_kernels_refuse_a_dtensor():
    """The Mamba scan's wrappers refuse a DTensor outright (a rank passes
    its local shards, ``local_scan``), as ``flash_attention`` does."""
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels.selective_scan import mamba_scan, selective_scan

    class Fake(DTensor):
        pass

    x = torch.zeros(1, 4, 8)
    fake = torch.Tensor._make_subclass(Fake, x)
    A = -torch.ones(8, 4)
    bc = torch.zeros(1, 4, 4)
    with pytest.raises(TypeError, match="DTensor"):
        mamba_scan(fake, x, x[0, 0], A, bc, bc, x, x[0, 0])
    with pytest.raises(TypeError, match="DTensor"):
        selective_scan(fake, x, A, bc, bc)


def test_flash_attention_refuses_a_dtensor():
    """The kernel's wrapper refuses a DTensor outright (a rank passes its
    local shards); the check reads only ``isinstance``, so a bare DTensor
    subclass stands in, with no process group."""
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels.flash_attn import flash_attention

    class Fake(DTensor):
        pass

    q = torch.zeros(1, 4, 2, 16)
    fake = torch.Tensor._make_subclass(Fake, q)
    with pytest.raises(TypeError, match="DTensor"):
        flash_attention(fake, q, q)
