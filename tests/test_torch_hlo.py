"""The port's ``utils/hlo.py`` (a copy of the JAX package's) on the JAX
package's HLO sample, and the dry-run's collective counter held to the
parser's kind names and byte convention: one all-gather and one
all-reduce of known sizes on a fake world of 4 ranks, counted by
``launch.dryrun.StepCosts`` and, written as HLO lines of the same
results, by ``parse_collectives``."""

import pytest
import torch

from repro.utils.hlo import parse_collectives as jax_parse_collectives

from repro_torch.utils.hlo import FUNCTIONAL_KINDS, parse_collectives

# the JAX package's sample (tests/test_hlo_and_specs.py)
HLO_SAMPLE = """
HloModule jit_step
%fused (a: bf16[8,128]) -> bf16[8,128] { ... }
%ag = bf16[16,4096]{1,0} all-gather(%x), replica_groups={{0,1}}
%ar = f32[256]{0} all-reduce(%y), to_apply=%add
%rs = f32[32,16]{1,0} reduce-scatter(%z), dimensions={0}
%a2a = bf16[4,64]{1,0} all-to-all(%w), dimensions={0}
%cp = u8[1024]{0} collective-permute(%v), source_target_pairs={{0,1}}
%ars = f32[256]{0} all-reduce-start(%y2), to_apply=%add
%ard = f32[256]{0} all-reduce-done(%ars)
"""


def test_parse_collectives_counts_and_bytes():
    stats = parse_collectives(HLO_SAMPLE)
    assert stats.count_by_kind["all-gather"] == 1
    assert stats.bytes_by_kind["all-gather"] == 16 * 4096 * 2
    assert stats.bytes_by_kind["all-reduce"] == 256 * 4 * 2  # incl. -start
    assert stats.count_by_kind["all-reduce"] == 2
    assert stats.bytes_by_kind["reduce-scatter"] == 32 * 16 * 4
    assert stats.bytes_by_kind["all-to-all"] == 4 * 64 * 2
    assert stats.bytes_by_kind["collective-permute"] == 1024
    # -done lines are not double counted
    assert stats.total_count == 6
    want = jax_parse_collectives(HLO_SAMPLE)
    assert stats.bytes_by_kind == want.bytes_by_kind
    assert stats.count_by_kind == want.count_by_kind


def test_parse_collectives_ignores_non_collective_lines():
    stats = parse_collectives("%x = f32[8] add(%a, %b)\n%y = call()")
    assert stats.total_bytes == 0


@pytest.fixture
def fake_world():
    import torch.distributed as dist

    from repro_torch.launch.dryrun import make_mesh

    yield make_mesh("custom:2,2")[0]
    dist.destroy_process_group()


def test_the_collective_counter_agrees_with_the_parser(fake_world):
    """A bf16 (16, 4096) all-gathered from (8, 4096) shards over ``data``
    and an f32 (256,) all-reduced over ``model``: the counter gives each
    the kind and the result bytes ``parse_collectives`` reads off the HLO
    line of the same result."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.dryrun import StepCosts

    mesh = fake_world
    x = DTensor.from_local(
        torch.empty(8, 4096, dtype=torch.bfloat16, device="meta"), mesh,
        (Shard(0), Replicate()), run_check=False, shape=(16, 4096),
        stride=(4096, 1))
    y = DTensor.from_local(torch.empty(256, device="meta"), mesh,
                           (Replicate(), Partial()), run_check=False)
    with StepCosts() as costs:
        x.redistribute(mesh, (Replicate(), Replicate()))
        y.redistribute(mesh, (Replicate(), Replicate()))
    hlo = parse_collectives(
        "%ag = bf16[16,4096]{1,0} all-gather(%x), replica_groups={{0,1}}\n"
        "%ar = f32[256]{0} all-reduce(%y), to_apply=%add\n")
    assert costs.collectives.count_by_kind == hlo.count_by_kind == {
        "all-gather": 1, "all-reduce": 1}
    assert costs.collectives.bytes_by_kind == hlo.bytes_by_kind
    assert set(FUNCTIONAL_KINDS.values()) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all"}
