"""Fleet runner: R datacenter replicas under heterogeneous grid scenarios,
scheduling policies and workload telemetry, in one batched run.

``run_fleet`` broadcasts one initial ``SimState`` across R replicas (or
takes an already replica-batched one), installs a per-replica
``Scenario`` (``scenarios.stack_scenarios`` / ``sample_scenarios``) and
optionally a per-replica ``placement.Policy`` (``stack_policies`` /
``policy_grid``) and workload id into a banked trace, derives each
replica's PRNG key words as the JAX package's ``split`` / ``fold_in`` do,
and runs ``run_episode`` on the batched state: every field carries a
leading replica axis E, the step's reductions run per replica, and each
of the tick's kernels takes E as its grid, so the host issues one tick's
launches for all R replicas. This is the JAX package's vmapped
``run_fleet``. With the snapshot arguments one crash-atomic snapshot
holds the whole batch (``checkpoint.episode.run_fleet_snapshotted``).

With ``mesh=`` (a ``launch.mesh.FleetMesh``) the replica axis splits
across the mesh's ranks in contiguous blocks, as the JAX package's
``shard_map`` path splits it across devices: every rank sets up the
whole batch (keys, scenarios, policies, workload ids), runs
``run_episode`` on its own block, and all-gathers the final states and
telemetry (``sharding.specs.gather_fleet``), so every rank returns the
whole result. No collective runs inside the ticks: each rank's macro
lockstep spans only its own replicas. A replica's run does not depend on
which rank holds it, so the result equals the single-process run bit for
bit.

With ``macro=True`` the replicas macro-step in lockstep
(``sim.make_macro_step``): each macro step runs an event tick on every
replica with ticks left, then fast ticks under a per-replica mask, so
replicas sit at different times and each keeps its own segments, as
under the JAX package's ``vmap``.

Nothing here reads a tensor on the host once the inputs are on the card:
the keys are derived on the state's device, and the host data (policy
ids, workload ids, scenarios) go there by asynchronous copies. (The
macro engine's counted reads are its own: ``utils.device.host_read``.)
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.sim import SimConfig
from repro_torch.core.placement import Policy, make_policy, stack_policies
from repro_torch.core.sim import (
    StepOut,
    TelemetrySummary,
    run_episode,
    summary_columns,
)
from repro_torch.core.state import SimState, Statics, broadcast_state
from repro_torch.scenarios.scenario import Scenario, n_replicas, stack_scenarios
from repro_torch.sharding.specs import FLEET_AXIS, fleet_block, gather_fleet
from repro_torch.utils import prng
from repro_torch.utils.device import to_device, tree_to
from repro_torch.utils.errors import ConfigError


def _ensure_batched(scenarios) -> Scenario:
    # NB: Scenario is itself a (Named)tuple — test for it first
    if isinstance(scenarios, Scenario):
        return scenarios
    return stack_scenarios(list(scenarios))


def _as_policy(p) -> Policy:
    # NB: Policy is itself a (Named)tuple — test for it before the
    # (select, place) name-tuple form
    if isinstance(p, Policy):
        return p
    return make_policy(*p)


def _policy_list(policies) -> List[Policy]:
    """Normalize any accepted policies input — a single Policy, a batched
    Policy (leading replica axis, e.g. from ``policy_grid``), or a list of
    Policies / (select, place) name tuples — to a list of scalar
    Policies."""
    if isinstance(policies, Policy):
        if policies.select.dim() == 0:
            return [policies]
        return [Policy(policies.select[i], policies.place[i])
                for i in range(policies.select.shape[0])]
    return [_as_policy(p) for p in policies]


def _ensure_batched_policies(policies) -> Policy:
    if isinstance(policies, Policy) and policies.select.dim() == 1:
        return policies
    return stack_policies(_policy_list(policies))


def _unstack(tree, i: int):
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return type(tree)(*(_unstack(v, i) for v in tree))


def _scenario_list(scenarios) -> List[Scenario]:
    """Normalize a single Scenario, a batched Scenario (leading replica
    axis), or an iterable of Scenarios to a list of unbatched Scenarios —
    iterating a Scenario NamedTuple directly would yield its FIELDS, not
    its replicas."""
    if isinstance(scenarios, Scenario):
        if scenarios.carbon.mean.dim() == 0:
            return [scenarios]
        return [_unstack(scenarios, i) for i in range(n_replicas(scenarios))]
    return list(scenarios)


def policy_scenario_grid(
    policies, scenarios: Scenario | Sequence[Scenario]
) -> Tuple[Policy, Scenario]:
    """Cross P policies x S scenarios -> (batched Policy, batched Scenario)
    of length P*S, ready for ``run_fleet`` (replica i = policy i // S with
    scenario i % S). ``policies``: an already-batched Policy (e.g. from
    ``policy_grid``), Policy instances, or (select, place) name tuples;
    ``scenarios``: an already-batched Scenario (e.g. from
    ``sample_scenarios``) or a list of Scenarios."""
    pols = _policy_list(policies)
    scns = _scenario_list(scenarios)
    crossed = stack_policies([p for p in pols for _ in scns])
    return crossed, stack_scenarios(scns * len(pols))


def run_fleet(
    cfg: SimConfig,
    statics: Statics,
    state: SimState,
    n_steps: int,
    scheduler: str | None = None,
    *,
    scenarios: Scenario | Sequence[Scenario] | None = None,
    policies: Policy | Sequence[Policy | Tuple[str, str]] | None = None,
    workloads: Sequence[int] | np.ndarray | None = None,
    mesh=None,
    mesh_axis: str = FLEET_AXIS,
    snapshot_every_s: float | None = None,
    snapshot_dir: str | None = None,
    resume_from: str | None = None,
    snapshot_keep: int = 3,
    **kw,
) -> Tuple[SimState, StepOut | TelemetrySummary]:
    """Simulate R replicas of the twin for ``n_steps`` in one batched run.

    ``scheduler``: selection-policy name every replica runs (default
    'fcfs'); mutually exclusive with ``policies`` (which carry the
    selection stage per replica — passing both is a loud error, not a
    silent override).
    ``scenarios``: batched Scenario (leading replica axis), a list of
    Scenarios (stacked here), or None (the statics' own scenario).
    ``policies``: the per-replica POLICY axis — a batched ``Policy``, a
    list of Policies or (select, place) name tuples, or None (every
    replica runs the ``scheduler`` string). When both axes are given their
    lengths must already match; build the cross product with
    ``policy_scenario_grid``. The step runs each named strategy on every
    replica and keeps each replica's own.
    All other statics (node constants, telemetry bank) are shared; each
    replica gets its own PRNG key words. With the fault engine on, each
    replica redraws its fault clocks from its own key and takes its
    outage windows from its scenario; a single ``state`` gives every
    replica its clocks (as the JAX package's broadcast does), a state
    from ``init_state`` with (E, 2) key words its own.

    ``workloads``: per-replica TELEMETRY axis — int ids (length R) into a
    *banked* Statics trace ((W, J, Q) ``cpu_trace``, e.g. from
    ``data.stack_workloads``); each replica's trace lookups read its
    slice of the one shared bank. The job *table* still comes from
    ``state`` (broadcast or pre-batched) — ids switch telemetry, not the
    submitted jobs.
    ``state`` may be a single SimState (broadcast to R replicas here) or
    an already replica-batched one — e.g. the final states of a previous
    ``run_fleet`` call for chained sweeps, whose keys advance by
    ``fold_in(key, 1)``. The caller's state is left as it is (the JAX
    package donates a batched state; here the run starts from a copy, and
    no result shares memory with an input).

    ``**kw`` forwards to ``run_episode``/``make_step``: ``summary_only=True``
    returns per-replica ``TelemetrySummary`` with memory independent of
    ``n_steps``, ``telemetry_every=k`` stacks one windowed summary per k
    steps after the replica axis, and ``macro=True`` macro-steps every
    replica (its summary is episode-wide or windowed).

    Durability: ``snapshot_every_s`` / ``snapshot_dir`` / ``resume_from``
    / ``snapshot_keep`` are ``run_episode``'s, for the whole batch: one
    crash-atomic snapshot of the replica-batched state (its keys
    installed, so resumed streams go on exactly) and the raw telemetry
    accumulators; a resumed sweep equals the uninterrupted one bit for
    bit. Needs ``summary_only=True`` or ``macro=True``.

    With ``REPRO_CHECKIFY=1`` every replica's final state is audited
    (``utils.invariants.check_state``), besides the per-tick checks of
    ``run_episode``.

    ``mesh``: a fleet mesh (``launch.mesh.make_fleet_mesh``, called on
    every rank of the world) splits the replica axis in contiguous blocks
    across its ``mesh_axis`` ranks; each rank runs its block and every
    rank returns the whole result (see the module docstring), equal to
    ``mesh=None`` bit for bit. R must divide evenly by the mesh size (a
    loud ``ConfigError`` otherwise, before any tick: a silent pad would
    fabricate replicas whose summaries leak into sweep statistics). With
    snapshots, one snapshot still holds the whole batch and leaves the
    mesh out of its fingerprint, so a sweep resumes on another world size.

    Returns (final_states, outs) with a leading replica axis on every leaf.
    """
    from repro_torch.utils import invariants

    fleet_statics, state, who = _prepare(
        cfg, statics, state, scheduler, scenarios=scenarios,
        policies=policies, workloads=workloads, mesh=mesh,
        mesh_axis=mesh_axis)
    if snapshot_every_s is not None or resume_from is not None \
            or snapshot_dir is not None:
        from repro_torch.checkpoint.episode import run_fleet_snapshotted

        out = run_fleet_snapshotted(
            cfg, statics, fleet_statics, state, n_steps, who, kw,
            mesh=mesh, snapshot_every_s=snapshot_every_s,
            snapshot_dir=snapshot_dir, resume_from=resume_from,
            snapshot_keep=snapshot_keep)
    elif mesh is not None:
        b_statics, b_state, b_who = _block((fleet_statics, state, who), mesh)
        out = gather_fleet(run_episode(cfg, b_statics, b_state, n_steps,
                                       b_who, **kw), mesh)
    else:
        out = run_episode(cfg, fleet_statics, state, n_steps, who, **kw)
    if invariants.enabled():
        invariants.check_state(cfg, fleet_statics, out[0])
    return out


def prepare_fleet(
    cfg: SimConfig,
    statics: Statics,
    state: SimState,
    scheduler: str | None = None,
    *,
    scenarios=None,
    policies=None,
    workloads=None,
    mesh=None,
    mesh_axis: str = FLEET_AXIS,
) -> Tuple[Statics, SimState, str | Policy]:
    """``run_fleet``'s checks and set-up without the ticks: (the statics
    with the batched scenario on the state's device, the batched state
    with its keys and workload ids, the scheduler name or batched Policy),
    ready for ``run_episode``, ``make_step`` or ``make_macro_step`` (the
    set-up is the same for both engines). With ``mesh``, the whole batch
    is set up and this rank's block of each is returned
    (``shard_fleet``; the statics stay whole but their scenario)."""
    out = _prepare(cfg, statics, state, scheduler, scenarios=scenarios,
                   policies=policies, workloads=workloads, mesh=mesh,
                   mesh_axis=mesh_axis)
    return out if mesh is None else _block(out, mesh)


# the JAX package's name for a rank's block of a replica-batched tree (its
# ``device_put`` onto the mesh)
shard_fleet = fleet_block


def _block(prepared, mesh):
    """A ``_prepare`` triple's block for this rank: the statics whole but
    their batched scenario, the state's and the policies' blocks."""
    statics, state, who = prepared
    return (statics._replace(scenario=fleet_block(statics.scenario, mesh)),
            fleet_block(state, mesh),
            who if isinstance(who, str) else fleet_block(who, mesh))


def _check_mesh(mesh, mesh_axis: str, R: int) -> None:
    """The reference's refusals of a mesh, before any tick."""
    from repro_torch.launch.mesh import FleetMesh

    if not isinstance(mesh, FleetMesh):
        raise ConfigError(
            f"mesh= takes a launch.mesh.FleetMesh, got "
            f"{type(mesh).__name__} — build one on every rank with "
            "launch.mesh.make_fleet_mesh()")
    if mesh_axis not in mesh.shape:
        raise ConfigError(
            f"mesh has axes {tuple(mesh.shape)}, no {mesh_axis!r} — "
            "build a fleet mesh with launch.mesh.make_fleet_mesh()")
    n_shards = int(mesh.shape[mesh_axis])
    if R % n_shards:
        raise ConfigError(
            f"{R} replicas do not divide across {n_shards} "
            f"{mesh_axis!r}-axis devices — a silent pad would "
            "fabricate replicas; pick R as a multiple of the mesh "
            "size or shrink the mesh (a world of fewer ranks)")


def _prepare(
    cfg: SimConfig,
    statics: Statics,
    state: SimState,
    scheduler: str | None = None,
    *,
    scenarios=None,
    policies=None,
    workloads=None,
    mesh=None,
    mesh_axis: str = FLEET_AXIS,
) -> Tuple[Statics, SimState, str | Policy]:
    """``prepare_fleet`` for the whole batch (the mesh only checked)."""
    if policies is not None and scheduler is not None:
        raise ConfigError(
            f"both scheduler={scheduler!r} and policies= given — policies "
            "carry the selection stage, so the scheduler name would be "
            "silently ignored; pass exactly one")
    if scheduler is None:
        scheduler = "fcfs"
    if policies is not None:
        policies = _ensure_batched_policies(policies)
        P = int(policies.select.shape[0])
        if scenarios is None:
            scenarios = stack_scenarios([statics.scenario] * P)
        else:
            scenarios = _ensure_batched(scenarios)
            if n_replicas(scenarios) != P:
                raise ConfigError(
                    f"{P} policies vs {n_replicas(scenarios)} scenarios — "
                    "axes must match; build the cross product with "
                    "policy_scenario_grid(policies, scenarios)")
    elif scenarios is None:
        scenarios = stack_scenarios([statics.scenario])
    else:
        scenarios = _ensure_batched(scenarios)
    R = n_replicas(scenarios)
    if mesh is not None:
        _check_mesh(mesh, mesh_axis, R)
    dev = state.t.device
    if state.t.dim() == 0:
        keys = prng.split(state.key, R)
        state = broadcast_state(state, R)
    else:
        if int(state.t.shape[0]) != R:
            raise ConfigError(
                f"batched state has {state.t.shape[0]} replicas, "
                f"scenarios have {R}")
        keys = prng.fold_in(state.key, 1)
        state = type(state)(*(v.clone() for v in state))
    state = state._replace(key=keys)
    if workloads is not None:
        if statics.cpu_trace.dim() != 3:
            raise ConfigError(
                "workloads= needs a banked Statics trace ((W, J, Q) "
                "cpu_trace, e.g. from data.stack_workloads); this statics "
                "carries a single unbatched workload")
        ids_host = np.asarray(workloads, np.int32)   # host data: check here
        if ids_host.shape != (R,):
            raise ConfigError(
                f"workloads has shape {ids_host.shape}, expected ({R},) — "
                "one bank id per replica")
        W = statics.cpu_trace.shape[0]
        lo, hi = int(ids_host.min()), int(ids_host.max())
        if lo < 0 or hi >= W:
            raise ConfigError(
                f"workload ids must be in [0, {W}) for this bank; got "
                f"[{lo}, {hi}] — an out-of-range id would silently clamp "
                "to the edge slice")
        state = state._replace(
            workload=to_device(torch.from_numpy(ids_host), dev))
    fleet_statics = statics._replace(scenario=tree_to(scenarios, dev))
    return fleet_statics, state, scheduler if policies is None else policies


def fleet_summary(
    final_states: SimState,
    telemetry: TelemetrySummary | None = None,
) -> List[Dict[str, float]]:
    """Per-replica ``summary`` dicts from batched final states. Pass the
    per-replica ``TelemetrySummary`` (``summary_only=True`` output) to also
    surface the per-replica telemetry columns. All reductions run
    vectorized over the replica axis in ``sim.summary_columns`` (one
    device->host transfer per field, numpy column math)."""
    cols = summary_columns(final_states, telemetry)
    R = int(np.shape(cols["t_end_s"])[0])
    return [{k: float(v[i]) for k, v in cols.items()} for i in range(R)]
