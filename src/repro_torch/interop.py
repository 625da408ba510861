"""Carry a ``Statics`` / ``SimState`` / ``Policy`` or an LM's parameters
of the JAX package across to the port.

Each function takes the reference's structure as a name -> numpy array
mapping (or a NamedTuple of numpy arrays, such as ``jax.device_get`` of
one) and builds the port's tensors on ``device``. Nothing here imports
JAX: the caller turns the reference's typed PRNG key into its raw words
(``jax.random.key_data``) first. Fields the port's slice does not carry
(the scenario's outage, traffic and burst schedules) are dropped. Every
array may carry a fleet's leading replica axis, and the trace bank its
workload axis (W, J, Q), as the reference's do.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.placement import Policy
from repro_torch.core.state import SimState, Statics, rack_csr
from repro_torch.scenarios.events import CapSchedule
from repro_torch.scenarios.scenario import Scenario
from repro_torch.scenarios.signals import Signal
from repro_torch.utils.device import resolve_device


def _fields(x: Any) -> Mapping[str, Any]:
    return x._asdict() if hasattr(x, "_asdict") else x


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype in (np.uint32, np.uint64):
        a = a.astype(np.int64)
    return torch.tensor(np.array(a, order="C"), device=device)


def _build(cls, arrays: Any, device: torch.device):
    m = _fields(arrays)
    return cls(**{f: _tensor(m[f], device) for f in cls._fields})


def scenario_from_numpy(arrays: Any, device=None) -> Scenario:
    dev = resolve_device(device)
    m = _fields(arrays)
    return Scenario(
        carbon=_build(Signal, m["carbon"], dev),
        price=_build(Signal, m["price"], dev),
        wetbulb=_build(Signal, m["wetbulb"], dev),
        power_cap=_build(CapSchedule, m["power_cap"], dev),
    )


def statics_from_numpy(arrays: Any, device=None) -> Statics:
    """The reference's ``Statics`` as the port's, on ``device``; the racks'
    CSR, which the reference does not keep, is made from its rack ids."""
    dev = resolve_device(device)
    m = dict(_fields(arrays))
    m["rack_ptr"], m["rack_nodes"] = rack_csr(
        np.asarray(m["node_rack"]), np.shape(m["rack_r_th"])[0])
    return Statics(**{
        f: (scenario_from_numpy(m[f], dev) if f == "scenario"
            else _tensor(m[f], dev))
        for f in Statics._fields})


def state_from_numpy(arrays: Any, device=None) -> SimState:
    """The reference's ``SimState`` as the port's, on ``device``. ``key``
    must already be raw key words (uint32 words become int64)."""
    return _build(SimState, arrays, resolve_device(device))


def policy_from_numpy(arrays: Any) -> Policy:
    """The reference's ``Policy`` (0-d or (E,) ids) as the port's: int32
    tensors on the host, where ``make_step`` reads them."""
    m = _fields(arrays)
    return Policy(*(torch.tensor(np.asarray(m[f], np.int32))
                    for f in Policy._fields))


def lm_params_from_numpy(tree: Mapping[str, Any], cfg, device=None):
    """An LM's parameter tree in the JAX package's layout (``jax.device_get``
    of its ``init_params``, or ``models.seeded_numpy_params``) as the port's
    ``DecoderLM`` on ``device``, in ``cfg.dtype``. On the CPU the model
    shares the memory of writable f32 arrays (no copy of the weights)."""
    from repro_torch.models.model import DecoderLM

    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a, dtype=np.float32)
        if not (a.flags.writeable and a.flags.c_contiguous):
            a = np.array(a, order="C")
        return torch.from_numpy(a).to(dev)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return leaf(node)

    return DecoderLM.from_tree(cfg, walk(tree))
