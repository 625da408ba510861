"""Shared helpers of the ``test_torch_*`` parity tests: the same seeded
numpy inputs go through the JAX package (the reference) and the PyTorch
port, and the results are compared field by field, by name.

Tolerances: integer fields must match exactly; float fields agree to
``rtol=1e-5``, because the two frameworks sum in different orders (the
tolerance ``test_perf_path.py`` holds between the reference's own two
power paths).
"""

from __future__ import annotations

import jax
import numpy as np
import torch

RTOL = 1e-5

# the port's CPU ops are tiny: one intra-op thread per test worker keeps
# the parallel workers from oversubscribing the cores
torch.set_num_threads(1)


def to_numpy(x):
    """Port tensor / NamedTuple of tensors -> numpy (None stays None)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if x is None or isinstance(x, np.ndarray):
        return x
    return type(x)(*(to_numpy(v) for v in x))


def ref_numpy(x):
    """Reference pytree -> numpy, with a typed PRNG ``key`` as raw words."""
    if hasattr(x, "key") and hasattr(x, "_replace"):
        x = x._replace(key=jax.random.key_data(x.key))
    return jax.device_get(x)


def assert_close(ref, got, tag: str) -> None:
    """One field: exact for integers and bools, ``RTOL`` for floats."""
    a = np.asarray(ref)
    b = np.asarray(got)
    assert a.shape == b.shape, f"{tag}: shape {a.shape} vs {b.shape}"
    if a.dtype.kind in "iub":
        assert b.dtype.kind in "iub", f"{tag}: dtype {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                      err_msg=tag)
    else:
        assert b.dtype == np.float32 or a.dtype != np.float32, (
            f"{tag}: dtype {a.dtype} vs {b.dtype}")
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=0.0, err_msg=tag)


def assert_tree_close(ref, got, tag: str, skip=()) -> None:
    """Every field of two NamedTuples (nested ones field by field); a
    ``None`` on one side must be ``None`` on the other."""
    ref = ref_numpy(ref)
    got = to_numpy(got)
    for f in got._fields:
        if f in skip:
            continue
        r, g = getattr(ref, f), getattr(got, f)
        if g is None or r is None:
            assert g is None and r is None, f"{tag}.{f}: None mismatch"
        elif hasattr(g, "_fields"):
            assert_tree_close(r, g, f"{tag}.{f}")
        else:
            assert_close(r, g, f"{tag}.{f}")


def assert_state_close(ref, got, tag: str) -> None:
    """Every ``SimState`` field, with ``work_left`` held as the work done
    (``dur_est - work_left``) to ``RTOL``. With the thermal throttle on,
    progress is a float that carries the last-bit differences of the two
    packages' rack-heat sums; for a finished job ``work_left`` is the
    small overshoot past zero, where a relative tolerance means nothing
    (the reference holds its own kernel tail at ``atol=1e-5`` for the same
    reason)."""
    assert_tree_close(ref, got, tag, skip=("work_left",))
    r = ref_numpy(ref)
    np.testing.assert_allclose(
        to_numpy(got.dur_est) - to_numpy(got.work_left),
        np.asarray(r.dur_est) - np.asarray(r.work_left), rtol=RTOL,
        atol=0.0, err_msg=f"{tag}.work done")


def assert_summary_close(ref: dict, got: dict, tag: str) -> None:
    assert set(ref) == set(got), f"{tag}: keys differ"
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=0.0,
                                   err_msg=f"{tag}:{k}")


def assert_pins(got: dict, case: str, tag: str) -> None:
    """A summary against ``configs.acceptance.PINNED[case]``: the
    completion count exactly, the rest to the cases' ``RTOL``."""
    from repro_torch.configs import acceptance

    pins = acceptance.PINNED[case]
    assert got["completed"] == pins["completed"], tag
    for k, v in pins.items():
        np.testing.assert_allclose(got[k], v, rtol=acceptance.RTOL,
                                   err_msg=f"{tag}:{k}")


def make_pair(ref_cfg, port_cfg, n_jobs: int, horizon: float, seed: int,
              **synth_kw):
    """Seeded workload through both packages' build_statics -> init_state
    -> load_jobs. Returns (ref_statics, ref_state, port_statics,
    port_state, jobs, bank)."""
    import repro.core as R
    import repro_torch.core as C
    from repro.data import synth_workload

    jobs, bank = synth_workload(ref_cfg, n_jobs, horizon, seed=seed,
                                **synth_kw)
    rst = R.build_statics(ref_cfg, bank)
    rs = R.load_jobs(R.init_state(ref_cfg, rst, jax.random.key(seed)), jobs)
    pst = C.build_statics(port_cfg, bank, device="cpu")
    ps = C.load_jobs(C.init_state(port_cfg, pst, seed), jobs)
    return rst, rs, pst, ps, jobs, bank
