"""The port's per-step engine held to the JAX package's per-step engine
(``TieredMemSimulator(engine="per_step", debug=True)``) on the cases of
``test_torch_engine.py``: every field of the final state (integers and
flags exact, f32 to ``rtol=1e-5``) and every timeline key (counts exact,
cycles to ``rtol=1e-5``), dtypes and shapes included.  Resuming a run from
a final state is held the same way."""
import numpy as np
import pytest

import repro.core as jc

from test_torch_engine import (CASE_NAMES, case, port_run, port_sim,
                               to_port, tsim_fields,
                               unique_commits)  # noqa: F401
from test_torch_engine import fresh_jax_caches  # noqa: F401 (autouse)


def assert_same_run(jax_res, port_res, label):
    want = dict(tsim_fields(jax_res.final_state))
    got = dict(tsim_fields(port_res.final_state))
    assert want.keys() == got.keys(), label
    for k in want:
        w, g = want[k], got[k]
        assert (w.dtype, w.shape) == (g.dtype, g.shape), f"{label}: {k}"
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0,
                                       err_msg=f"{label}: {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{label}: {k}")
    assert jax_res.timeline.keys() == port_res.timeline.keys()
    for k, w in jax_res.timeline.items():
        g = port_res.timeline[k]
        assert (w.dtype, w.shape) == (g.dtype, g.shape), f"{label}: tl/{k}"
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0,
                                       err_msg=f"{label}: tl/{k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{label}: tl/{k}")
    assert (jax_res.trace_name, jax_res.policy_label) == \
        (port_res.trace_name, port_res.policy_label)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_per_step_engine_matches_jax_per_step(name, unique_commits):
    mc, pc, trace = case(name)
    want = jc.TieredMemSimulator(mc=mc, pc=pc, engine="per_step",
                                 debug=True).run(trace)
    assert_same_run(want, port_run(name), name)


@pytest.mark.parametrize("name", ["segment free", "3-tier family 2"])
def test_resumed_run_matches_jax(name):
    """A second trace run from the first run's final state (host numpy
    arrays), as the reference resumes one."""
    mc, pc, trace = case(name)
    second = jc.Trace(va=np.roll(trace.va, 5, axis=1), is_write=trace.is_write,
                      free_seg=np.full(trace.n_steps, -1, np.int32),
                      llc=trace.llc, seg_of_map=trace.seg_of_map, name="second")
    jsim = jc.TieredMemSimulator(mc=mc, pc=pc, engine="per_step", debug=True)
    tsim = port_sim(mc, pc)
    want = jsim.run(second, state=jsim.run(trace).final_state)
    got = tsim.run(to_port(second), state=tsim.run(to_port(trace)).final_state)
    assert_same_run(want, got, f"{name}, resumed")
