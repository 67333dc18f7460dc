"""The port's queueing-inflation knee against the JAX package's: the
scalar and numpy variants are carried, so they are the same function;
``q_factor_torch`` is the twin of ``q_factor_jnp`` — bit-equal to the
numpy variant in float64, within one float32 ulp of it in float32 (the
checks of tests/test_queueing.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.scenario import queueing as ref_q
from repro_torch.scenario import queueing as port_q
from repro_torch.scenario.queueing import (NEVER_S, Q_CLIFF, Q_KNEE,
                                           q_factor, q_factor_np,
                                           q_factor_torch)

torch.set_num_threads(2)

EDGES = [Q_KNEE, Q_CLIFF, 0.9499999, 0.9500001, 0.7000001, 0.6999999]


def _torch(u):
    return q_factor_torch(torch.from_numpy(u)).numpy()


def test_constants_and_scalar_equal_the_reference():
    assert (port_q.NEVER_S, port_q.Q_KNEE, port_q.Q_CLIFF) == (
        ref_q.NEVER_S, ref_q.Q_KNEE, ref_q.Q_CLIFF)
    assert q_factor(0.0) == 1.0 and q_factor(Q_KNEE) == 1.0
    assert q_factor(Q_CLIFF) == NEVER_S and q_factor(2.0) == NEVER_S
    for u in np.linspace(0.0, 1.2, 241).tolist() + EDGES:
        assert q_factor(u) == ref_q.q_factor(u)


def test_numpy_equals_the_reference():
    u = np.concatenate([np.linspace(0.0, 1.2, 241), EDGES])
    assert np.array_equal(q_factor_np(u), ref_q.q_factor_np(u))
    assert np.array_equal(q_factor(u), q_factor_np(u))


def test_torch_float64_bit_equal_numpy():
    u = np.concatenate([np.linspace(0.0, 1.2, 241), EDGES])
    t = _torch(u)
    assert t.dtype == np.float64
    assert np.array_equal(t, q_factor_np(u))


def test_torch_float32_within_one_ulp_and_flat_equal_jnp():
    """float32, as the fluid engine runs it: within 1 ulp of the numpy
    variant, and bit-equal to it and to q_factor_jnp where the curve is
    flat."""
    u = np.linspace(0.0, 1.2, 121, dtype=np.float32)
    t = _torch(u)
    vec = q_factor_np(u).astype(np.float32)
    j = np.asarray(ref_q.q_factor_jnp(jnp.asarray(u)))
    assert t.dtype == np.float32
    flat = (u <= Q_KNEE) | (u >= Q_CLIFF)
    assert (t[flat] == vec[flat]).all() and (t[flat] == j[flat]).all()
    ulp = np.spacing(np.maximum(np.abs(t), np.abs(vec)))
    assert (np.abs(t - vec) <= ulp).all()
    assert (np.abs(t - j) <= np.spacing(np.maximum(np.abs(t),
                                                   np.abs(j)))).all()


@pytest.mark.parametrize("seed", range(5))
def test_property_torch_agrees(seed):
    """Random inputs: the torch twin bit-equal to numpy in float64 and to
    the scalar variant; within 1 float32 ulp at float32."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.0, 1.5, size=64)
    scal = np.array([q_factor(float(x)) for x in u])
    assert np.array_equal(_torch(u), scal)
    u32 = u.astype(np.float32)
    t = _torch(u32)
    vec32 = q_factor_np(u32).astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(t), np.abs(vec32)))
    assert (np.abs(t - vec32) <= ulp).all()


def test_torch_keeps_dtype_and_device_and_guards_the_cliff():
    """Inputs at and past the cliff give NEVER_S, not inf or NaN from the
    mid branch that torch.where also evaluates."""
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        u = torch.tensor([0.0, 0.8, 0.95, 1.5], dtype=dt)
        out = q_factor_torch(u)
        assert out.dtype == dt and out.device == u.device
        assert bool(torch.isfinite(out).all())
        assert out[0] == 1.0 and out[2] == out[3] == torch.tensor(NEVER_S,
                                                                  dtype=dt)
    u = torch.tensor([Q_CLIFF, 1.0], dtype=torch.float64, requires_grad=True)
    q_factor_torch(u).sum().backward()
    assert bool(torch.isfinite(u.grad).all())


def test_screen_reexports_the_shared_helper():
    from repro_torch.scenario import screen
    assert screen.q_factor is q_factor
    assert screen._q_factor is q_factor_np
    assert screen.NEVER_S == NEVER_S
