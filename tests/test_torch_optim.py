"""The port's optimizer (schedule, clipping, AdamW) against the JAX
package's, on the CPU: the same seeded numpy inputs through both, float32
within rtol 1e-6 (the libraries' pow and division may round an ulp
apart), plus the counterparts of tests/test_runtime.py's optimizer
tests."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R
from repro_torch import optim as P

RTOL = 1e-6


def _tree(seed, shapes=((3, 4), (7,), (2, 3, 5))):
    rng = np.random.default_rng(seed)
    return {f"w{i}": rng.standard_normal(s).astype(np.float32)
            for i, s in enumerate(shapes)}


@pytest.mark.parametrize("step", [0, 5, 9, 10, 11, 50, 99, 100, 150])
def test_schedules_match_jax(step):
    for args in ((10, 100, 3e-4), (1, 1000, 1.0), (0, 10, 0.5)):
        got = float(P.cosine_schedule(step, *args))
        want = float(R.cosine_schedule(step, *args))
        assert got == pytest.approx(want, rel=RTOL, abs=0)
    assert float(P.linear_warmup(step, 20, 1e-3)) == pytest.approx(
        float(R.linear_warmup(step, 20, 1e-3)), rel=RTOL, abs=0)


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 100.0])
def test_clipping_matches_jax(max_norm):
    g = _tree(1)
    got, norm = P.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
    want, wnorm = R.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    assert float(norm) == pytest.approx(float(wnorm), rel=RTOL)
    assert float(P.global_norm(torch.from_numpy(v) for v in g.values())) \
        == pytest.approx(float(R.global_norm(g)), rel=RTOL)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=0)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_steps_match_jax(weight_decay, moments):
    """Five AdamW steps from the same parameters and gradients: the
    parameters and moments of each step."""
    p0 = _tree(2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jo = R.adamw_init(jp, moment_dtype=getattr(jnp, moments))
    to = P.adamw_init(tp, moment_dtype=getattr(torch, moments))
    for i in range(5):
        g = _tree(10 + i)
        lr = 1e-2 * (i + 1)
        jp, jo = R.adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                jo, jp, lr=jnp.float32(lr),
                                weight_decay=weight_decay)
        to = P.adamw_update({k: torch.from_numpy(v) for k, v in g.items()},
                            to, tp, lr=lr, weight_decay=weight_decay)
        assert to.count == int(jo.count) == i + 1
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=RTOL, atol=1e-7)
            for a, b in ((to.mu[k], jo.mu[k]), (to.nu[k], jo.nu[k])):
                assert a.dtype == getattr(torch, moments)
                np.testing.assert_allclose(
                    a.float().numpy(), np.asarray(b, np.float32),
                    rtol=RTOL if moments == "float32" else 1e-2, atol=1e-12)


def test_adamw_converges_quadratic():
    params = {"x": torch.tensor([5.0, -3.0])}
    opt = P.adamw_init(params)
    for _ in range(300):
        g = {"x": 2 * params["x"]}  # d/dx x^2
        opt = P.adamw_update(g, opt, params, lr=0.05, weight_decay=0.0)
    assert float(params["x"].abs().max()) < 0.05


def test_schedule_shapes():
    lr0 = float(P.cosine_schedule(0, 10, 100, 1.0))
    lr_peak = float(P.cosine_schedule(10, 10, 100, 1.0))
    lr_end = float(P.cosine_schedule(100, 10, 100, 1.0))
    assert lr0 < lr_peak and abs(lr_peak - 1.0) < 1e-6
    assert abs(lr_end - 0.1) < 1e-2


def test_adamw_bf16_moments_track_fp32():
    """bf16 moments stay close to fp32 moments."""
    p32 = {"x": torch.tensor([5.0, -3.0, 0.7])}
    p16 = {"x": torch.tensor([5.0, -3.0, 0.7])}
    o32 = P.adamw_init(p32)
    o16 = P.adamw_init(p16, moment_dtype=torch.bfloat16)
    assert o16.mu["x"].dtype == torch.bfloat16
    for _ in range(300):
        o32 = P.adamw_update({"x": 2 * p32["x"]}, o32, p32, lr=0.05,
                             weight_decay=0.0)
        o16 = P.adamw_update({"x": 2 * p16["x"]}, o16, p16, lr=0.05,
                             weight_decay=0.0)
    assert float(p32["x"].abs().max()) < 0.05
    assert float(p16["x"].abs().max()) < 0.3


def _ulps(a: float, b: float) -> float:
    """|a - b| in float32 ulps of b."""
    return abs(a - b) / float(np.spacing(np.float32(abs(b)) or
                                         np.float32(1e-38)))


@pytest.mark.parametrize("args", [(100, 10000, 3e-4), (10, 100, 3e-4),
                                  (1, 1000, 1.0), (0, 10, 0.5)])
def test_device_counter_rate_equals_the_host_schedule(args):
    """The train step's rate from its int64 step counter (a 0-d tensor
    on the device, here the CPU) equals ``cosine_schedule`` of the host
    int within one float32 ulp, steps 0 to 150."""
    ctr = torch.zeros(2, dtype=torch.int64)
    for step in range(151):
        got = float(P.cosine_schedule(ctr[0], *args))
        want = float(P.cosine_schedule(step, *args))
        assert _ulps(got, want) <= 1, (step, got, want)
        ctr.add_(1)


@pytest.mark.parametrize("b1,b2", [(0.9, 0.95), (0.9, 0.999)])
def test_device_counter_bias_corrections_equal_one_less_b_to_the_t(b1, b2):
    """AdamW's bias corrections from the counter ``count + 1`` as a 0-d
    int64 tensor equal 1 - b^t computed from the host count in float32
    within one ulp, counts 1 to 151; 0-d float32 tensors."""
    ctr = torch.zeros(2, dtype=torch.int64)
    for t in range(1, 152):
        got = P.bias_corrections(ctr[1] + 1, b1, b2)
        assert all(g.dtype == torch.float32 and g.dim() == 0 for g in got)
        for g, b in zip(got, (b1, b2)):
            want = float(np.float32(1) - np.float32(b) ** np.float32(t))
            assert _ulps(float(g), want) <= 1, (t, float(g), want)
        ctr.add_(1)
