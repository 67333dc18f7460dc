"""The port's checkpointing: the counterparts of tests/test_checkpoint.py
(roundtrip, retention, shape mismatch, restart-resume equivalence) on
tensors and on the port's own train state, the async write, and the
counterpart of tests/test_system.py's training through failures. The
JAX package's elastic restore across meshes waits for the port's mesh."""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointManager, FailureInjector,
                                    latest_step, restore_checkpoint,
                                    run_with_restarts, save_checkpoint)
from repro_torch.checkpoint.ckpt import _flatten, all_steps
from repro_torch.configs import get_arch
from repro_torch.launch.train import train_loop
from repro_torch.models import model as M
from repro_torch.train import init_train_state


def _state():
    return {"w": torch.arange(12.0).reshape(3, 4),
            "opt": {"mu": torch.ones((3, 4)), "count": 7},
            "blocks": (torch.zeros((2, 3)),),
            "half": torch.full((2,), 1.5, dtype=torch.bfloat16)}


def test_roundtrip(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 5, _state())
    template = {k: v for k, v in _state().items()}
    template["w"] = torch.zeros(3, 4)
    template["opt"] = {"mu": torch.zeros(3, 4), "count": 0}
    restored, step = restore_checkpoint(d, template)
    assert step == 5
    want = _state()
    assert torch.equal(restored["w"], want["w"])
    assert torch.equal(restored["opt"]["mu"], want["opt"]["mu"])
    assert restored["opt"]["count"] == 7
    assert torch.equal(restored["blocks"][0], want["blocks"][0])
    assert restored["half"].dtype == torch.bfloat16
    assert torch.equal(restored["half"], want["half"])


def test_keys_are_tree_paths():
    """The reference's keystr form: ['key'], [i], .field, .<state-dict
    key> for a module."""
    model = M.init_params(get_arch("smollm-135m").reduced(),
                          torch.Generator().manual_seed(0))
    flat = _flatten(init_train_state(model))
    assert ".params.blocks.0.attn.wq" in flat
    assert ".opt.mu['blocks.0.attn.wq']" in flat
    assert ".opt.count" in flat and ".step" in flat
    assert set(_flatten(_state())) == {"['w']", "['opt']['mu']",
                                       "['opt']['count']", "['blocks'][0]",
                                       "['half']"}


def test_retention_and_latest(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, save_every=1, keep=2, async_write=False)
    for s in range(1, 6):
        mgr.maybe_save(s, _state())
    assert latest_step(d) == 5
    assert all_steps(d) == [4, 5]


def test_shape_mismatch_rejected(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        restore_checkpoint(d, {"w": torch.zeros((3, 3))})
    with pytest.raises(KeyError):
        restore_checkpoint(d, {"v": torch.zeros((2, 2))})


def test_async_write_copies_at_save_time(tmp_path):
    """With an async manager the device→host copy is taken at save time:
    an in-place update right after maybe_save does not reach the file."""
    d = str(tmp_path)
    mgr = CheckpointManager(d, save_every=1, async_write=True)
    w = torch.zeros(1000)
    mgr.maybe_save(1, {"w": w})
    w += 1.0                                  # the next step, in place
    mgr.finalize()
    restored, step = restore_checkpoint(d, {"w": torch.empty(1000)})
    assert step == 1 and torch.equal(restored["w"], torch.zeros(1000))
    assert mgr._executor is None and mgr._pending is None


def test_restart_resume_equivalence(tmp_path):
    """Training through injected failures must land on exactly the same
    state as an uninterrupted run (step-keyed data + checkpoints)."""
    def one_step(state, step):
        return {"w": state["w"] + (step + 1)}, {"w0": float(state["w"])}

    init = {"w": torch.tensor(0.0)}
    mgr_a = CheckpointManager(str(tmp_path / "a"), save_every=3,
                              async_write=False)
    sa, _, ra = run_with_restarts(
        init_state=init, train_one_step=one_step, ckpt_manager=mgr_a,
        n_steps=10, injector=FailureInjector(fail_steps=[4, 8]))
    mgr_b = CheckpointManager(str(tmp_path / "b"), save_every=3,
                              async_write=False)
    sb, _, rb = run_with_restarts(
        init_state={"w": torch.tensor(0.0)}, train_one_step=one_step,
        ckpt_manager=mgr_b, n_steps=10, injector=FailureInjector())
    assert ra == 2 and rb == 0
    assert float(sa["w"]) == float(sb["w"]) == sum(range(1, 11))


def test_train_state_roundtrip(tmp_path):
    """The port's TrainState (model, AdamW moments, counters) saves and
    restores into a fresh state of the same config."""
    cfg = get_arch("mamba2-1.3b").reduced()
    a = init_train_state(M.init_params(cfg, torch.Generator().manual_seed(1)))
    for t in a.opt.mu.values():
        t.normal_()
    a.opt.count, a.step = 3, 3
    save_checkpoint(str(tmp_path), 3, a)
    b = init_train_state(M.init_params(cfg, torch.Generator().manual_seed(2)))
    b, step = restore_checkpoint(str(tmp_path), b)
    assert step == 3 and b.step == 3 and b.opt.count == 3
    for (k, p), (k2, q) in zip(a.params.named_parameters(),
                               b.params.named_parameters()):
        assert k == k2 and torch.equal(p, q)
    for k in a.opt.mu:
        assert torch.equal(a.opt.mu[k], b.opt.mu[k])


def test_training_with_restarts_matches_uninterrupted(tmp_path):
    """The counterpart of tests/test_system.py's: the port's own train
    step through injected failures ends on the uninterrupted run's
    parameters (restarts replay the same step-keyed batches)."""
    common = dict(steps=30, batch=4, seq=32, save_every=10, seed=7,
                  log_every=10**9, device="cpu")
    s1, l1 = train_loop("qwen3-1.7b", ckpt_dir=str(tmp_path / "a"),
                        p_fail=0.0, **common)
    s2, l2 = train_loop("qwen3-1.7b", ckpt_dir=str(tmp_path / "b"),
                        p_fail=0.08, **common)
    assert FailureInjector(p_fail=0.08, seed=7).fail_times(30)
    for (k, a), (_, b) in zip(s1.params.named_parameters(),
                              s2.params.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5, err_msg=k)
