"""The harness driven whole (but for its look for a card) with the timed
path broken underneath, at a size the CPU runs: `correct` comes out false
for each fault a cell can have.  The cells run on one chip, so there is no
exchange between chips to leave out."""

import pytest
import torch

from tpu_dialmpc_torch.dynamics.fused_cuda import FusedStep
from tpu_dialmpc_torch.planner.dial import MBDPI


def test_sound(small_run):
    assert small_run()["correct"] is True


def _unchanged_state(monkeypatch):
    """The physics returns the state it was given."""
    call = FusedStep.__call__

    def stuck(self, qpos, qvel, ws, ctrl):
        _, _, _, der = call(self, qpos, qvel, ws, ctrl)
        return qpos.clone(), qvel.clone(), ws.clone(), der

    monkeypatch.setattr(FusedStep, "__call__", stuck)


def _a_third_of_the_rollouts(monkeypatch):
    """The physics leaves the last third of a batch's rows unstepped (the
    rollouts; the executed step at B=1 is sound)."""
    call = FusedStep.__call__

    def partial(self, qpos, qvel, ws, ctrl):
        q, v, w, der = call(self, qpos, qvel, ws, ctrl)
        b = qpos.shape[0]
        if b > 1:
            lo = b - b // 3
            q, v, w = q.clone(), v.clone(), w.clone()
            q[lo:], v[lo:], w[lo:] = qpos[lo:], qvel[lo:], ws[lo:]
        return q, v, w, der

    monkeypatch.setattr(FusedStep, "__call__", partial)


def _half_the_batch(monkeypatch):
    """The weighted update over the first half of the candidates alone (and
    the anchor), its weights renormalized."""
    update = MBDPI._score_update

    def half(self, rewss, all_Y0s, noise_scale, diag=None):
        _, info = update(self, rewss, all_Y0s, noise_scale, diag)
        w = info.weights.clone()
        w[w.shape[0] // 2: -1] = 0.0
        w = w / w.sum()
        return torch.einsum("n,nij->ij", w, all_Y0s), info._replace(weights=w)

    monkeypatch.setattr(MBDPI, "_score_update", half)


def _altered_answer(monkeypatch):
    """The plan a control step returns, altered where it is made."""
    improve = MBDPI.improve

    def altered(self, *args, **kw):
        Y, infos = improve(self, *args, **kw)
        return Y + 1e-2, infos

    monkeypatch.setattr(MBDPI, "improve", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _a_third_of_the_rollouts, _half_the_batch,
                                   _altered_answer])
def test_a_broken_step_is_not_correct(fault, monkeypatch, small_run):
    fault(monkeypatch)
    res = small_run()
    assert res["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"] for c in res["checks"].values())
