"""DIAL-MPC planner (MBDPI): diffusion-style annealed sampling MPC.

Counterpart of `tpu_dialmpc/planner/dial.py`, in PyTorch:

- node <-> dense spline transforms and the receding-horizon shift are fixed
  matrices (core/spline.py) applied as einsums;
- the candidate noise is drawn from an explicit `torch.Generator` (the JAX
  package splits `jax.random` keys); `reverse_once(..., noise=)` takes
  injected noise, which is how the tests hold the port against the JAX
  package on the same draws;
- rollouts go through the env's `rollout_batch` (one substep-kernel launch per
  horizon step for all Nsample+1 candidates); an env without one is stepped
  with its `step` over the batch-broadcast state, horizon step by horizon
  step, as the JAX package's vmap(scan(env.step)) fallback does;
- `reverse` and `improve` are Python loops over `reverse_once`;
- `diag_states` (quirk Q4) adds the softmax-weighted rollout states
  qbar/qdbar/xbar to each iteration's info, from the same weights as the
  control update, which it leaves unchanged;
- `compat_q1` (reference quirk Q1) chains the candidates' physics: each
  starts where the one before ended, one `env.step` at a time.  A parity
  fixture, sequential over candidates by design, not for production.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpu_dialmpc_torch.core import spline
from tpu_dialmpc_torch.envs.base import map_tensors, to_lean


@dataclasses.dataclass(frozen=True)
class DialConfig:
    """Planner hyperparameters, as in the JAX package (dial-core.h:35-49)."""

    seed: int = 0
    Hsample: int = 16
    Hnode: int = 4
    Nsample: int = 20
    Ndiffuse: int = 2
    Ndiffuse_init: int = 10
    temp_sample: float = 0.05
    horizon_diffuse_factor: float = 0.5
    ctrl_dt: float = 0.02
    n_steps: int = 400
    traj_diffuse_factor: float = 0.5
    update_method: str = "mppi"
    spline_mode: str = "ref"  # "ref" replicates the C++ spline quirks
    # "sample" (default): scalar std of the mean rewards across samples, the
    # upstream semantics; "time": per-sample std across time, the C++ (Q9)
    score_std: str = "sample"
    # Q1 compat: candidate i starts from candidate i-1's final physics state
    # (the C++'s shared mjData); a sequential parity fixture
    compat_q1: bool = False
    # Q4: softmax-weighted rollout qpos/qvel/torso position in ReverseInfo
    # (the C++ ships (1,1) zero placeholders, which False keeps)
    diag_states: bool = False


class ReverseInfo(NamedTuple):
    """Per-iteration diagnostics (see the JAX package's ReverseInfo)."""

    rews: torch.Tensor  # (Nsample+1,) per-candidate mean rewards
    rew_Ybar: torch.Tensor  # scalar: mean reward of the anchor trajectory
    weights: torch.Tensor  # (Nsample+1,) softmax weights
    ess: torch.Tensor  # effective sample size 1/Σw²
    entropy: torch.Tensor  # softmax weight entropy
    new_noise_scale: torch.Tensor  # (Hnode+1,) — unchanged (quirk Q5)
    # Q4 weighted state averages; (1, 1) zeros (the C++ placeholders) unless
    # DialConfig.diag_states
    qbar: torch.Tensor  # (Hsample+1, nq) softmax-weighted rollout qpos
    qdbar: torch.Tensor  # (Hsample+1, nv) softmax-weighted rollout qvel
    xbar: torch.Tensor  # (Hsample+1, 3) softmax-weighted torso position


def _stack_infos(infos):
    return ReverseInfo(*(torch.stack(list(f)) for f in zip(*infos)))


class MBDPI:
    """Model-Based Diffusion Planner on the env's device."""

    def __init__(self, args: DialConfig, env):
        self.args = args
        self.env = env
        self.nu = env.action_size
        self.device = torch.device(env.device)
        self.block = slice(0, args.Nsample)  # the samples this planner scores

        # sigma schedule (dial-core.h:388-395)
        sigma0, sigma1 = 1e-2, 1.0
        B = np.log(sigma1 / sigma0) / args.Ndiffuse
        self.sigmas = sigma0 * np.exp(B * np.arange(args.Ndiffuse))
        # per-node noise schedule (dial-core.h:397-404)
        self.sigma_control = args.horizon_diffuse_factor ** np.arange(args.Hnode, -1, -1)
        mode = args.spline_mode

        def mat(a):
            return torch.as_tensor(a, dtype=torch.float64, device=self.device)

        self._node2u = mat(spline.node2u_matrix(args.Hnode, args.Hsample, args.ctrl_dt, mode))
        self._u2node = mat(spline.u2node_matrix(args.Hnode, args.Hsample, args.ctrl_dt, mode))
        self._shift = mat(spline.shift_matrix(args.Hnode, args.Hsample, args.ctrl_dt, mode))

    # ------------------------------------------------------------------
    def node2u(self, nodes: torch.Tensor) -> torch.Tensor:
        """(..., Hnode+1, nu) -> (..., Hsample+1, nu) dense controls."""
        return torch.einsum("qn,...nu->...qu", self._node2u.to(nodes.dtype), nodes)

    def u2node(self, us: torch.Tensor) -> torch.Tensor:
        return torch.einsum("qn,...nu->...qu", self._u2node.to(us.dtype), us)

    def shift(self, Y: torch.Tensor) -> torch.Tensor:
        """Receding-horizon shift as one precomposed linear map."""
        return torch.einsum("qn,...nu->...qu", self._shift.to(Y.dtype), Y)

    # ------------------------------------------------------------------
    def _lean(self, state):
        """The live part of a physics env's state (qpos, qvel, warmstart,
        info): `env.step` reads nothing else.  A state with no `pipeline` is
        live as a whole."""
        return to_lean(state) if hasattr(state, "pipeline") else state

    def _step_rollouts(self, state, all_us, want_states=False):
        """`env.step` over the batch-broadcast state, horizon step by horizon
        step: rewards (B, T), and with `want_states` also the states (qss,
        qdss, xss), xss the torso's world position (qpos[:3] where the env
        names no torso)."""
        B = all_us.shape[0]
        s = map_tensors(self._lean(state), lambda x: x.expand((B,) + tuple(x.shape)))
        torso = getattr(self.env, "_torso_idx", None)
        outs = []
        for t in range(all_us.shape[1]):
            s = self.env.step(s, all_us[:, t])
            if want_states:
                ps = s.pipeline
                x = ps.xpos[:, torso] if torso is not None else ps.qpos[:, :3]
                outs.append((s.reward, ps.qpos, ps.qvel, x))
            else:
                outs.append((s.reward,))
            s = self._lean(s)
        stacked = tuple(torch.stack(x, dim=1) for x in zip(*outs))
        return stacked if want_states else stacked[0]

    def rollout_us_batch(self, state, all_us: torch.Tensor) -> torch.Tensor:
        """(B, Hsample+1, nu) -> rewards (B, Hsample+1); every rollout starts
        from `state`: the env's `rollout_batch`, else `env.step`."""
        if hasattr(self.env, "rollout_batch"):
            return self.env.rollout_batch(state, all_us)
        return self._step_rollouts(state, all_us)

    def rollout_us_batch_diag(self, state, all_us: torch.Tensor):
        """Rollouts that also return their states (Q4 diagnostics):
        (rewss (B,T), qss (B,T,nq), qdss (B,T,nv), xss (B,T,3))."""
        if hasattr(self.env, "rollout_batch"):
            return self.env.rollout_batch(state, all_us, want_states=True)
        return self._step_rollouts(state, all_us, want_states=True)

    def rollout_us_batch_compat_q1(self, state, all_us: torch.Tensor):
        """Reference-quirk-Q1 rollouts: the candidates chained one after
        another through `env.step`.  The physics (qpos, qvel, warmstart)
        carries over from candidate to candidate, as the C++'s shared mjData
        does; StateInfo restarts from `state`'s for each candidate.  Returns
        (rewss (B, T), the final physics (qpos, qvel, warmstart)); the C++
        executes its next control from that state."""
        lean = self._lean(state)
        phys = lean.pipeline
        rewss = []
        for us in all_us:
            s = dataclasses.replace(lean, pipeline=phys)
            rews = []
            for u in us:
                s = self.env.step(s, u)
                rews.append(s.reward)
            rewss.append(torch.stack(rews))
            phys = to_lean(s).pipeline
        return torch.stack(rewss), (phys.qpos, phys.qvel, phys.qacc_warmstart)

    def draw_noise(self, generator, like: torch.Tensor) -> torch.Tensor:
        """The candidates' standard normal noise, (Nsample, Hnode+1, nu), one
        draw from `generator` in `like`'s dtype and on its device."""
        args = self.args
        return torch.randn((args.Nsample, args.Hnode + 1, self.nu),
                           generator=generator, dtype=like.dtype, device=like.device)

    def _candidates(self, generator, Ybar_i, noise_scale, noise):
        """Noisy node-trajectory candidates + appended anchor (dial-core.h:477-514)."""
        dtype = Ybar_i.dtype
        if noise is None:
            noise = self.draw_noise(generator, Ybar_i)
        eps = noise * noise_scale.to(dtype)[None, :, None]
        Y0s = Ybar_i[None] + eps
        # pin the first (currently executing) node (dial-core.h:493)
        Y0s[:, 0, :] = Ybar_i[0]
        all_Y0s = torch.cat([Y0s, Ybar_i[None]], dim=0)
        return torch.clamp(all_Y0s, -1.0, 1.0)

    def _reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A partial over this planner's block of the samples, reduced over
        every block ("sum" or "max"): the identity here, where the block is
        every sample; `ShardedMBDPI` all-reduces over its ranks."""
        return t

    @staticmethod
    def _finite_scores(rews, rew_Ybar, rews_all, mean_all):
        """Scores with every non-finite mean reward replaced by the worst
        finite one, and the mean of all of them.

        A rollout that diverges (the physics blows up under an extreme
        candidate; the JAX package's engine does the same on the same
        inputs) has a non-finite mean reward, which would make the std, and
        so every weight and the plan, non-finite.  As the worst finite score
        it keeps a weight of about exp(-gap / (std·temp)), nothing.  Every
        rank computes the same values from the global (Nsample+1,) vector
        `rews_all` (the anchor's slot not yet set); where every score is
        finite, the inputs are returned as they are, bit for bit."""
        ok, ok_y = torch.isfinite(rews_all[:-1]), torch.isfinite(rew_Ybar)
        finite = torch.where(torch.cat([ok, ok_y[None]]),
                             torch.cat([rews_all[:-1], rew_Ybar[None]]), torch.inf)
        worst = finite.min()
        worst = torch.where(torch.isfinite(worst), worst, 0.0)  # none finite: all equal
        rews_s = torch.where(torch.isfinite(rews), rews, worst)
        rew_Ybar_s = torch.where(ok_y, rew_Ybar, worst)
        rews_all_s = torch.where(torch.isfinite(rews_all), rews_all, worst)
        mean_s = (rews_all_s[:-1].sum() + rew_Ybar_s) / rews_all.shape[0]
        mean_all = torch.where(ok.all() & ok_y, mean_all, mean_s)
        return rews_s, rew_Ybar_s, rews_all_s, mean_all

    def _score_update(self, rewss, all_Y0s, noise_scale, diag=None):
        """Score, softmax, weighted average (dial-core.h:529-592).

        `rewss` and `all_Y0s` hold the candidates of `self.block` (every
        sample here, a rank's block in `ShardedMBDPI`) with the anchor last.
        Each global quantity is a `_reduce` of the block's partial; the
        anchor is added after the reduction, so it enters once whatever the
        number of blocks.  `diag` is an optional (qss, qdss, xss) of rollout
        states; when given, the Q4 averages use the same softmax weights as
        the control update."""
        args = self.args
        n_all = args.Nsample + 1
        lo, hi = self.block.start, self.block.stop
        rews_t, rews_y_t = rewss[:-1], rewss[-1]
        rews = rews_t.mean(dim=-1)  # the block's mean rewards
        rew_Ybar = rews_y_t.mean()
        dtype, device = rews.dtype, rews.device

        # the global (Nsample+1,) mean rewards, the anchor's slot last
        rews_all = torch.zeros(n_all, dtype=dtype, device=device)
        rews_all[lo:hi] = rews
        if args.score_std == "time":
            # per-sample std across time (C++ quirk Q9): no reduction
            var = torch.mean((rews_t - rews[:, None]) ** 2, dim=-1)
            std = torch.where(var > 1e-14, torch.sqrt(var), 1e-7)
            var_y = torch.mean((rews_y_t - rew_Ybar) ** 2)
            std_y = torch.where(var_y > 1e-14, torch.sqrt(var_y), 1e-7)
            self._reduce(rews_all)
        else:
            # population std of all Nsample+1 mean rewards, as jnp.std: the
            # mean, then the mean squared deviation
            head = self._reduce(torch.cat([rews.sum()[None], rews_all]))
            rews_all = head[1:]
            mean_all = (head[0] + rew_Ybar) / n_all
            rews, rew_Ybar, rews_all, mean_all = self._finite_scores(
                rews, rew_Ybar, rews_all, mean_all)
            sq = self._reduce(((rews - mean_all) ** 2).sum()[None])[0]
            var_all = (sq + (rew_Ybar - mean_all) ** 2) / n_all
            std = std_y = torch.clamp(torch.sqrt(var_all), min=1e-7)
        rews_all[-1] = rew_Ybar
        logp0 = (rews - rew_Ybar) / (std * args.temp_sample)
        logp_ybar = (rew_Ybar - rew_Ybar) / (std_y * args.temp_sample)
        # a non-finite score (a per-sample std of a diverged rollout) weighs 0
        logp0 = torch.where(torch.isfinite(logp0), logp0, -torch.inf)

        # the stable softmax: the max, then the sum of the exponentials
        m = logp0.max()[None] if hi > lo else torch.full((1,), -torch.inf, dtype=dtype,
                                                         device=device)
        m = torch.maximum(self._reduce(m, "max")[0], logp_ybar)
        e = torch.exp(logp0 - m)
        e_ybar = torch.exp(logp_ybar - m)
        denom = self._reduce(e.sum()[None])[0] + e_ybar
        w = e / denom
        w_ybar = e_ybar / denom

        # the weighted update and the diag averages: one reduction of the
        # partials and the zero-padded global weights
        w_all = torch.zeros(n_all, dtype=dtype, device=device)
        w_all[lo:hi] = w
        parts = [torch.einsum("n,nij->ij", w, all_Y0s[:-1])]
        if diag is not None:
            parts += [torch.einsum("n,ntj->tj", w, x[:-1]) for x in diag]
        flat = self._reduce(torch.cat([p.reshape(-1) for p in parts] + [w_all]))
        sums = list(torch.split(flat, [p.numel() for p in parts] + [n_all]))
        w_all = sums.pop()
        w_all[-1] = w_ybar
        Ybar, *avgs = [s.view(p.shape) for s, p in zip(sums, parts)]
        Ybar = Ybar + w_ybar * all_Y0s[-1]
        if diag is not None:
            qbar, qdbar, xbar = (a + w_ybar * x[-1] for a, x in zip(avgs, diag))
        else:
            qbar = qdbar = xbar = torch.zeros((1, 1), dtype=dtype, device=device)
        info = ReverseInfo(
            rews=rews_all,
            rew_Ybar=rew_Ybar,
            weights=w_all,
            ess=1.0 / torch.sum(w_all**2),
            entropy=-torch.sum(w_all * torch.log(w_all + 1e-30)),
            new_noise_scale=noise_scale,
            qbar=qbar,
            qdbar=qdbar,
            xbar=xbar,
        )
        return Ybar, info

    def reverse_once(
        self,
        state,
        generator: Optional[torch.Generator],
        Ybar_i: torch.Tensor,
        noise_scale: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, ReverseInfo]:
        """One annealing step (dial-core.h:469-593)."""
        all_Y0s = self._candidates(generator, Ybar_i, noise_scale, noise)
        all_us = self.node2u(all_Y0s)  # (Nsample+1, Hsample+1, nu)
        diag = None
        if self.args.compat_q1:
            rewss, _ = self.rollout_us_batch_compat_q1(state, all_us)
        elif self.args.diag_states and hasattr(state, "pipeline"):
            rewss, *diag = self.rollout_us_batch_diag(state, all_us)
        else:
            rewss = self.rollout_us_batch(state, all_us)  # (Nsample+1, Hsample+1)
        return self._score_update(rewss, all_Y0s, noise_scale, diag=diag)

    def reverse_once_compat(
        self,
        state,
        generator: Optional[torch.Generator],
        Ybar_i: torch.Tensor,
        noise_scale: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
    ):
        """The Q1-compat annealing step, which also returns the final chained
        physics (qpos, qvel, warmstart): the C++ executes its next control
        from exactly that state.  A parity fixture."""
        all_Y0s = self._candidates(generator, Ybar_i, noise_scale, noise)
        rewss, phys_final = self.rollout_us_batch_compat_q1(state, self.node2u(all_Y0s))
        Ybar, info = self._score_update(rewss, all_Y0s, noise_scale)
        return Ybar, info, phys_final

    # ------------------------------------------------------------------
    def reverse(self, state, YN: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """Warm-start chain: i = Ndiffuse-1 … 1 (dial-core.h:598-614)."""
        args = self.args
        Y = YN
        for i in range(args.Ndiffuse - 1, 0, -1):
            scale = torch.full((args.Hnode + 1,), float(self.sigmas[i]),
                               dtype=YN.dtype, device=YN.device)
            Y, _ = self.reverse_once(state, generator, Y, scale)
        return Y

    def improve(
        self, state, Y0: torch.Tensor, generator: torch.Generator, n_diffuse: int
    ) -> Tuple[torch.Tensor, ReverseInfo]:
        """n_diffuse reverse_once steps with the annealed schedule
        factor = sigma_control · traj_diffuse_factor^i (dial-core-test.cpp:84-92).
        Returns the new Y and the per-iteration infos stacked."""
        args = self.args
        Y, infos = Y0, []
        for i in range(n_diffuse):
            scale = torch.as_tensor(
                self.sigma_control * args.traj_diffuse_factor**i,
                dtype=Y0.dtype, device=Y0.device,
            )
            Y, info = self.reverse_once(state, generator, Y, scale)
            infos.append(info)
        return Y, _stack_infos(infos)
