"""DIAL-MPC's planner ops in plain PyTorch: the candidates, the dense
controls, the receding-horizon shift, and the score, softmax and weighted
update of one annealing iteration (dial-core.h:469-593, as the JAX
package's `planner/dial.py` writes them).

Written for the benchmark from the published algorithm, one formula per
line, in whatever dtype the caller gives.  The spline and shift matrices
come from `spline.py`, the frozen copy beside this file.
"""

from __future__ import annotations

import numpy as np
import torch

from . import spline


class Planner:
    """The planner's constants for one configuration (`cfg` is the
    configuration file's "planner" dict) on `device` in `dtype`."""

    def __init__(self, cfg: dict, device, dtype):
        if cfg.get("score_std", "sample") != "sample" or cfg.get("update_method", "mppi") != "mppi":
            raise NotImplementedError("the reference models score_std='sample', mppi only")
        self.cfg = cfg
        H, n, dt, mode = cfg["Hsample"], cfg["Hnode"], cfg["ctrl_dt"], cfg["spline_mode"]

        def mat(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

        self.node2u_m = mat(spline.node2u_matrix(n, H, dt, mode))
        self.shift_m = mat(spline.shift_matrix(n, H, dt, mode))
        sigma_control = cfg["horizon_diffuse_factor"] ** np.arange(n, -1, -1)
        # annealing iteration i's per-node noise scale
        self.scales = [mat(sigma_control * cfg["traj_diffuse_factor"] ** i)
                       for i in range(cfg["Ndiffuse"])]

    def node2u(self, nodes):
        """(..., Hnode+1, nu) -> (..., Hsample+1, nu)."""
        return torch.einsum("qn,...nu->...qu", self.node2u_m, nodes)

    def shift(self, Y):
        return torch.einsum("qn,...nu->...qu", self.shift_m, Y)

    def candidates(self, Ybar, noise, i):
        """Iteration i's Nsample noisy node trajectories, the first node
        pinned to Ybar's, then Ybar itself, all clipped to [-1, 1]:
        (Nsample+1, Hnode+1, nu)."""
        Y0s = Ybar[None] + noise * self.scales[i][None, :, None]
        Y0s[:, 0, :] = Ybar[0]
        return torch.clamp(torch.cat([Y0s, Ybar[None]], dim=0), -1.0, 1.0)

    def weights(self, mean_rews):
        """Softmax weights of the Nsample+1 mean rewards (the anchor's last):
        scores standardized by the population std of all of them, divided by
        the temperature, relative to the anchor's.  A non-finite mean reward
        (a diverged rollout) counts as the worst finite one."""
        finite = torch.isfinite(mean_rews)
        worst = torch.where(finite, mean_rews, torch.inf).min()
        worst = torch.where(torch.isfinite(worst), worst, torch.zeros_like(worst))
        r = torch.where(finite, mean_rews, worst)
        std = torch.clamp(torch.sqrt(torch.mean((r - r.mean()) ** 2)), min=1e-7)
        logp = (r - r[-1]) / (std * self.cfg["temp_sample"])
        return torch.softmax(logp, dim=0)

    def update(self, mean_rews, cands):
        """(weights, the weighted average of the candidates)."""
        w = self.weights(mean_rews)
        return w, torch.einsum("n,nij->ij", w, cands)
