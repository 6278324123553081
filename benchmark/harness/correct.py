"""How `correct` is decided: the program's outputs in the window, judged by
the plain reference (`benchmark/reference/`) in float64.

The reference cannot replay a whole window (the physics is chaotic, so
float32 and float64 trajectories part after some steps): it follows the
program step by step from the program's own state, as a served model's
reference follows the served tokens.  For each judged control step k it
takes the program's state and plan going in, and the noise drawn for the
step, and holds each stage's output against its own:

- `exec_gap`: the executed step (the kernel at B=1 and the reward stack):
  the widest gap of qpos, qvel and the reward after one env step from the
  state going in, under the plan's first action;
- `reward_gap_p50` and `reward_gap_p90` (and `reward_gap`, the widest,
  read but not compared): the rollouts (the kernel at B=Nsample+1, the PD
  map, the reward stack): each candidate's mean reward over the horizon,
  rolled out from the program's executed state, against the program's, in
  units of the reference's std of the iteration's mean rewards (the scale
  the softmax reads); a rollout that diverges scores as the worst finite
  one on both sides, as the planner scores it.  The median holds the bulk
  of the rows; the 90th percentile holds all but the tenth of them where
  float32 and float64 may part (a fallen robot's chaotic rollouts), so a
  fault in a third of the rows shows in it;
- `weight_gap`: the softmax: the widest gap of each iteration's weights
  from the program's mean rewards;
- `plan_gap`: the candidates, the weighted update and the shift: the
  widest gap of the new plan, each iteration's candidates drawn around the
  update of the program's rewards of the iteration before (the first around
  the shifted plan going in).

`start_gap` holds the reset state that the loop starts from against the
scene's home keyframe at rest.  A judged step's rollouts run in blocks of
rows.  A number that is not finite, or over its limit, makes the run not
correct.
"""

from __future__ import annotations

import math
import random

import torch

from benchmark.reference import envs as ref_envs
from benchmark.reference import model as ref_model
from benchmark.reference.planner import Planner
from benchmark.harness.cells import ROOT

NUMBERS = ("start_gap", "exec_gap", "reward_gap_p50", "reward_gap_p90", "reward_gap",
           "weight_gap", "plan_gap")


class Reference:
    """The configuration's env and planner in plain PyTorch."""

    def __init__(self, config: dict, device, dtype=torch.float64):
        scene = config["env"]["scene"]
        model = ref_model.load_model(str(ROOT / scene) if not scene.startswith("/") else scene)
        self.env = ref_envs.ROBOTS[config["robot"]](config["env"], model, device, dtype)
        self.planner = Planner(config["planner"], device, dtype)
        self.config, self.device, self.dtype = config, torch.device(device), dtype

    def put(self, x):
        x = torch.as_tensor(x).to(self.device)
        return x.to(self.dtype) if x.is_floating_point() else x


def pick_steps(seed: int, n_steps: int, k: int) -> list:
    """The judged steps of a window: k of its n_steps, drawn from the seed."""
    return sorted(random.Random(seed).sample(range(n_steps), min(k, n_steps)))


def _to(d, fn):
    if isinstance(d, dict):
        return {k: _to(v, fn) for k, v in d.items()}
    return fn(d)


def snapshot(d):
    """A detached copy of a record (dicts of tensors), kept when the
    program's state is freed."""
    return _to(d, lambda t: t.detach().clone())


def start_gap(ref: Reference, state: dict) -> float:
    """The widest gap of the program's reset state from the home keyframe
    at rest, in the program's own dtype (an exact comparison)."""
    env, dt = ref.env, state["qpos"].dtype
    want = [torch.as_tensor(env.init_q[: env.model.nq]), torch.zeros(env.model.nv),
            torch.zeros(env.model.nv), torch.as_tensor(env.pos_tar)]
    got = [state["qpos"], state["qvel"], state["ws"], state["info"]["pos_tar"]]
    return max(float((g.cpu() - w.to(dt)).abs().max()) for g, w in zip(got, want))


def _rollouts(ref: Reference, qpos, qvel, ws, info, us, rows_per_block: int):
    """Mean reward over the horizon of each row: (B,) for (B, T, nu)."""
    out = []
    for lo in range(0, us.shape[0], rows_per_block):
        sl = slice(lo, lo + rows_per_block)
        q, v, w = qpos[sl], qvel[sl], ws[sl]
        inf = {k: x[sl] for k, x in info.items()}
        total = None
        for t in range(us.shape[1]):
            q, v, w, r, _, inf = ref.env.step(q, v, w, inf, us[sl, t])
            total = r if total is None else total + r
        out.append(total / us.shape[1])
    return torch.cat(out)


def worst_for_non_finite(mean):
    """Each iteration's mean rewards (..., Nsample+1) with every value that
    is not finite replaced by the worst finite one, as the planner scores a
    rollout that diverged (the program reports its rewards so)."""
    ok = torch.isfinite(mean)
    worst = torch.where(ok, mean, torch.inf).min(-1, keepdim=True).values
    worst = torch.where(torch.isfinite(worst), worst, 0.0)
    return torch.where(ok, mean, worst)


def judge(ref: Reference, steps: list, rows_per_block: int) -> dict:
    """The numbers of `NUMBERS[1:]` over the judged steps.  Each step is a
    dict: `inp` (the state going in), `Y_in`, `noise` (Ndiffuse, Nsample,
    Hnode+1, nu) and `out` (`program.outputs`)."""
    P, put = ref.planner, ref.put
    nd = ref.config["planner"]["Ndiffuse"]

    def stack(get):
        return torch.stack([put(get(s)) for s in steps])

    # the executed step, one row per judged step
    info_in = {k: stack(lambda s, k=k: s["inp"]["info"][k]) for k in steps[0]["inp"]["info"]}
    q2, v2, _, r2, _, _ = ref.env.step(
        stack(lambda s: s["inp"]["qpos"]), stack(lambda s: s["inp"]["qvel"]),
        stack(lambda s: s["inp"]["ws"]), info_in, stack(lambda s: s["Y_in"][0]))
    exec_gap = max(
        float((q2 - stack(lambda s: s["out"]["state"]["qpos"])).abs().max()),
        float((v2 - stack(lambda s: s["out"]["state"]["qvel"])).abs().max()),
        float((r2 - stack(lambda s: s["out"]["state"]["reward"])).abs().max()))

    # each iteration's candidates, around the update of the program's
    # rewards of the iteration before; the weights and the new plan
    cands, weight_gap, plan_gap = [], 0.0, 0.0
    for s in steps:
        Y = P.shift(put(s["Y_in"]))
        rews = put(s["out"]["rews"])
        for i in range(nd):
            C = P.candidates(Y, put(s["noise"][i]), i)
            cands.append(C)
            w, Y = P.update(rews[i], C)
            weight_gap = max(weight_gap, float((w - put(s["out"]["weights"][i])).abs().max()))
        plan_gap = max(plan_gap, float((Y - put(s["out"]["Y"])).abs().max()))

    # the rollouts from each step's executed state, every iteration's
    # candidates in one batch
    n_rows = cands[0].shape[0] * nd  # rows per judged step
    def rows(get):
        return torch.cat([put(get(s)).expand((n_rows,) + tuple(put(get(s)).shape))
                          for s in steps])

    st = [s["out"]["state"] for s in steps]
    info = {k: torch.cat([put(x["info"][k]).expand((n_rows,) + tuple(x["info"][k].shape))
                          for x in st]) for k in st[0]["info"]}
    mean = _rollouts(ref, rows(lambda s: s["out"]["state"]["qpos"]),
                     rows(lambda s: s["out"]["state"]["qvel"]),
                     rows(lambda s: s["out"]["state"]["ws"]), info,
                     P.node2u(torch.cat(cands)), rows_per_block)
    mean = mean.view(len(steps), nd, -1)
    prog = stack(lambda s: s["out"]["rews"])
    mean = worst_for_non_finite(mean)
    std = torch.sqrt(torch.mean((mean - mean.mean(-1, keepdim=True)) ** 2, -1, keepdim=True))
    gap = ((mean - prog).abs() / torch.clamp(std, min=1e-12)).flatten()
    q = torch.quantile(gap.float(), torch.tensor([0.5, 0.9], device=gap.device))
    return dict(exec_gap=exec_gap, reward_gap_p50=float(q[0]), reward_gap_p90=float(q[1]),
                reward_gap=float(gap.max()),
                weight_gap=weight_gap, plan_gap=plan_gap)


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers the
    configuration compares (those in `limits`): each finite and within its
    limit; one not read, or with no limit set, fails."""
    checks, ok = {}, True
    for name in limits:
        v, lim = numbers.get(name), limits.get(name)
        checks[name] = {"value": v, "limit": lim}
        if v is None or lim is None or not math.isfinite(v) or v > lim:
            ok = False
    return ok, checks


def reference_step(ref: Reference, inp: dict, Y_in, noise) -> dict:
    """One whole control step by the reference, in its own dtype, in the
    program's place: the outputs `program.outputs` gives, for the
    comparison's control (the reference in a lower precision)."""
    P, put = ref.planner, ref.put
    one = {k: put(v)[None] for k, v in inp["info"].items()}
    q, v, w, r, _, info = ref.env.step(put(inp["qpos"])[None], put(inp["qvel"])[None],
                                        put(inp["ws"])[None], one, put(Y_in)[0][None])
    Y, rews, weights = P.shift(put(Y_in)), [], []
    for i in range(ref.config["planner"]["Ndiffuse"]):
        C = P.candidates(Y, put(noise[i]), i)
        B = C.shape[0]
        mean = _rollouts(ref, q.expand(B, -1), v.expand(B, -1), w.expand(B, -1),
                         {k: x.expand((B,) + tuple(x.shape[1:])) for k, x in info.items()},
                         P.node2u(C), B)
        wt, Y = P.update(mean, C)
        rews.append(worst_for_non_finite(mean))
        weights.append(wt)
    state = dict(qpos=q[0], qvel=v[0], ws=w[0], reward=r[0],
                 info={k: x[0] for k, x in info.items()})
    return dict(state=state, Y=Y, rews=torch.stack(rews), weights=torch.stack(weights))
