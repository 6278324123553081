"""Checkpoint / resume for the receding-horizon control loop.

Counterpart of `tpu_dialmpc/checkpoint.py`.  The planner is stateless per
solve, so a control run resumes exactly from (qpos, qvel, warmstart, Y0,
StateInfo, the noise generator's state): a few KB in one `.npz`, with the
JAX package's entry names (`meta` = JSON of the DialConfig and the step,
`qpos`, `qvel`, `qacc_warmstart`, `Y0`, `reward`, `done`, `info_<field>`).
The JAX file's PRNG keys are replaced: `key` by `generator`, the bytes of
`torch.Generator.get_state()`, and `info_rng` by `info_seed`, the
randomize_tasks command seed (a file written before the port carried it
loads with seed 0).  `meta` also names the generator's device
type (`generator_device`): a CPU generator's state and a CUDA generator's
are different things, so a checkpoint resumes only on an env whose device
has the generator's type.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import numpy as np
import torch

from tpu_dialmpc_torch.envs.base import EnvState, StateInfo
from tpu_dialmpc_torch.planner.dial import DialConfig


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save(path: str, state, Y0: torch.Tensor, generator: torch.Generator,
         dial_cfg: DialConfig, step: int):
    """Write the full control-loop state (an EnvState or LeanEnvState) to
    one .npz; `step` is the number of control steps taken."""
    ps = state.pipeline
    np.savez(
        path,
        meta=json.dumps({"dial": dataclasses.asdict(dial_cfg), "step": int(step),
                         "generator_device": generator.device.type}),
        qpos=_np(ps.qpos),
        qvel=_np(ps.qvel),
        qacc_warmstart=_np(ps.qacc_warmstart),
        Y0=_np(Y0),
        generator=_np(generator.get_state()),
        reward=_np(state.reward),
        done=_np(state.done),
        **{f"info_{f.name}": _np(getattr(state.info, f.name))
           for f in dataclasses.fields(StateInfo)},
    )


def load(path: str, env) -> Tuple[EnvState, torch.Tensor, torch.Generator, DialConfig, int]:
    """(EnvState, Y0, generator, DialConfig, step) from a checkpoint, on the
    env's device.  The derived fields are rebuilt at the stored (qpos,
    qvel) by the forward stages `reset` uses (`env.full_state`); the
    warmstart and everything else are restored as stored.  A checkpoint
    whose generator lived on another device type than the env's raises
    ValueError."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
        saved = meta.get("generator_device")
        here = torch.device(env.device).type
        if saved != here:
            raise ValueError(
                f"checkpoint {path!r}: its noise generator was saved on {saved!r} and cannot "
                f"resume on {here!r} (a CPU and a CUDA generator keep different states); "
                f"resume it on a {saved!r} env")

        def t(name):
            return torch.as_tensor(data[name], device=env.device)

        fields = {f.name: f"info_{f.name}" for f in dataclasses.fields(StateInfo)}
        info = StateInfo(**{k: t(v) for k, v in fields.items() if v in data.files},
                         **({} if "info_seed" in data.files else  # written before the seed
                            {"seed": torch.zeros((), dtype=torch.int64, device=env.device)}))
        state = env.full_state(t("qpos"), t("qvel"), t("qacc_warmstart"), info,
                               reward=t("reward"), done=t("done"))
        generator = torch.Generator(device=env.device)
        generator.set_state(torch.from_numpy(data["generator"]))
        Y0 = t("Y0")
    return state, Y0, generator, DialConfig(**meta["dial"]), int(meta["step"])
