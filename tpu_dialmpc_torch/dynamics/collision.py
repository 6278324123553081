"""Per-contact-slot parameters of the static collision pair tables.

Counterpart of `contact_params` in `tpu_dialmpc/dynamics/collision.py`, which
`fused._meta` reads.  The narrowphase itself lives in the fused substep
(`fused.py`): the port implements the plane-sphere kind.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from tpu_dialmpc_torch.dynamics.model import PhysicsModel


class ContactParams(NamedTuple):
    """Static per-slot parameters aligned with Contacts rows (numpy)."""

    body1: np.ndarray
    body2: np.ndarray
    geom1: np.ndarray
    geom2: np.ndarray
    condim: np.ndarray
    friction: np.ndarray  # (ncon, 5)
    solref: np.ndarray  # (ncon, 2)
    solimp: np.ndarray  # (ncon, 5)
    includemargin: np.ndarray  # (ncon,)
    invweight: np.ndarray  # (ncon,)


def contact_params(model: PhysicsModel) -> ContactParams:
    """Expand the per-pair static tables to per-contact-slot arrays."""
    rows = {k: [] for k in ContactParams._fields}
    for kind in sorted(model.pairs):
        p = model.pairs[kind]
        npair = p.geom1.shape[0]
        for i in range(npair):
            for _ in range(p.ncon):
                rows["body1"].append(model.geom_bodyid[p.geom1[i]])
                rows["body2"].append(model.geom_bodyid[p.geom2[i]])
                rows["geom1"].append(p.geom1[i])
                rows["geom2"].append(p.geom2[i])
                rows["condim"].append(p.condim[i])
                rows["friction"].append(p.friction[i])
                rows["solref"].append(p.solref[i])
                rows["solimp"].append(p.solimp[i])
                rows["includemargin"].append(p.margin[i] - p.gap[i])
                rows["invweight"].append(p.invweight[i])
    return ContactParams(
        body1=np.array(rows["body1"], dtype=np.int32),
        body2=np.array(rows["body2"], dtype=np.int32),
        geom1=np.array(rows["geom1"], dtype=np.int32),
        geom2=np.array(rows["geom2"], dtype=np.int32),
        condim=np.array(rows["condim"], dtype=np.int32),
        friction=np.stack(rows["friction"]) if rows["friction"] else np.zeros((0, 5)),
        solref=np.stack(rows["solref"]) if rows["solref"] else np.zeros((0, 2)),
        solimp=np.stack(rows["solimp"]) if rows["solimp"] else np.zeros((0, 5)),
        includemargin=np.array(rows["includemargin"]),
        invweight=np.array(rows["invweight"]),
    )
