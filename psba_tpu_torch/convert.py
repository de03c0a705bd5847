"""Carry problem and solver state between psba_tpu and this port.

psba_tpu's containers hold jax arrays; passed through `numpy.asarray`
field by field they become the numpy inputs of `from_reference` and
`state_from_reference`, so both packages can compute on the same state.
`to_numpy` goes back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from psba_tpu_torch import constants as CC
from psba_tpu_torch.ops.linearize_stream import build_stream_tables
from psba_tpu_torch.solvers.types import OptState, ProblemArrays, torch_dtype

_FIELDS = ("K", "q0", "obs", "cam_idx", "pt_idx")
_DENSE = ("obs_du", "obs_dv", "valid_d")
_PAIRS = ("pair_o1", "pair_o2", "pair_bucket")


def _getter(obj):
    return (obj.get if isinstance(obj, dict)
            else lambda k: getattr(obj, k, None))


def _present(a) -> bool:
    return a is not None and np.asarray(a).dtype != object


def from_reference(pa_np, cams_np, pts_np, device="cpu", dtype=None):
    """Port tensors from the reference's ProblemArrays fields and camera /
    point arrays given as numpy (a mapping or an object with the fields
    K, q0, obs, cam_idx, pt_idx and one encoding: the dense tables obs_du,
    obs_dv, valid_d, or the pair list pair_o1, pair_o2, pair_bucket; the
    reference builds only the one it solves with).

    Returns (ProblemArrays, cams [C, 6], pts [P, 3]) on `device`, floating
    fields in `dtype` (default: the dtype of cams_np)."""
    get = _getter(pa_np)
    dt = torch_dtype(np.asarray(cams_np).dtype if dtype is None else dtype)
    enc = [k for k in _DENSE + _PAIRS if _present(get(k))]
    if sorted(enc) not in (sorted(_DENSE), sorted(_PAIRS)):
        raise ValueError(f"from_reference: need the three dense tables or "
                         f"the three pair fields, got {enc}")
    out = {}
    for k in _FIELDS + tuple(enc):
        if not _present(get(k)):
            raise ValueError(f"from_reference: field {k} missing")
        a = np.asarray(get(k))
        kind = torch.int64 if np.issubdtype(a.dtype, np.integer) else dt
        out[k] = torch.tensor(a, dtype=kind, device=device)
    cam_idx, pt_idx = np.asarray(get("cam_idx")), np.asarray(get("pt_idx"))
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=dt, device=device)
    pts = as_t(pts_np)
    out["stream"] = st = build_stream_tables(
        cam_idx, pt_idx, out["K"].shape[0], pts.shape[0], device=device)
    out["cam_idx32"], out["pt_idx32"] = st.cam32, st.pt32
    return ProblemArrays(**out), as_t(cams_np), pts


def state_from_reference(st_np, device="cpu", dtype=None) -> OptState:
    """Port OptState from the reference's OptState fields as numpy (a
    mapping or an object with cams, pts, ex, ex_l2, itno, flag and the
    optional history and aux, absent as None or as a numpy object array
    of None). The phase-scalar vector `aux` (LM or TR)
    and the history rows carry over, so a phase can start in both packages
    from one state."""
    get = _getter(st_np)
    dt = torch_dtype(np.asarray(get("cams")).dtype if dtype is None
                     else dtype)
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=dt, device=device)
    aux, hist, flag = get("aux"), get("history"), get("flag")
    return OptState(
        cams=as_t(get("cams")), pts=as_t(get("pts")), ex=as_t(get("ex")),
        ex_l2=as_t(get("ex_l2")), itno=int(np.asarray(get("itno"))),
        flag=(int(np.asarray(flag)) if _present(flag)
              else CC.ITER_CONTINUE),
        history=np.array(hist) if _present(hist) else None,
        aux=as_t(aux) if _present(aux) else None,
    )


def to_numpy(obj):
    """numpy view of a tensor, or of every tensor in a tuple / list /
    ProblemArrays / OptState (a dict of fields for the dataclasses; an
    OptState's aux and history come along)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_numpy(x) for x in obj)
    return obj
