"""The at-rest storage of an optimizer's parameter-shaped slots
(``sharding_configs.moment_dtype`` of the train step): the reference's
signed-sqrt q8 codec (``distributed/fleet/dist_step.py``) and the slot
transform between the f32 working form and the stored dtype.

An int8 slot ``"m"`` is stored as its codes under ``"m"`` and its f32
per-row scales under ``"m@scale"`` (:data:`_SCALE_SUFFIX`).  Saved
optimizer state carries them so, and loading codes into f32 slots
decodes them (:meth:`..optimizer.Optimizer.set_state_dict`,
``framework.io.load_jax_opt_state``).
"""
from __future__ import annotations

import torch

# storage suffix of an int8 slot's per-row scales ("m" -> "m@scale")
_SCALE_SUFFIX = "@scale"

# slots under a square root in their optimizer's denominator: their codes
# round away from zero, so a live value never decodes to 0
_DENOM_SLOTS = frozenset({"v", "inf_norm", "moment", "mean_square"})


def _sqrt_rn(x):
    """The correctly rounded f32 square root on either device: CUDA's f32
    ``sqrt`` is; the CPU's is taken in f64 and rounded once."""
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.double()).float()


def _q8_encode(x, round_up=False, row_max=None):
    """f32 slot -> (int8 codes, f32 scales over the last dim) in
    signed-sqrt space: ``y = sign(x) sqrt|x|``, ``s = max(max|y|, 1e-12) /
    127`` a row, codes ``y / s`` rounded to nearest (``round_up``: their
    magnitude rounded up, clipped to 127).  ``row_max``: for a row split
    over ranks, a function that takes the maximum of the rows' maxima
    over them (in place)."""
    y = torch.sign(x) * _sqrt_rn(torch.abs(x))
    m = torch.amax(torch.abs(y), dim=-1)
    if row_max is not None:
        row_max(m)
    s = torch.clamp_min(m, 1e-12) / torch.tensor(127.0, device=x.device)
    c = y / s[..., None]
    if round_up:
        q = torch.clamp(torch.sign(c) * torch.ceil(torch.abs(c)),
                        -127.0, 127.0).to(torch.int8)
    else:
        q = torch.round(c).to(torch.int8)
    return q, s


def _q8_decode(q, s):
    y = q.float() * s[..., None]
    return torch.sign(y) * (y * y)


def _transform_slots(st, pshape, mdt, direction, row_max=None):
    """The slot-storage transform: parameter-shaped floating (or int8)
    slots convert between the f32 working form (``"decode"``) and the
    at-rest dtype (``"encode"``); scalars and scale leaves pass
    through."""
    int8_mode = mdt == torch.int8
    d = {}
    for k, v in st.items():
        if k.endswith(_SCALE_SUFFIX):
            if direction != "decode":
                d[k] = v
            continue
        if not (isinstance(v, torch.Tensor) and tuple(v.shape) == pshape):
            d[k] = v
            continue
        if direction == "decode":
            if int8_mode and v.dtype == torch.int8:
                d[k] = _q8_decode(v, st[k + _SCALE_SUFFIX])
            elif v.is_floating_point():
                d[k] = v.float()
            else:
                d[k] = v
        elif not v.is_floating_point():
            d[k] = v
        elif int8_mode:
            if len(pshape) >= 1:
                d[k], d[k + _SCALE_SUFFIX] = _q8_encode(
                    v.float(), round_up=k in _DENOM_SLOTS, row_max=row_max)
            else:
                d[k] = v
        else:
            d[k] = v.to(mdt)
    return d
