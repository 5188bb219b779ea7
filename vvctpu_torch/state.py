"""Start the port from state produced elsewhere (numpy arrays).

The reference engine's state arrives as numpy arrays (its device arrays
fetched to the host); these helpers turn it into the port's own forms so
a run can start from the reference's exact state.  Nothing here imports
the reference package: callers hand over plain arrays and objects.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .spec.alf import AlfParams
from .spec.codec import FrameDecisions


def refs_from_numpy(planes, device):
    """The padded (y, cb, cr) reference planes of a DPB entry, as
    pipeline.recon.pad_refs_dev makes them: int32 device tensors."""
    return tuple(torch.as_tensor(np.array(p, np.int32), device=device)
                 for p in planes)


def _fields_from(cls, obj_or_dict):
    """A ``cls`` dataclass with every field read by name from an object
    with those attributes or from a dict (arrays copied)."""
    def get(name):
        if isinstance(obj_or_dict, dict):
            return obj_or_dict[name]
        return getattr(obj_or_dict, name)

    vals = {}
    for f in dataclasses.fields(cls):
        v = get(f.name)
        vals[f.name] = np.array(v) if isinstance(v, np.ndarray) else v
    return cls(**vals)


def decisions_from_numpy(obj_or_dict) -> FrameDecisions:
    """A FrameDecisions with every field read by name from an object with
    those attributes or from a dict (arrays copied)."""
    return _fields_from(FrameDecisions, obj_or_dict)


def alf_params_from_numpy(obj_or_dict) -> AlfParams:
    """The ALF and CC-ALF parameters of a picture (filters, class and
    component switches, CTU flags) as the port's AlfParams, read by name
    in the same way."""
    return _fields_from(AlfParams, obj_or_dict)


def tables_from_numpy(tables: dict, device=None) -> dict:
    """{name: int32 tensor} for a dict of transform matrices and MC /
    intra filter taps given as numpy arrays (e.g. the tables active in a
    reference's rom), for comparison with the port's own tables."""
    return {k: torch.as_tensor(np.asarray(v).astype(np.int32),
                               device=device) for k, v in tables.items()}
