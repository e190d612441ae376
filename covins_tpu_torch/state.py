"""Carry state from the JAX package into the port.

Every function here takes plain numpy arrays or objects that only look
like the JAX package's (matched by class name and fields), so the port
imports nothing of that package:

* :func:`vocabulary_from_reference` — a (V, 32) uint8 vocabulary (ORB)
  or (V, 128) float32 centres (SIFT);
* :func:`database_from_reference` — a `KeyframeDatabase` from the
  reference database's matrix, row ids and mask;
* :func:`messages_from_reference` — a reference message dataclass into the
  port's, field by field;
* :func:`preintegrated_from_reference` and :func:`gba_problem_from_reference`
  — a reference `Preintegrated` / `GBAProblem` (any object with those
  fields) into the port's, on a device;
* :func:`hier_vocabulary_from_reference` — a reference DBoW2
  `HierVocabulary`'s arrays as the port's;
* `Map.load` reads the npz that the reference `Map.save` writes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from covins_tpu_torch.comm import messages as msgs
from covins_tpu_torch.device import DeviceLike, resolve_device
from covins_tpu_torch.models.kf_database import KeyframeDatabase
from covins_tpu_torch.ops import dbow_import
from covins_tpu_torch.ops import gba as gba_mod
from covins_tpu_torch.ops import imu as imu_mod
from covins_tpu_torch.utils import cameras as cam_mod

__all__ = ["vocabulary_from_reference", "database_from_reference",
           "messages_from_reference", "preintegrated_from_reference",
           "gba_problem_from_reference", "hier_vocabulary_from_reference"]

_MESSAGE_TYPES = {cls.__name__: cls for cls in (
    msgs.VICalibration, msgs.PreintegrationData, msgs.MsgKeyframe,
    msgs.MsgKeyframeUpdate, msgs.MsgLandmark, msgs.MsgLandmarkUpdate)}


def vocabulary_from_reference(vocab) -> np.ndarray:
    """(V, 32) uint8 words or (V, 128) float32 centres, contiguous; raises
    on anything else."""
    vocab = np.ascontiguousarray(np.asarray(vocab))
    if vocab.ndim != 2 or (vocab.dtype, vocab.shape[1]) not in (
            (np.dtype(np.uint8), 32), (np.dtype(np.float32), 128)):
        raise ValueError(f"expected a (V, 32) uint8 or (V, 128) float32 vocabulary, "
                         f"got {vocab.shape} {vocab.dtype}")
    return vocab


def database_from_reference(db_matrix, row_ids, mask, vocabulary,
                            device: DeviceLike = None) -> KeyframeDatabase:
    """Rebuild a database from the reference's ``_db`` matrix (cap, V),
    ``row_ids`` [(kf_id, client_id), ...] and ``_mask`` (cap,)."""
    db_matrix = np.asarray(db_matrix, np.float32)
    mask = np.asarray(mask, bool)
    db = KeyframeDatabase(vocabulary_from_reference(vocabulary),
                          capacity=db_matrix.shape[0], device=device)
    db._db.copy_(torch.tensor(db_matrix))
    db._mask[:] = mask
    db.n = len(row_ids)
    for r, kid in enumerate(row_ids):
        kid = tuple(int(x) for x in kid)
        db.row_ids.append(kid)
        db.row_kf[r], db.row_client[r] = kid
        if mask[r]:
            db.row_of[kid] = r
    return db


def messages_from_reference(msg):
    """Convert a reference message dataclass (or a list of them) into the
    port's class of the same name, field by field; nested dataclasses
    (calibration, preintegration) are converted too."""
    if isinstance(msg, (list, tuple)):
        return [messages_from_reference(m) for m in msg]
    cls = _MESSAGE_TYPES.get(type(msg).__name__)
    if cls is None or not dataclasses.is_dataclass(msg):
        raise TypeError(f"not a message dataclass: {type(msg)}")
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(msg, f.name)
        if dataclasses.is_dataclass(v):
            v = messages_from_reference(v)
        kw[f.name] = v
    return cls(**kw)


def _tensor(x, device, index=False):
    a = np.asarray(x)
    if index:
        return torch.as_tensor(a.astype(np.int64), device=device)
    if a.dtype == bool:
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a.astype(np.float64), device=device)


def preintegrated_from_reference(pre, device: DeviceLike = None) -> imu_mod.Preintegrated:
    """A reference `Preintegrated` (batched or not) as the port's, field by
    field, float64 on ``device``."""
    dev = resolve_device(device)
    return imu_mod.Preintegrated(**{
        f.name: _tensor(getattr(pre, f.name), dev)
        for f in dataclasses.fields(imu_mod.Preintegrated)})


def gba_problem_from_reference(p, device: DeviceLike = None) -> gba_mod.GBAProblem:
    """A reference `GBAProblem` as the port's: indices int64, masks bool,
    everything else float64, the camera and the preintegrated factors
    converted field by field."""
    dev = resolve_device(device)
    cam = p.cam
    kw = {}
    for f in dataclasses.fields(gba_mod.GBAProblem):
        v = getattr(p, f.name)
        if f.name == "cam":
            kw[f.name] = cam_mod.Camera(
                intrinsics=_tensor(cam.intrinsics, dev), dist=_tensor(cam.dist, dev),
                T_s_c=_tensor(cam.T_s_c, dev), cam_model=int(cam.cam_model),
                dist_model=int(cam.dist_model))
        elif f.name == "imu_pre":
            kw[f.name] = preintegrated_from_reference(v, dev)
        else:
            kw[f.name] = _tensor(v, dev, index=f.name in (
                "obs_kf", "obs_lm", "imu_i", "imu_j", "loop_i", "loop_j"))
    return gba_mod.GBAProblem(**kw)


def hier_vocabulary_from_reference(voc) -> dbow_import.HierVocabulary:
    """A reference `HierVocabulary` (any object with its fields) as the
    port's: the same tree, each array copied in its own dtype."""
    return dbow_import.HierVocabulary(
        voc.k, voc.L, np.array(voc.children, np.int32), np.array(voc.node_desc, np.uint8),
        np.array(voc.node_weight, np.float32), np.array(voc.leaf_word_id, np.int32),
        np.array(voc.depth, np.int32), voc.scoring, voc.weighting)
