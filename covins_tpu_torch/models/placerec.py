"""Place recognition: the loop result type and the per-agent handle on the
shared retrieval database.

Counterpart of `covins_tpu/models/placerec.py`.  Loop detection and the
five-stage loop verification are the port's next part; until they land,
:class:`PlaceRecognition` raises on every detection or verification call,
and sessions refuse ``placerec_active=True`` at construction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from covins_tpu_torch.models.kf_database import KeyframeDatabase
from covins_tpu_torch.utils.config import Config

NOT_PORTED = ("loop detection and verification are not ported to "
              "covins_tpu_torch yet (the place-recognition slice of the "
              "port); run with placerec_active=False")


@dataclasses.dataclass
class LoopResult:
    query_id: tuple
    candidate_id: tuple
    T_12: np.ndarray  # T_sq_sc: candidate body -> query body
    n_inliers: int
    cov: Optional[np.ndarray] = None
    # verified (query feature idx, candidate-map landmark row) pairs
    matches: Optional[np.ndarray] = None  # (M, 2) int32


class PlaceRecognition:
    """One instance per agent, sharing the global `KeyframeDatabase`."""

    def __init__(self, client_id: int, database: KeyframeDatabase,
                 resolve, config: Optional[Config] = None):
        self.client_id = client_id
        self.db = database
        self.resolve = resolve
        self.cfg = config or Config()
        self.last_loop_kf_id = -(10**9)

    def detect_loop(self, mp, kf_row: int, pre: Optional[dict] = None):
        raise NotImplementedError(NOT_PORTED)

    def dispatch_verify(self, mp_q, q_row: int, mp_c, c_row: int):
        raise NotImplementedError(NOT_PORTED)

    def finalize_verify(self, job):
        raise NotImplementedError(NOT_PORTED)
