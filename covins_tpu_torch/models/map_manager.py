"""Map manager: per-agent map registry.

Counterpart of `covins_tpu/models/map_manager.py` (the registry part):
one map per new agent, attachment of loaded maps, and id resolution across
maps.  Loop correction, map merging and pose-graph optimisation belong to
the place-recognition part of the port: :meth:`MapManager.handle_loop`
raises, and :meth:`MapManager.flush_pending_pgo` refuses a pending solve.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from covins_tpu_torch.device import DeviceLike, resolve_device
from covins_tpu_torch.models.kf_database import KeyframeDatabase
from covins_tpu_torch.models.map_store import Map
from covins_tpu_torch.models.placerec import NOT_PORTED, LoopResult
from covins_tpu_torch.utils.config import Config


class MapManager:
    def __init__(self, vocabulary: np.ndarray, config: Optional[Config] = None,
                 output_dir: Optional[str] = None, device: DeviceLike = None):
        self.cfg = config or Config()
        self.device = resolve_device(device)
        self.database = KeyframeDatabase(vocabulary, device=self.device)
        self.maps: Dict[int, Map] = {}
        self.map_of_client: Dict[int, int] = {}
        self._next_map_id = 0
        # map id -> PGO pose seed of loops applied with deferred PGO
        self.pending_pgo: Dict[int, Optional[np.ndarray]] = {}
        # when set, maps write trajectories every 50 KFs (`map_be.cpp:391-395`)
        self.output_dir = output_dir

    def _attach(self, mp: Map):
        if self.output_dir:
            mp.traj_dir = self.output_dir
            mp.traj_fmt = self.cfg.trajectory_format

    def init_map(self, client_id: int) -> Map:
        """`MapManager::InitializeMap` — one fresh map per new agent."""
        mp = Map(
            self._next_map_id,
            desc_bytes=self.cfg.desc_length,
            desc_dtype=(np.float32 if self.cfg.feat_type == "SIFT" else np.uint8),
            device=self.device,
        )
        self._attach(mp)
        self.maps[mp.id] = mp
        self.map_of_client[client_id] = mp.id
        self._next_map_id += 1
        return mp

    def register_map(self, mp: Map):
        """`MapManager::RegisterMap` — attach a loaded map and index its
        keyframes into the retrieval database."""
        mp.id = self._next_map_id
        self._attach(mp)
        self._next_map_id += 1
        self.maps[mp.id] = mp
        for cid in mp.associated_clients:
            self.map_of_client[cid] = mp.id
        for row in mp.live_kf_rows():
            nf = int(mp.kf_n_feat[row])
            if nf > 0:
                kid = tuple(mp.kf_ids[row])
                self.database.add_keyframe(kid, mp.descriptors[row, :nf])

    def map_of(self, client_id: int) -> Map:
        return self.maps[self.map_of_client[client_id]]

    def resolve(self, kf_id: tuple) -> Tuple[Optional[Map], int]:
        """kf id -> (map, row) across all registered maps; the owning
        client's map is tried first."""
        mid = self.map_of_client.get(int(kf_id[1]))
        if mid is not None:
            mp = self.maps.get(mid)
            if mp is not None:
                row = mp.kf_row(kf_id)
                if row >= 0:
                    return mp, row
        for mp in self.maps.values():
            row = mp.kf_row(kf_id)
            if row >= 0:
                return mp, row
        return None, -1

    def handle_loop(self, loop: LoopResult, defer_pgo: bool = False) -> str:
        raise NotImplementedError(NOT_PORTED)

    def flush_pending_pgo(self):
        """Run the deferred pose-graph solves; with nothing pending (the
        only state this port can reach so far) it does nothing."""
        if self.pending_pgo:
            raise NotImplementedError(NOT_PORTED)
