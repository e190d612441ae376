"""Per-agent server session: the ingest side of the server pipeline.

Counterpart of `covins_tpu/models/session.py` with place recognition
switched off (`placerec.active: false`): keyframe and landmark messages
build the map (`ProcessKeyframeMessages` / `ProcessLandmarkMessages`),
landmark culling runs per keyframe (`LandmarkCulling(2, 5)`), and each
window's finalised keyframes get one batched landmark-attribute refresh
and one batched BoW insert + score into the device-resident retrieval
database.  A keyframe is finalised once its landmark batch has arrived:
when the NEXT keyframe arrives or on :meth:`AgentSession.flush`.

Loop detection and verification are not ported yet, so a session refuses
``placerec_active=True`` instead of silently running map-only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from covins_tpu_torch.comm import messages as msgs
from covins_tpu_torch.models.map_manager import MapManager
from covins_tpu_torch.models.placerec import NOT_PORTED, PlaceRecognition
from covins_tpu_torch.utils.config import Config
from covins_tpu_torch.utils.metrics import Metrics


class AgentSession:
    """Server-side state for one connected agent.  Sessions are resumable:
    re-sent keyframes are skipped and re-sent landmarks merge."""

    def __init__(self, client_id: int, manager: MapManager,
                 config: Optional[Config] = None,
                 metrics: Optional[Metrics] = None):
        self.cfg = config or manager.cfg
        if self.cfg.placerec_active:
            raise NotImplementedError(NOT_PORTED)
        self.client_id = client_id
        self.manager = manager
        self.metrics = metrics or Metrics()
        self.map = manager.init_map(client_id)
        self.placerec = PlaceRecognition(
            client_id, manager.database, manager.resolve, self.cfg
        )
        self._pending_kf_id: Optional[tuple] = None
        # deferred queue (cfg.placerec_defer), drained by drain_placerec
        self._pr_queue: list = []
        self.stats = {"keyframes": 0, "landmarks": 0, "loops": 0,
                      "merges": 0, "duplicates": 0}

    def _current_map(self):
        return self.manager.map_of(self.client_id)

    def ingest(self, msg) -> Optional[str]:
        """Feed one message.  Returns 'loop'/'merge' when one was closed."""
        out = self.ingest_many([msg])
        return out[0] if out else None

    def ingest_many(self, messages) -> list:
        """Feed a WINDOW of messages: host bookkeeping in stream order,
        then the keyframes whose landmark batches completed are finalised
        together.  Returns the list of loop/merge outcomes."""
        finalized: list[tuple] = []
        lm_buffer: list = []  # consecutive landmark msgs, bulk-inserted

        def flush_lms():
            if lm_buffer:
                self._current_map().add_landmarks_batch(lm_buffer)
                lm_buffer.clear()

        for msg in messages:
            if isinstance(msg, msgs.MsgKeyframe):
                flush_lms()
                mp = self._current_map()
                if mp.kf_row(tuple(msg.id)) >= 0:  # resumed agent replaying
                    self.stats["duplicates"] += 1
                    continue
                if self._pending_kf_id is not None:
                    finalized.append(self._pending_kf_id)
                with self.metrics.timer("ingest_kf"):
                    mp.add_keyframe(msg)
                self._pending_kf_id = tuple(msg.id)
                self.stats["keyframes"] += 1
                self.metrics.count("keyframes")
                if self.cfg.activate_lm_culling:
                    mp.landmark_culling(min_obs=2, max_gap=5)
            elif isinstance(msg, msgs.MsgLandmark):
                mp = self._current_map()
                if mp.lm_row(tuple(msg.id)) >= 0:
                    # re-sent landmark: merge observations + refresh pos;
                    # flush first so stream order holds within the window
                    flush_lms()
                    self.stats["duplicates"] += 1
                    mp.add_landmark(msg)
                    continue
                lm_buffer.append(msg)
                self.stats["landmarks"] += 1
            elif isinstance(msg, msgs.MsgKeyframeUpdate):
                if self.cfg.send_updates:
                    self._current_map().update_keyframe_pose(msg)
            elif isinstance(msg, msgs.MsgLandmarkUpdate):
                # gated on `comm.send_updates`; buffered inserts first so
                # the update sees its row
                if self.cfg.send_updates:
                    flush_lms()
                    self._current_map().update_landmark_pos(msg)
            else:
                raise TypeError(f"unknown message type {type(msg)}")
        flush_lms()
        return self._finalize_many(finalized)

    def _finalize_many(self, kf_ids: list) -> list:
        """Finalise keyframes whose landmark batches are complete
        (`ProcessNewKeyframes`, `communicator_be.cpp:181-205`)."""
        if not kf_ids:
            return []
        mp = self._current_map()
        rows = [mp.kf_row(k) for k in kf_ids]
        live = [(k, r) for k, r in zip(kf_ids, rows) if r >= 0]
        if not live:
            return []

        # 1. one batched landmark-attribute refresh for the union cohort
        # (lazy under deferred placerec: committed at the drain)
        defer = bool(self.cfg.placerec_defer)
        o = mp.n_obs
        row_arr = np.asarray([r for _, r in live], np.int64)
        sel = np.isin(mp.obs_kf[:o], row_arr) & mp.obs_mask[:o]
        mp.update_landmark_attributes(np.unique(mp.obs_lm[:o][sel]),
                                      lazy=defer)

        # 2. one batched BoW insert + score for the window
        with_feats = [(k, r) for k, r in live if int(mp.kf_n_feat[r]) > 0]
        pre_of: dict = {}
        if with_feats:
            pres = self.placerec.db.add_and_query_batch(
                [k for k, _ in with_feats],
                [mp.pr_descriptors(r)[: int(mp.kf_n_feat[r])]
                 for _, r in with_feats],
                lazy=defer,
            )
            pre_of = {k: p for (k, _), p in zip(with_feats, pres)}

        items = [(kf_id, pre_of.get(kf_id)) for kf_id, _ in live]
        if defer:
            self._pr_queue.extend(items)
            return []
        return self._run_placerec(items)

    def _run_placerec(self, items) -> list:
        """The ``placerec_active=False`` branch of the reference's
        window-batched detect -> verify -> apply: no detection; a keyframe
        that missed the batched insert is added to the database alone."""
        for kf_id, pre in items:
            mp = self._current_map()
            row = mp.kf_row(kf_id)
            if row < 0 or pre is not None:
                continue
            n_feat = int(mp.kf_n_feat[row])
            if n_feat > 0:
                self.placerec.db.add_keyframe(
                    kf_id, mp.pr_descriptors(row)[:n_feat])
        self.manager.flush_pending_pgo()
        return []

    @property
    def placerec_backlog(self) -> int:
        return len(self._pr_queue)

    def drain_placerec(self, max_items: Optional[int] = None) -> list:
        """Run the deferred work for up to `max_items` queued keyframes
        (all, if None): commit the pending landmark attributes of every
        map and fetch the queued windows' scores to the host."""
        n = len(self._pr_queue) if max_items is None else min(
            max_items, len(self._pr_queue))
        items = self._pr_queue[:n]
        del self._pr_queue[:n]
        for mp in self.manager.maps.values():
            mp.commit_landmark_attributes()
        for _, p in items:
            if p is not None and not isinstance(p["scores"], np.ndarray):
                p["scores"] = p["scores"].cpu().numpy()
                p["common"] = p["common"].cpu().numpy()
        return self._run_placerec(items)

    def flush(self) -> Optional[str]:
        """Finalise the last buffered keyframe and drain the deferred
        backlog (agent finished)."""
        outs = []
        if self._pending_kf_id is not None:
            kf_id = self._pending_kf_id
            self._pending_kf_id = None
            outs = list(self._finalize_many([kf_id]))
        outs += self.drain_placerec()
        return outs[0] if outs else None
