"""Per-agent server session: the ingest -> place-recognition ->
correction pipeline (`Communicator::Run`, `communicator_be.cpp:215-260`).

Counterpart of `covins_tpu/models/session.py`: keyframe and landmark
messages build the map (`ProcessKeyframeMessages` /
`ProcessLandmarkMessages`), landmark culling runs per keyframe
(`LandmarkCulling(2, 5)`), and each window's finalised keyframes get one
batched landmark-attribute refresh and one batched BoW insert + score into
the device-resident retrieval database.  A keyframe is finalised once its
landmark batch has arrived: when the NEXT keyframe arrives or on
:meth:`AgentSession.flush`.  Place recognition (COVINS or COVINS-G) then
detects on the host, verifies every candidate on the device, applies loops
and merges in keyframe order and runs one pose-graph solve per affected
map — inline, or deferred to :meth:`AgentSession.drain_placerec` with
``placerec_defer``.  COVINS over SIFT descriptors is refused at
construction (the reference runs SIFT in COVINS-G only).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from covins_tpu_torch.comm import messages as msgs
from covins_tpu_torch.models.map_manager import MapManager
from covins_tpu_torch.models.placerec import (LoopResult, PlaceRecognition,
                                              check_supported)
from covins_tpu_torch.utils.config import Config
from covins_tpu_torch.utils.metrics import Metrics


class AgentSession:
    """Server-side state for one connected agent.  Sessions are resumable:
    re-sent keyframes are skipped and re-sent landmarks merge."""

    def __init__(self, client_id: int, manager: MapManager,
                 config: Optional[Config] = None,
                 metrics: Optional[Metrics] = None):
        self.cfg = config or manager.cfg
        check_supported(self.cfg)
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
        # (query id, candidate id) of every loop this session accepted
        self.accepted: list = []

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
        """Window-batched detect -> verify -> apply.

        Detection runs in keyframe order on the host (consistency groups
        are stateful) and every surviving candidate's verification is
        dispatched at once; results are then fetched and applied in
        keyframe order, one device-to-host copy each.  A loop accepted at
        keyframe i gates detection for keyframes within
        `consecutive_loop_dist`; detection ran before the verdicts, so the
        gate is applied again at apply time.
        """
        cfg = self.cfg
        outcomes = []
        jobs = []
        for kf_id, pre in items:
            mp = self._current_map()  # may have merged mid-window
            row = mp.kf_row(kf_id)
            if row < 0:
                continue
            dispatched = []
            if cfg.placerec_active:
                with self.metrics.timer("placerec_detect"):
                    cands = self.placerec.detect_loop(mp, row, pre=pre)
                for cand_id in cands:
                    mp_c, c_row = self.manager.resolve(cand_id)
                    if mp_c is None:
                        continue
                    job = self.placerec.dispatch_verify(mp, row, mp_c, c_row)
                    if job is not None:
                        dispatched.append((cand_id, mp_c, job))
            if dispatched:
                jobs.append((kf_id, dispatched))
            if pre is None:
                # a keyframe that missed the batched insert is added alone
                n_feat = int(mp.kf_n_feat[row])
                if n_feat > 0:
                    self.placerec.db.add_keyframe(
                        kf_id, mp.pr_descriptors(row)[:n_feat])
        for kf_id, dispatched in jobs:
            if (kf_id[0] - self.placerec.last_loop_kf_id
                    < cfg.consecutive_loop_dist):
                continue  # a loop accepted earlier in this window gates it
            for cand_id, mp_c_snap, job in dispatched:
                with self.metrics.timer("placerec_verify"):
                    got = self.placerec.finalize_verify(job)
                if got is None:
                    continue
                T_12, n_inl, cov, matches = got
                matches = self._rebind_matches(cand_id, mp_c_snap, matches)
                self.placerec.last_loop_kf_id = kf_id[0]
                loop = LoopResult(query_id=kf_id, candidate_id=cand_id,
                                  T_12=T_12, n_inliers=n_inl, cov=cov,
                                  matches=matches)
                self.accepted.append((kf_id, cand_id))
                outcome = self.manager.handle_loop(loop, defer_pgo=True)
                if outcome in ("loop", "merge"):
                    self.stats[outcome + "s"] += 1
                    outcomes.append(outcome)
                break  # the first accepted candidate wins (placerec_be.cpp:529)
        with self.metrics.timer("placerec_pgo"):
            self.manager.flush_pending_pgo()
        return outcomes

    def _rebind_matches(self, cand_id, mp_c_snap, matches):
        """Landmark rows of a verification result index the candidate map
        AT DISPATCH TIME; if an earlier loop of the same window merged that
        map away, translate the rows through the stable landmark ids."""
        if matches is None or len(matches) == 0:
            return matches
        mp_now, _ = self.manager.resolve(cand_id)
        if mp_now is mp_c_snap or mp_now is None:
            return matches
        ids = mp_c_snap.lm_ids[matches[:, 1]]
        rows = np.asarray([mp_now.lm_row(tuple(int(x) for x in i))
                           for i in ids])
        keep = rows >= 0
        out = matches[keep].copy()
        out[:, 1] = rows[keep]
        return out

    @property
    def placerec_backlog(self) -> int:
        return len(self._pr_queue)

    def drain_placerec(self, max_items: Optional[int] = None) -> list:
        """Run the deferred detection/verification for up to `max_items`
        queued keyframes (all, if None).  First commits what the verifiers
        read: the pending landmark attributes of every map (candidates may
        live elsewhere) and the queued windows' scores, fetched in one
        batched device-to-host copy."""
        n = len(self._pr_queue) if max_items is None else min(
            max_items, len(self._pr_queue))
        items = self._pr_queue[:n]
        del self._pr_queue[:n]
        for mp in self.manager.maps.values():
            mp.commit_landmark_attributes()
        dev = [p for _, p in items
               if p is not None and not isinstance(p["scores"], np.ndarray)]
        if dev:
            # scores (float32) and common-word counts (int32) share one
            # buffer: the counts travel as their float32 bit patterns
            flat = torch.cat([x for p in dev for x in (
                p["scores"], p["common"].view(torch.float32))]).cpu().numpy()
            o = 0
            for p in dev:
                k = p["scores"].shape[0]
                p["scores"] = flat[o:o + k]
                p["common"] = flat[o + k:o + 2 * k].view(np.int32)
                o += 2 * k
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
