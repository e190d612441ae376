"""TCP ingest server: the agent-facing plane of the back-end.

Re-design of the reference server front door (`CovinsBackend::Run` accept
loop, `covins_backend/src/covins_backend/backend.cpp:72-113,359-401` and
the per-agent server `Communicator`, `communicator_be.cpp`): an asyncio
acceptor assigns monotonically-increasing client ids (the handshake of
`communicator_be.cpp:41-48`), decodes wire frames into messages, and feeds
them to a single worker thread that owns all map mutation (the functional
equivalent of the reference's MapManager checkout/return protocol — one
writer, snapshot readers).

An admin channel on the same socket accepts JSON control frames carrying
the four ROS-service verbs (`backend.cpp:128-357`): gba / savemap /
loadmap / prunemap, plus pgo, snapshot and stats.

Counterpart of `covins_tpu/comm/server.py`, speaking the same frames.  The
map state lives on the server's ``device`` (the CUDA card unless the
caller asks for the CPU): the worker thread binds that device before it
touches a tensor, and a server on a card builds every kernel before it
accepts a connection, so that no reply waits behind the compiler.  The
worker catches an exception so that the server stays up, as the reference
does, reports it, and keeps it in :attr:`CovinsServer.errors`.
"""

from __future__ import annotations

import asyncio
import functools
import json
import os
import queue
import threading
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from covins_tpu_torch import cuda_build
from covins_tpu_torch.comm import cereal_bridge as cb
from covins_tpu_torch.comm import messages as msgs
from covins_tpu_torch.comm import wire
from covins_tpu_torch.device import DeviceLike
from covins_tpu_torch.io import export as vis_export
from covins_tpu_torch.models.map_manager import MapManager
from covins_tpu_torch.models.map_store import Map
from covins_tpu_torch.models.session import AgentSession
from covins_tpu_torch.utils import npgeo
from covins_tpu_torch.utils.config import Config

MSG_ADMIN = 100
MSG_ADMIN_REPLY = 101
START_TIMEOUT_S = 600.0


class CovinsServer:
    def __init__(
        self,
        vocabulary: np.ndarray,
        config: Optional[Config] = None,
        host: str = "0.0.0.0",
        port: int = 9871,
        output_dir: str = "output",
        cereal_port: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.cfg = config or Config()
        self.host = host
        self.port = port
        # optional second listener speaking the reference's cereal/TCP
        # agent protocol, so stock C++ front-ends can attach unmodified
        # (`communicator_base.cpp:276-315`; comm/cereal_bridge.py)
        self.cereal_port = cereal_port
        self.output_dir = output_dir
        self.manager = MapManager(vocabulary, self.cfg, output_dir=output_dir,
                                  device=device)
        self.sessions: Dict[int, AgentSession] = {}
        # (what the worker was doing, the formatted traceback) of every
        # exception the worker caught
        self.errors: List[tuple] = []
        # client id -> time.perf_counter() when its finish (flush and
        # trajectory write-out) completed
        self.finished: Dict[int, float] = {}
        self._next_client_id = 0
        self._work: "queue.Queue[tuple]" = queue.Queue()
        self._worker = threading.Thread(target=self._work_loop, daemon=True)
        self._stop = threading.Event()
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._shutdown_evt: Optional[asyncio.Event] = None
        self._conn_tasks: set = set()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ worker
    def _caught(self, what: str) -> str:
        """Keep and report the exception being handled; returns its last
        line."""
        tb = traceback.format_exc()
        self.errors.append((what, tb))
        print(f"[covins-server] {what} error:\n{tb}", flush=True)
        return tb.strip().splitlines()[-1]

    def _work_loop(self):
        """Single map-mutation thread (the checkout-protocol replacement)."""
        if self.manager.device.type == "cuda":
            torch.cuda.set_device(self.manager.device)
        held = None  # control item deferred while draining a msg batch
        while not self._stop.is_set():
            if held is not None:
                item, held = held, None
            else:
                try:
                    item = self._work.get(timeout=0.2)
                except queue.Empty:
                    # idle: drain deferred place recognition (the
                    # reference's PlaceRecognition-thread work, scheduled
                    # at lower priority than ingest; single-writer kept).
                    # Verification is window-batched (one async dispatch
                    # per candidate), so a large drain window amortizes the
                    # device round-trip latency.
                    for sess in list(self.sessions.values()):
                        if sess.placerec_backlog:
                            try:
                                sess.drain_placerec(max_items=32)
                            except Exception:
                                self._caught("placerec")
                            break
                    continue
            kind, payload, done = item
            try:
                if kind == "msg":
                    # drain consecutive data messages into one window so
                    # the session's batched ingest amortizes device work
                    # across keyframes (stop at the first control item)
                    batches: Dict[int, list] = {payload[0]: [payload[1]]}
                    drained = 1
                    while drained < 2048:
                        try:
                            nxt = self._work.get_nowait()
                        except queue.Empty:
                            break
                        if nxt[0] != "msg":
                            held = nxt
                            break
                        batches.setdefault(nxt[1][0], []).append(nxt[1][1])
                        drained += 1
                    for client_id, window in batches.items():
                        sess = self.sessions.get(client_id)
                        if sess is None:
                            # sessions (and their maps) are created LAZILY
                            # on the first data message, after any resume
                            # handshake — so a reconnecting agent never
                            # leaks an orphan session/map for its
                            # provisional id
                            sess = AgentSession(client_id, self.manager,
                                                self.cfg)
                            self.sessions[client_id] = sess
                        sess.ingest_many(window)
                    # bounded deferred-placerec drain per processed window:
                    # under sustained multi-agent traffic the idle-only
                    # drain never runs and the backlog (plus its queued
                    # device-resident BoW score buffers) grows without
                    # bound, stalling loop closures until agent finish —
                    # the reference schedules its PlaceRecognition thread
                    # concurrently with ingest (`placerec_be.cpp:508-537`)
                    for sess in self.sessions.values():
                        if sess.placerec_backlog > 128:
                            try:
                                sess.drain_placerec(max_items=32)
                            except Exception:
                                self._caught("placerec")
                    self._maybe_export_snapshots()
                elif kind == "finish":
                    client_id = payload
                    sess = self.sessions.get(client_id)
                    if sess:
                        sess.flush()
                        mp = self.manager.map_of(client_id)
                        mp.write_trajectories(
                            self.output_dir, fmt=self.cfg.trajectory_format
                        )
                        self.finished[client_id] = time.perf_counter()
                elif kind == "admin":
                    cmd, reply = payload
                    reply["result"] = self._admin(cmd)
                elif kind == "collect":
                    client_id, reply = payload
                    reply["msg"] = self._collect_for_agent(client_id)
            except Exception:  # keep the worker alive; report
                err = self._caught(kind)
                if kind == "admin":
                    payload[1]["error"] = err
            finally:
                if done is not None:
                    done.set()

    def _maybe_export_snapshots(self):
        """Periodic headless visualization export: the product-facing
        equivalent of the reference's Visualizer polling thread redrawing
        after every comm iteration (`visualization_be.cpp:46-61,472-498`,
        `communicator_be.cpp:246`).  Gated by `vis.active`; writes one
        JSON VisBundle per map every `vis.snapshot_interval_kf` ingested
        keyframes.  Plot with e.g.:
          python -c "import json,matplotlib.pyplot as p; s=json.load(open(
          'output/vis_map1.json')); [p.plot(*zip(*[(x[4],x[5]) for x in
          a['poses']]), color=a['color']) for a in s['agents'].values()];
          p.savefig('map.png')"
        """
        if not getattr(self.cfg, "vis_active", False):
            return
        total = sum(s.stats["keyframes"] for s in self.sessions.values())
        last = getattr(self, "_vis_last_kf", 0)
        if total - last < self.cfg.vis_snapshot_interval_kf:
            return
        self._vis_last_kf = total
        os.makedirs(self.output_dir, exist_ok=True)
        for mid, mp in self.manager.maps.items():
            vis_export.write_snapshot(
                mp, f"{self.output_dir}/vis_map{mid}.json",
                covis_thres=self.cfg.covis_thres,
            )

    def _collect_for_agent(self, client_id: int):
        """`Communicator::CollectDataForAgent` (`communicator_be.cpp:51-69`):
        the newest own keyframe's (optimized) pose relative to KF0, shipped
        back to the agent as a keyframe-update message."""
        if client_id not in self.manager.map_of_client:
            return None
        mp = self.manager.map_of(client_id)
        rows = mp.live_kf_rows(client_id)
        if len(rows) == 0:
            return None
        newest = rows[int(np.argmax(mp.kf_ids[rows, 0]))]
        kf0 = mp.kf_row((0, client_id))
        if kf0 < 0:
            return None
        T_sref_s = npgeo.pose_relative(mp.kf_pose[kf0], mp.kf_pose[newest])
        return msgs.MsgKeyframeUpdate(
            id=tuple(int(x) for x in mp.kf_ids[newest]),
            id_reference=(0, client_id),
            T_sref_s=T_sref_s,
            velocity=mp.kf_vel[newest].copy(),
            bias_gyro=mp.kf_bias[newest, :3].copy(),
            bias_acc=mp.kf_bias[newest, 3:].copy(),
        )

    def _admin(self, cmd: dict):
        """The four service verbs (`backend.cpp:128-357`)."""
        verb = cmd.get("verb")

        def resolve_map_id():
            """Default / post-merge-safe map id: an explicit id is used as
            given; otherwise fall back to the (single) live map — after a
            merge the absorbed id no longer exists, and failing a default
            `gba` on it would be a trap (found by the e2e drive)."""
            mid = cmd.get("map_id")
            if mid is not None and int(mid) in self.manager.maps:
                return int(mid)
            if mid is None and self.manager.maps:
                return min(self.manager.maps)
            raise KeyError(f"no such map: {mid} "
                           f"(live: {sorted(self.manager.maps)})")

        if verb == "gba":
            # `CallbackGBA` action codes (`backend.cpp:128-176`): visual-only
            # and outlier-removal toggles + optional solver time budget.
            map_id = resolve_map_id()
            visual_only = bool(cmd.get("visual_only", False))
            outlier_removal = bool(cmd.get("outlier_removal", True))
            tb = cmd.get("time_budget_s")
            info = self.manager.run_gba(
                map_id, visual_only=visual_only,
                outlier_removal=outlier_removal,
                time_budget_s=float(tb) if tb is not None else None,
            )
            mp = self.manager.maps[map_id]
            mp.write_trajectories(self.output_dir, fmt=self.cfg.trajectory_format)
            # run_gba fetched the costs from the device
            return {"ok": True, "n_pruned": int(info.get("n_pruned", 0)),
                    "time_budget_hit": bool(info.get("time_budget_hit", False)),
                    "final_cost": float(np.asarray(info["costs"])[-1])}
        if verb == "pgo":
            map_id = resolve_map_id()
            self.manager.run_pgo(self.manager.maps[map_id])
            return {"ok": True}
        if verb == "savemap":
            map_id = resolve_map_id()
            path = cmd.get("path", f"{self.output_dir}/map_{map_id}.npz")
            self.manager.maps[map_id].save(path)
            return {"ok": True, "path": path}
        if verb == "loadmap":
            if self.sessions:
                # load only before agents register (`backend.cpp:198-202`)
                return {"ok": False, "error": "agents already registered"}
            mp = Map.load(cmd["path"], device=self.manager.device)
            self.manager.register_map(mp)
            out = {"ok": True, "map_id": mp.id, "n_kf": int(mp.kf_mask.sum())}
            if cmd.get("placerec_replay"):
                # optional placerec replay over the loaded keyframes +
                # PGO (`backend.cpp:247-283` / action semantics :214-237)
                out["replay"] = self.manager.replay_placerec(
                    mp, perform_pgo=bool(cmd.get("run_pgo", True))
                )
            return out
        if verb == "prunemap":
            map_id = resolve_map_id()
            mp = self.manager.maps[map_id]
            removed = mp.remove_redundant_keyframes(
                threshold=self.cfg.kf_culling_th_red,
                max_time_dist=self.cfg.kf_culling_max_time_dist,
                target_kf_count=cmd.get("max_num_kfs"),
            )
            return {"ok": True, "removed": removed}
        if verb == "snapshot":
            # on-demand visualization export (`Visualizer::DrawMap` role,
            # `visualization_be.cpp:472-498`) — writes the VisBundle JSON
            # for one map (or every map) and returns the paths
            os.makedirs(self.output_dir, exist_ok=True)
            ids = ([int(cmd["map_id"])] if "map_id" in cmd
                   else sorted(self.manager.maps))
            paths = []
            for mid in ids:
                if mid not in self.manager.maps:
                    return {"ok": False, "error": f"no map {mid}"}
                path = cmd.get("path", f"{self.output_dir}/vis_map{mid}.json")
                vis_export.write_snapshot(
                    self.manager.maps[mid], path,
                    covis_thres=self.cfg.covis_thres,
                )
                paths.append(path)
            return {"ok": True, "paths": paths}
        if verb == "stats":
            return {
                "ok": True,
                "maps": {
                    mid: {"n_kf": int(mp.kf_mask[: mp.n_kf].sum()),
                          "n_lm": int(mp.lm_mask[: mp.n_lm].sum()),
                          "clients": sorted(mp.associated_clients),
                          "loops": len(mp.loops)}
                    for mid, mp in self.manager.maps.items()
                },
                "n_merges": self.manager.n_merges,
                "n_loops": self.manager.n_loops,
                "sessions": {cid: s.stats for cid, s in self.sessions.items()},
            }
        return {"ok": False, "error": f"unknown verb {verb}"}

    # ------------------------------------------------------------ asyncio
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        client_id = self._next_client_id
        self._next_client_id += 1
        # NOTE: no session/map is created yet — the worker creates it on
        # the first data message, so a resume handshake can re-bind the
        # connection to its old id without leaking a provisional session
        # handshake: assign the client id (`communicator_be.cpp:41-48`)
        hs = wire.frame(msgs.MSG_HANDSHAKE,
                        json.dumps({"client_id": client_id}).encode())
        writer.write(hs)
        await writer.drain()
        # ctx is shared with the _data_to_agent task so a resume re-binds
        # the server->agent push stream too
        ctx = {"client_id": client_id}
        send_task = None
        if self.cfg.data_to_client:
            send_task = asyncio.ensure_future(
                self._data_to_agent(ctx, writer)
            )
        try:
            while True:
                hdr = await reader.readexactly(wire.HEADER_SIZE)
                msg_type, plen = wire.parse_header(hdr)
                payload = await reader.readexactly(plen)
                if msg_type == msgs.MSG_FINISH:
                    break
                if msg_type == msgs.MSG_HANDSHAKE:
                    # resume request: re-attach to an existing session
                    # (improvement over the reference, which fatals on a
                    # reconnecting agent's duplicate KF ids, readme.md:315-318)
                    req = json.loads(bytes(payload))
                    rid = int(req.get("resume_client_id", -1))
                    if rid >= 0:
                        client_id = rid
                        ctx["client_id"] = rid
                    continue
                if msg_type == MSG_ADMIN:
                    cmd = json.loads(bytes(payload))
                    reply: dict = {}
                    done = threading.Event()
                    self._work.put(("admin", (cmd, reply), done))
                    await asyncio.get_event_loop().run_in_executor(None, done.wait)
                    writer.write(wire.frame(MSG_ADMIN_REPLY,
                                            json.dumps(reply).encode()))
                    await writer.drain()
                    continue
                msg = wire.decode_message(msg_type, memoryview(payload))
                self._work.put(("msg", (client_id, msg), None))
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass  # hang-up == finish (`communicator_base.cpp:233-244`)
        finally:
            if send_task is not None:
                send_task.cancel()
            done = threading.Event()
            self._work.put(("finish", client_id, done))
            try:
                await asyncio.shield(asyncio.get_event_loop().run_in_executor(
                    None, functools.partial(done.wait, 10.0)))
            except asyncio.CancelledError:
                pass
            writer.close()

    async def _handle_cereal_conn(self, reader: asyncio.StreamReader,
                                  writer: asyncio.StreamWriter):
        """Reference-protocol connection: id-assignment container, then
        framed 10x5 header containers + cereal payloads
        (`communicator_base.cpp:41-48` handshake, `:276-315` RecvMsg)."""
        client_id = self._next_client_id
        self._next_client_id += 1
        writer.write(cb.id_assignment(client_id))
        await writer.drain()
        try:
            while True:
                header = await reader.readexactly(cb.HEADER_BYTES)
                total = cb.header_total(header)
                payload = (await reader.readexactly(total)) if total else b""
                for msg in cb.decode_container(header, payload):
                    self._work.put(("msg", (client_id, msg), None))
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass  # hang-up == finish, like the reference's recv loop
        finally:
            done = threading.Event()
            self._work.put(("finish", client_id, done))
            try:
                await asyncio.get_event_loop().run_in_executor(
                    None, lambda: done.wait(10.0))
            except asyncio.CancelledError:
                pass
            writer.close()

    async def _data_to_agent(self, ctx: dict, writer: asyncio.StreamWriter):
        """Periodic server->agent data at `comm.to_agent_freq` when
        `comm.data_to_client` (`communicator_be.cpp:215-231`).  `ctx` holds
        the connection's (possibly resumed) client id."""
        period = 1.0 / max(float(self.cfg.to_agent_freq), 1e-3)
        try:
            while True:
                await asyncio.sleep(period)
                reply: dict = {}
                done = threading.Event()
                self._work.put(("collect", (ctx["client_id"], reply), done))
                await asyncio.get_event_loop().run_in_executor(
                    None, functools.partial(done.wait, 5.0))
                msg = reply.get("msg")
                if msg is not None:
                    writer.write(wire.encode_message(msg))
                    await writer.drain()
        except (asyncio.CancelledError, ConnectionResetError, OSError):
            pass

    async def serve(self, on_listening=None):
        """Run until `shutdown()` (or `stop()` from another thread).

        Connection handlers are tracked so shutdown can cancel them
        deterministically — the reference leaks its detached comm threads
        on exit (`handler_be.cpp:52-56`); here teardown is explicit.  On a
        card, every kernel is built before the first connection;
        ``on_listening()`` is called once every socket is bound."""
        self._loop = asyncio.get_running_loop()
        self._shutdown_evt = asyncio.Event()
        if self.manager.device.type == "cuda":
            await self._loop.run_in_executor(None, cuda_build.build_all)
        self._worker.start()

        async def tracked(reader, writer):
            task = asyncio.current_task()
            self._conn_tasks.add(task)
            try:
                await self._handle_conn(reader, writer)
            finally:
                self._conn_tasks.discard(task)

        self._server = await asyncio.start_server(tracked, self.host, self.port)

        async def tracked_cereal(reader, writer):
            task = asyncio.current_task()
            self._conn_tasks.add(task)
            try:
                await self._handle_cereal_conn(reader, writer)
            finally:
                self._conn_tasks.discard(task)

        cereal_server = None
        if self.cereal_port is not None:
            cereal_server = await asyncio.start_server(
                tracked_cereal, self.host, self.cereal_port)
        if on_listening is not None:
            on_listening()
        async with self._server:
            await self._shutdown_evt.wait()
        if cereal_server is not None:
            cereal_server.close()
            await cereal_server.wait_closed()
        for t in list(self._conn_tasks):
            t.cancel()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        self._stop.set()
        self._worker.join(timeout=5.0)

    async def shutdown(self):
        self._shutdown_evt.set()

    def stop(self):
        """Thread-safe shutdown; joins the background thread if one was
        started with `start_background()`.  Waits briefly for `serve()` to
        initialize its loop/event so an early call cannot silently no-op
        and leave the server running."""
        deadline = time.monotonic() + 5.0
        while (
            (self._loop is None or self._shutdown_evt is None)
            and self._thread is not None
            and self._thread.is_alive()
            and time.monotonic() < deadline
        ):
            time.sleep(0.01)
        if self._loop is not None and self._shutdown_evt is not None:
            self._loop.call_soon_threadsafe(self._shutdown_evt.set)
        elif self._thread is not None and self._thread.is_alive():
            raise RuntimeError("server loop never initialized; cannot stop")
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def start_background(self) -> threading.Thread:
        """Run the server in a daemon thread with its own event loop;
        returns once it listens (after the kernels' build on a card, which
        may take minutes), or after START_TIMEOUT_S."""
        started = threading.Event()

        def run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)

            async def main():
                serve_task = asyncio.ensure_future(self.serve())
                # server socket is bound once serve() creates it
                while self._server is None and not serve_task.done():
                    await asyncio.sleep(0.01)
                started.set()
                await serve_task

            try:
                loop.run_until_complete(main())
            finally:
                loop.close()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        started.wait(timeout=START_TIMEOUT_S)
        return self._thread

    def run(self, on_listening=None):
        try:
            asyncio.run(self.serve(on_listening))
        except KeyboardInterrupt:
            pass
        finally:
            self._stop.set()
