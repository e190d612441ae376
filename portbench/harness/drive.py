"""A cell's inputs, the system under test, and the closed loop that drives it.

Each unit is one keyframe bundle of one agent, in turn: the server
worker's own calls, ``AgentSession.ingest_many(bundle)`` and then that
session's ``drain_placerec()``, the device synchronised at the unit's end.
A keyframe's place recognition runs when its agent's next bundle arrives,
so a keyframe is resolved by the drain of its agent's next unit.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

from portbench.harness import vocab as vocab_mod
from portbench.harness import world as world_mod

PB = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict

    @property
    def mode(self) -> str:
        return self.config["config"].get("placerec_type", "COVINS")

    @property
    def n_agents(self) -> int:
        return len(self.config["agents"])


def load_cell(name: str, root: Path = PB) -> Cell:
    """The cell's files, found by name: workloads/<cell>.json names its
    configuration (configs/<name>.json) and its mix (mixes/<name>.json),
    whose parameters the cell's own ``params`` override."""
    wl = json.loads((root / "workloads" / f"{name}.json").read_text())
    cfg = json.loads((root / "configs" / f"{wl['config']}.json").read_text())
    mix = json.loads((root / "mixes" / f"{wl['mix']}.json").read_text())
    mix.update(wl.get("params", {}))
    return Cell(name, wl, cfg, mix)


def make_inputs(cell: Cell, seed: int, device):
    """The world, each agent's keyframe bundles and the vocabulary.  The
    scene (the landmarks and their appearance) and the vocabulary belong to
    the deployment and come from the configuration's ``world.seed``; the
    run's ``seed`` sets what its agents' front ends add: pixel noise,
    flipped descriptor bits and odometry drift."""
    from covins_tpu_torch.comm import messages as msgs

    cfg = cell.config
    w = cfg["world"]
    world = world_mod.World.create(w["seed"], w["landmarks"], w["desc_bytes"], cfg["camera"])
    streams = world_mod.build_streams(world, cfg["agents"], seed, cfg["frontend"], msgs)
    voc = vocab_mod.train(world.signatures, cfg["vocabulary"]["words"], w["seed"],
                          cfg["vocabulary"]["iters"], device)
    return world, streams, voc


def new_system(cell: Cell, voc, device):
    """A fresh MapManager (empty maps) and one session an agent, sharing
    one metrics registry."""
    from covins_tpu_torch.models.map_manager import MapManager
    from covins_tpu_torch.models.session import AgentSession
    from covins_tpu_torch.utils.config import Config
    from covins_tpu_torch.utils.metrics import Metrics

    cfg = Config(**cell.config["config"])
    mgr = MapManager(voc, cfg, device=device)
    metrics = Metrics()
    sessions = [AgentSession(cid, mgr, cfg, metrics=metrics) for cid in range(cell.n_agents)]
    return mgr, sessions, metrics


@dataclasses.dataclass
class Window:
    t_start: float
    t_end: float
    units: int = 0
    delivered: dict = dataclasses.field(default_factory=dict)  # kf id -> ingest start
    resolved: list = dataclasses.field(default_factory=list)  # (kf id, drain end)
    queued: list = dataclasses.field(default_factory=list)  # (kf id, retrieval data)
    t_last: float = 0.0

    def inside(self):
        """(kf id, latency s) of the keyframes resolved inside the window."""
        return [(k, t - self.delivered[k]) for k, t in self.resolved if t <= self.t_end]


def drive(sessions, streams, sync, seconds=None, max_units=None, done=None, spans=None):
    """Units in turn until ``seconds`` have passed (no unit starts after),
    ``max_units`` have run, or ``done()`` holds.  A stream that runs out
    before then is a failure: the run does not end early."""
    n = len(sessions)
    cursors = [0] * n
    t0 = time.perf_counter()
    win = Window(t0, t0 + seconds if seconds is not None else float("inf"))
    while True:
        if time.perf_counter() >= win.t_end or (max_units is not None
                                                 and win.units >= max_units):
            break
        if done is not None and done():
            break
        a = win.units % n
        k = cursors[a]
        if k >= len(streams[a]):
            raise RuntimeError(f"agent {a}'s stream ran out after {k} keyframes "
                               f"({win.units} units): the window outran the deployment")
        bundle = streams[a][k]
        cursors[a] += 1
        win.units += 1
        s = sessions[a]
        t_in = time.perf_counter()
        win.delivered[(k, a)] = t_in
        if spans is not None:
            spans.open("ingest")
        s.ingest_many(bundle)
        if spans is not None:
            sync()
            spans.close()
        items = list(s._pr_queue)
        if spans is not None:
            spans.open("drain")
        s.drain_placerec()
        sync()
        if spans is not None:
            spans.close()
        t_out = time.perf_counter()
        win.queued.extend(items)
        win.resolved.extend((tuple(int(x) for x in kid), t_out) for kid, _ in items)
        win.t_last = t_out
    return win
