"""Command-line interface: server, replay agents, admin verbs, evaluation.

Counterpart of `covins_tpu/cli.py` (which replaces the reference's
ROS-based surface: `rosrun covins_backend covins_backend_node`,
`rosservice call covins_{gba,savemap,loadmap,prunemap}` and the example
shell scripts under `orb_slam3/covins_examples/`) with the same
subcommands:

    python -m covins_tpu_torch server --port 9871 --vocab vocab.npz
    python -m covins_tpu_torch server --port 9871 --vocab ORBvoc.txt
    python -m covins_tpu_torch agent --keyframes 40 --port 9871
    python -m covins_tpu_torch agent --euroc MH_01/mav0 --port 9871
    python -m covins_tpu_torch frontend --stream run.cfs --port 9871
    python -m covins_tpu_torch admin gba --map-id 0 --port 9871
    python -m covins_tpu_torch ate --est output/KF_0_ftum.csv --gt gt.csv

``server`` and ``ate`` run on the CUDA card unless ``--device cpu`` is
given, and fail when no card is there; ``agent``, ``frontend`` and
``admin`` touch no tensors.  ``agent --euroc`` and a ``frontend`` stream
of images need OpenCV on the agent's host (imported there, lazily).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

def _load_or_make_vocab(args, device) -> np.ndarray:
    if args.vocab:
        if args.vocab.endswith(".txt"):
            # DBoW2 ORBvoc.txt (backend.cpp:411-429): import the official
            # tree and flatten it for the dense retrieval pipeline
            from covins_tpu_torch.ops.dbow_import import load_orb_vocabulary_text
            voc = load_orb_vocabulary_text(args.vocab)
            vocab, _ = voc.flatten(max_words=max(args.vocab_words, 1024))
            print(f"[covins-server] imported DBoW2 vocabulary "
                  f"k={voc.k} L={voc.L} words={voc.n_words} "
                  f"-> flat {len(vocab)}", flush=True)
            return vocab
        z = np.load(args.vocab)
        return z["vocab"] if "vocab" in z else z[z.files[0]]
    # deterministic default: Hamming k-medians on a seeded synthetic world's
    # descriptors, with a seeded torch.Generator on the server's device (the
    # JAX package's default draws its centres with threefry, so the two
    # defaults differ)
    import torch

    from covins_tpu_torch.agents.synthetic_agent import SyntheticWorld
    from covins_tpu_torch.ops import bow as bow_ops

    world = SyntheticWorld.create(n_landmarks=1000, seed=0)
    gen = torch.Generator(device=device).manual_seed(0)
    return bow_ops.train_vocabulary(torch.from_numpy(world.lm_descs).to(device),
                                    k=args.vocab_words, iters=4,
                                    generator=gen).cpu().numpy()


def _device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return f"{device} {torch.cuda.get_device_name(device)}"
    return str(device)


def cmd_server(args):
    from covins_tpu_torch.comm.server import CovinsServer
    from covins_tpu_torch.device import resolve_device
    from covins_tpu_torch.utils.config import Config

    device = resolve_device(args.device)
    cfg = (Config.from_yaml(*args.config) if args.config else Config())
    if args.placerec_type:
        cfg.placerec_type = args.placerec_type
    if args.sync_placerec:
        cfg.placerec_defer = False
    if args.placerec_off:
        cfg.placerec_active = False
    if args.min_loop_dist is not None:
        cfg.min_loop_dist = args.min_loop_dist
    elif not args.config:
        # server default: placerec defers to worker-idle windows (the
        # reference's dedicated thread); YAML `placerec.defer` overrides
        cfg.placerec_defer = True
    vocab = _load_or_make_vocab(args, device)
    server = CovinsServer(vocab, cfg, host=args.host, port=args.port,
                          output_dir=args.output_dir,
                          cereal_port=args.cereal_port, device=device)
    # on a card the server builds every kernel before it binds its socket:
    # the startup line goes out once it listens, as agents wait for it
    server.run(on_listening=lambda: print(
        f"[covins-server] listening on {args.host}:{args.port} "
        f"(placerec={cfg.placerec_type}, device={_device_name(device)})",
        flush=True))


def cmd_agent(args):
    from covins_tpu_torch.agents.synthetic_agent import SyntheticAgent, SyntheticWorld
    from covins_tpu_torch.comm.client import AgentClient

    client = AgentClient(args.host, args.port)
    print(f"[covins-agent] connected, client_id={client.client_id}", flush=True)
    if args.euroc:
        from covins_tpu_torch.agents.euroc_agent import EurocAgent
        agent = EurocAgent(args.euroc, client.client_id, max_keyframes=args.keyframes,
                           pose_drift=args.drift)
    else:
        world = SyntheticWorld.create(n_landmarks=args.landmarks, seed=args.world_seed)
        agent = SyntheticAgent(world, client.client_id, n_keyframes=args.keyframes,
                               t0=args.t0, pose_drift=args.drift,
                               send_updates=args.send_updates)
    n = 0
    for msg in agent.messages():
        client.send(msg)
        n += 1
    client.finish()
    print(f"[covins-agent] sent {n} messages, done", flush=True)


def cmd_frontend(args):
    from covins_tpu_torch.agents.frontend_adapter import run_stream

    n = run_stream(
        args.stream, args.host, args.port,
        kf_t_min=args.kf_t_min, kf_r_min=args.kf_r_min,
        n_features=args.features, n_features_add=args.features_add,
    )
    print(f"[covins-frontend] sent {n} keyframes from {args.stream}", flush=True)


def cmd_admin(args):
    from covins_tpu_torch.comm.client import AgentClient

    # admin verbs queue behind pending ingest work — allow a deep queue
    client = AgentClient(args.host, args.port, timeout=600.0)
    kw = {}
    if args.map_id is not None:
        kw["map_id"] = args.map_id
    if args.path:
        kw["path"] = args.path
    if args.max_num_kfs is not None:
        kw["max_num_kfs"] = args.max_num_kfs
    if args.visual_only:
        kw["visual_only"] = True
    if args.no_outlier_removal:
        kw["outlier_removal"] = False
    if args.time_budget is not None:
        kw["time_budget_s"] = args.time_budget
    if args.placerec_replay:
        kw["placerec_replay"] = True
        kw["run_pgo"] = not args.no_pgo
    reply = client.admin(args.verb, **kw)
    client.finish()
    print(json.dumps(reply, indent=2))


def cmd_ate(args):
    import torch

    from covins_tpu_torch.device import resolve_device
    from covins_tpu_torch.utils import geometry as geo

    device = resolve_device(args.device)

    def load_tum(path):
        with open(path) as fh:
            rows = [line.split() for line in fh if line.strip()]
        arr = np.asarray(rows, np.float64)
        return arr[:, 0], arr[:, 1:4]

    t_e, p_e = load_tum(args.est)
    t_g, p_g = load_tum(args.gt)
    # associate by closest timestamp (evaluate_ate_scale.py semantics)
    ig = np.searchsorted(t_g, t_e)
    ig = np.clip(ig, 0, len(t_g) - 1)
    ok = np.abs(t_g[ig] - t_e) < args.max_dt
    rmse, _ = geo.ate_rmse(torch.as_tensor(p_e[ok], device=device),
                           torch.as_tensor(p_g[ig][ok], device=device),
                           align_scale=not args.no_scale)
    print(json.dumps({"ate_rmse": float(rmse), "n_pairs": int(ok.sum())}))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="covins_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("server", help="run the back-end server")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=9871)
    s.add_argument("--device", default=None,
                   help="torch device of the maps and kernels (default: the "
                        "CUDA card; fails without one unless 'cpu' is given)")
    s.add_argument("--config", nargs="*", help="YAML config path(s)")
    s.add_argument("--vocab", help="vocabulary npz, or a DBoW2 text tree "
                                   "(ORBvoc.txt) flattened to at least 1024 "
                                   "words (default: trained at start from a "
                                   "seeded synthetic world on the device, "
                                   "with a torch generator: not the JAX "
                                   "package's default vocabulary)")
    s.add_argument("--vocab-words", type=int, default=512)
    s.add_argument("--output-dir", default="output")
    s.add_argument("--placerec-type", choices=["COVINS", "COVINS_G"])
    s.add_argument("--sync-placerec", action="store_true",
                   help="run place recognition inline with ingest instead "
                        "of deferred to worker-idle windows")
    s.add_argument("--placerec-off", action="store_true",
                   help="disable place recognition entirely "
                        "(`placerec.active: 0` — odometry-only baseline "
                        "for with/without-collaboration ATE comparisons)")
    s.add_argument("--min-loop-dist", type=int,
                   help="override placerec.min_loop_dist (candidate "
                        "exclusion radius in keyframe ids)")
    s.add_argument("--cereal-port", type=int, default=None,
                   help="also listen for REFERENCE-protocol agents "
                        "(cereal/TCP, communicator_base.cpp framing) on "
                        "this port — stock C++ front-ends attach here")
    s.set_defaults(fn=cmd_server)

    a = sub.add_parser("agent", help="run a replay agent")
    a.add_argument("--host", default="127.0.0.1")
    a.add_argument("--port", type=int, default=9871)
    a.add_argument("--synthetic", action="store_true", default=True)
    a.add_argument("--euroc", help="EuRoC sequence directory (mav0; needs OpenCV)")
    a.add_argument("--keyframes", type=int, default=40)
    a.add_argument("--landmarks", type=int, default=800)
    a.add_argument("--world-seed", type=int, default=0)
    a.add_argument("--t0", type=float, default=0.0)
    a.add_argument("--drift", type=float, default=0.0)
    a.add_argument("--send-updates", action="store_true",
                   help="re-send recent keyframes as pose/landmark updates "
                        "(comm.send_updates plane)")
    a.set_defaults(fn=cmd_agent)

    f = sub.add_parser(
        "frontend",
        help="attach a recorded front-end stream (CFS format — the "
             "covins_frontend generic-odometry attachment path)",
    )
    f.add_argument("--stream", required=True, help="CFS stream file")
    f.add_argument("--host", default="127.0.0.1")
    f.add_argument("--port", type=int, default=9871)
    f.add_argument("--kf-t-min", type=float, default=0.1,
                   help="keyframe translation threshold (m)")
    f.add_argument("--kf-r-min", type=float, default=0.1,
                   help="keyframe rotation threshold (rad)")
    f.add_argument("--features", type=int, default=500)
    f.add_argument("--features-add", type=int, default=1000)
    f.set_defaults(fn=cmd_frontend)

    d = sub.add_parser("admin", help="admin verbs (gba/pgo/savemap/loadmap/prunemap/stats/snapshot)")
    d.add_argument("verb", choices=["gba", "pgo", "savemap", "loadmap", "snapshot",
                                    "prunemap", "stats"])
    d.add_argument("--host", default="127.0.0.1")
    d.add_argument("--port", type=int, default=9871)
    d.add_argument("--map-id", type=int, default=None)
    d.add_argument("--path")
    d.add_argument("--max-num-kfs", type=int, default=None)
    d.add_argument("--visual-only", action="store_true")
    d.add_argument("--no-outlier-removal", action="store_true",
                   help="gba: skip the outlier round (CallbackGBA action "
                        "code, backend.cpp:128-176)")
    d.add_argument("--time-budget", type=float, default=None,
                   help="gba: solver wall-clock budget in seconds")
    d.add_argument("--placerec-replay", action="store_true",
                   help="loadmap: replay keyframes through place "
                        "recognition (backend.cpp:247-283)")
    d.add_argument("--no-pgo", action="store_true")
    d.set_defaults(fn=cmd_admin)

    e = sub.add_parser("ate", help="ATE RMSE of a TUM trajectory vs ground truth")
    e.add_argument("--est", required=True)
    e.add_argument("--gt", required=True)
    e.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    e.add_argument("--max-dt", type=float, default=0.05)
    e.add_argument("--no-scale", action="store_true")
    e.set_defaults(fn=cmd_ate)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
