"""Collaborative-ATE artifact: loops + merges must actually fire, on the
PyTorch port (the counterpart of `scripts/run_collab_ate.py`, driving
`python -m covins_tpu_torch`; the servers and the ATE run on the CUDA
card unless `--device cpu` is given, the EuRoC agents need OpenCV).

The reference's headline claim is that the collaborative estimate beats
each agent's odometry (`readme.md:53-55`; protocol
`docs/run_COVINS.md:106-115`).  This script builds a loop-feasible
3-agent fake-EuRoC workload — one SHARED rendered landmark world, phase-
shifted trajectories on the same periodic curve, enough keyframes to
clear the loop-candidate exclusion radius — and measures ATE twice:

  * baseline: place recognition OFF (odometry drift accumulates);
  * collaborative: place recognition ON (+ VI-GBA), maps merge and
    loops correct the drift.

Writes one JSON report with per-agent ATE for both runs plus the
loop/merge counters, e.g.:

  python scripts/port_collab_ate.py --out output/collab_port --json output/collab_port.json
"""

import argparse
import json
import os
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

SEQ_NAMES = ["MH_01", "MH_02", "MH_03"]


def make_sequences(base: str, n_kf: int, seed: int = 0):
    """Render the 3 sequences over ONE shared landmark world.

    Agents start phase-shifted on the same periodic trajectory
    (`utils/synthetic._position`, period 4 s), so every agent re-visits
    regions the others mapped — the precondition for inter-agent loops
    and merges.  The world is sampled along the union timeline so late
    laps (higher z, the trajectory climbs) are textured too."""
    from covins_tpu_torch.utils import fake_euroc

    # kf_dt 0.1 keeps inter-frame baselines ~0.8 m so ORB descriptors
    # survive between views (at 0.5 s the ~4 m baselines starve the
    # front-end's epipolar minting and verification gates go unreachable)
    kf_dt = 0.1
    t0s = [0.0, 1.0, 2.0]
    span = max(t0s) + n_kf * kf_dt
    world = fake_euroc.sample_world(
        n_anchors=int(span / kf_dt) + 1, kf_dt=kf_dt,
        n_landmarks=24 * n_kf, seed=seed,
    )
    seqs = []
    for name, t0 in zip(SEQ_NAMES, t0s):
        d = os.path.join(base, name)
        if not os.path.exists(os.path.join(
                d, "mav0", "state_groundtruth_estimate0", "data.csv")):
            print(f"[collab-ate] rendering {name} (t0={t0})", flush=True)
            fake_euroc.write_fake_sequence(
                d, n_keyframes=n_kf, kf_dt=kf_dt, t0=t0, seed=seed,
                world=world)
        seqs.append(d)
    return seqs


def gt_tum(seq_dir: str, out_path: str) -> str:
    import csv

    gt = os.path.join(seq_dir, "mav0", "state_groundtruth_estimate0",
                      "data.csv")
    with open(gt) as f, open(out_path, "w") as o:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            t = float(row[0]) * 1e-9
            x, y, z = row[1:4]
            qw, qx, qy, qz = row[4:8]
            o.write(f"{t} {x} {y} {z} {qx} {qy} {qz} {qw}\n")
    return out_path


CLI = [sys.executable, "-m", "covins_tpu_torch"]


def run_once(seqs, out, port, drift, placerec_on, min_loop_dist, env,
             gba_budget, device):
    os.makedirs(out, exist_ok=True)
    dev = ["--device", device] if device else []
    server_cmd = CLI + ["server", "--port", str(port), "--output-dir", out,
                        "--min-loop-dist", str(min_loop_dist)] + dev
    if not placerec_on:
        server_cmd.append("--placerec-off")
    server_log = open(os.path.join(out, "server.log"), "w")
    server = subprocess.Popen(server_cmd, cwd=_REPO, env=env,
                              stdout=server_log, stderr=subprocess.STDOUT)
    try:
        logp = os.path.join(out, "server.log")
        deadline = time.time() + 180
        while time.time() < deadline:
            if os.path.exists(logp) and "listening" in open(logp).read():
                break
            time.sleep(0.5)
        else:
            raise RuntimeError("server did not come up")

        agents = []
        for seq in seqs:
            log = open(os.path.join(
                out, f"agent_{os.path.basename(seq)}.log"), "w")
            agents.append(subprocess.Popen(
                CLI + ["agent",
                       "--port", str(port), "--euroc", seq,
                       "--keyframes", "100000",   # no cap: keyframing decides
                       "--drift", str(drift)],
                cwd=_REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
        rc = [a.wait() for a in agents]
        if any(rc):
            raise RuntimeError(f"agents failed: {rc}")

        def admin(*verb_args):
            return subprocess.run(
                CLI + ["admin", *verb_args, "--port", str(port)],
                cwd=_REPO, env=env, capture_output=True, text=True,
                timeout=3600).stdout

        def eval_ate():
            ate = {}
            for cid, seq in enumerate(seqs):
                est = os.path.join(out, f"KF_{cid}_ftum.csv")
                if not os.path.exists(est):
                    ate[os.path.basename(seq)] = {"error": "no trajectory"}
                    continue
                gt = gt_tum(seq, os.path.join(out, f"gt_{cid}.txt"))
                got = subprocess.run(
                    CLI + ["ate", "--est", est, "--gt", gt] + dev,
                    cwd=_REPO, env=env, capture_output=True,
                    text=True).stdout
                ate[os.path.basename(seq)] = json.loads(got)
            return ate

        report = {}
        # barrier: agents' finish work (drain + trajectory write) queues
        # in the server worker; a stats round-trip serializes behind it
        admin("stats")
        # ATE right after the agents finish: loop corrections + PGO only
        report["ate"] = eval_ate()
        if placerec_on:
            stats = json.loads(admin("stats")).get("result", {})
            for mid in stats.get("maps", {}):
                # snapshot the merged pre-GBA map for offline analysis
                admin("savemap", "--map-id", str(mid), "--path",
                      os.path.join(out, f"map_pre_gba_{mid}.npz"))
                report[f"gba_map_{mid}"] = json.loads(admin(
                    "gba", "--map-id", str(mid),
                    "--time-budget", str(gba_budget)))
            # GBA rewrote the trajectories; evaluate again
            report["ate_post_gba"] = eval_ate()
        report["stats"] = json.loads(admin("stats")).get("result", {})
        return report
    finally:
        server.terminate()
        server.wait(timeout=60)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="output/collab_ate")
    ap.add_argument("--json", default=None,
                    help="also write the report to this path")
    ap.add_argument("--keyframes", type=int, default=128)
    ap.add_argument("--drift", type=float, default=0.01)
    # trajectory lap = 40 keyframes at kf_dt 0.1; same-agent candidates
    # must be at least a lap old (scaled from the reference's 100 for
    # full-length EuRoC sequences, VERDICT r04 #3)
    ap.add_argument("--min-loop-dist", type=int, default=48)
    ap.add_argument("--gba-budget", type=float, default=180.0)
    ap.add_argument("--port", type=int, default=9941)
    ap.add_argument("--device", default=None,
                    help="torch device of the servers and the ATE (default: "
                         "the CUDA card)")
    args = ap.parse_args()

    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO

    seqs = make_sequences(os.path.join(args.out, "seqs"), args.keyframes)

    print("[collab-ate] baseline run (placerec OFF)", flush=True)
    base = run_once(seqs, os.path.join(args.out, "baseline"), args.port,
                    args.drift, False, args.min_loop_dist, env,
                    args.gba_budget, args.device)
    print("[collab-ate] collaborative run (placerec ON + GBA)", flush=True)
    collab = run_once(seqs, os.path.join(args.out, "collab"), args.port + 1,
                      args.drift, True, args.min_loop_dist, env,
                      args.gba_budget, args.device)

    def mean_ate(ate):
        vals = [v.get("ate_rmse") for v in ate.values() if "ate_rmse" in v]
        return sum(vals) / len(vals) if vals else None

    report = {
        "workload": (
            f"fake-EuRoC 3-agent shared-world collaborative run, "
            f"{args.keyframes} KF/agent, odometry drift {args.drift}/KF, "
            f"min_loop_dist {args.min_loop_dist} (loop-feasible sizing); "
            f"the PyTorch port on {args.device or 'the CUDA card'}"),
        "ate_without_placerec": base["ate"],
        "ate_with_placerec": collab["ate"],
        "ate_post_gba": collab.get("ate_post_gba", {}),
        "ate_mean_without": mean_ate(base["ate"]),
        "ate_mean_with": mean_ate(collab["ate"]),
        "ate_mean_post_gba": mean_ate(collab.get("ate_post_gba", {})),
        "n_loops": collab["stats"].get("n_loops", 0),
        "n_merges": collab["stats"].get("n_merges", 0),
        "stats_collab": collab["stats"],
        "gba": {k: v for k, v in collab.items() if k.startswith("gba_")},
    }
    print(json.dumps(report, indent=2))
    path = os.path.join(args.out, "collab_ate_report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    print(f"[collab-ate] report -> {path}")


if __name__ == "__main__":
    main()
