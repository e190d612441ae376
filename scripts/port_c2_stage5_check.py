#!/usr/bin/env python3
"""Does loop-verification stage 5 of the PyTorch port match landmarks where
the JAX package's stage 5 does?  (ROADMAP item C2.)

Runs the port's main path on the CPU (plain versions) at the bench workload
of ``chip_smoke.py`` phase 2 (2 agents x 128 keyframes over 2000 landmarks,
1024-message windows, the default ``Config()`` with deferred place
recognition) and records, for every stage-5 call of the drain, stage 3's
match count and stage 5's own match count (``hfeat >= 0``).  The inputs of
up to ``--keep`` calls whose stage 3 matched (the calls with the most stage-3
matches first) are kept as numpy arrays and handed to the JAX package's
``_covins_stage5_body`` (``covins_tpu/ops/loopverify.py``) on the CPU in
float64; the script prints, per kept call, both packages' match counts and
whether their per-landmark results ``hfeat`` are equal, then one summary
line.

    env JAX_PLATFORMS=cpu python scripts/port_c2_stage5_check.py [--keep 8]

The vocabulary is trained on the CPU from the seed (on the card the smoke
trains it with the card's generator, so the drain's candidates differ from
the card's).  Takes a few minutes; imports both packages, so it runs where
JAX is installed.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from covins_tpu.ops import loopverify as ref_lv  # noqa: E402
from covins_tpu.utils import cameras as ref_cam  # noqa: E402
from covins_tpu_torch.ops import bow, loopverify  # noqa: E402

# the positional arguments of covins_stage5 after the camera, in order
ARGS5 = ("T_12", "T_wc_sc", "ok14", "n_base", "pair_crow", "taken_q5", "hood_lm_w",
         "hood_desc", "hood_normal", "hood_rng", "hood_alive", "hood_lm_row", "kp_uv",
         "kp_desc", "kp_oct", "kp_valid")
STATIC5 = ("desc_max_dist", "radius_proj", "img_w", "img_h", "total_matches_thres")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--keep", type=int, default=8,
                    help="stage-5 calls whose inputs go to the reference")
    args = ap.parse_args()
    torch.set_num_threads(cs.CPU_THREADS)
    t0 = time.perf_counter()
    world, streams = cs.build_streams(2, 128, 2000)
    windows = cs.make_windows(streams)
    gen = torch.Generator().manual_seed(cs.SEED)
    vocab = bow.train_vocabulary(torch.from_numpy(world.lm_descs), k=512, iters=4,
                                 generator=gen).numpy()

    calls, kept = [], []
    stage14, stage5 = loopverify.covins_stage14, loopverify.covins_stage5
    last14 = {}

    def rec14(*a, **kw):
        out = stage14(*a, **kw)
        last14.update(n_ext=int(out["n_ext"]), n_matched=int(out["n_matched"]),
                      ok14=bool(out["ok14"]))
        return out

    def rec5(cam, *a, **kw):
        out = stage5(cam, *a, **kw)
        x = dict(zip(ARGS5, a))
        row = {**last14, "port_stage5_matches": int((out["hfeat"] >= 0).sum()),
               "hood": int(x["hood_lm_w"].shape[0]),
               # what stage 5 may still match: unpaired live landmarks, free features
               "hood_unpaired": int((x["hood_alive"]
                                     & ~torch.isin(x["hood_lm_row"], x["pair_crow"])).sum()),
               "features_free": int((x["kp_valid"] & ~x["taken_q5"]).sum())}
        calls.append(row)
        if row["n_ext"] > 0:
            inputs = {k: v.numpy().copy() for k, v in x.items()}
            kept.append((row, cam, inputs, dict(kw), out["hfeat"].numpy().copy()))
            kept.sort(key=lambda k: -k[0]["n_ext"])
            del kept[args.keep:]
        return out

    loopverify.covins_stage14, loopverify.covins_stage5 = rec14, rec5
    try:
        run = cs.run_slice(vocab, windows, 2, "cpu")
    finally:
        loopverify.covins_stage14, loopverify.covins_stage5 = stage14, stage5
    out = cs.outcome(run)
    t_drain = time.perf_counter() - t0

    ref_body = jax.jit(ref_lv._covins_stage5_body, static_argnames=STATIC5)
    rows = []
    for row, cam, inputs, kw, hfeat_port in kept:
        rcam = ref_cam.Camera(jnp.asarray(cam.intrinsics.numpy()),
                              jnp.asarray(cam.dist.numpy()),
                              jnp.asarray(cam.T_s_c.numpy()), cam.cam_model,
                              cam.dist_model)
        res = ref_body(rcam, *(jnp.asarray(inputs[k]) for k in ARGS5), **kw)
        hfeat_ref = np.asarray(res["hfeat"])
        rows.append({**row, "reference_stage5_matches": int((hfeat_ref >= 0).sum()),
                     "hfeat_equal": bool(np.array_equal(hfeat_ref, hfeat_port)),
                     "reference_ok": bool(res["ok"])})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({
        "candidates": out["candidates"], "loops": out["loops"], "merges": out["merges"],
        "stage5_calls": len(calls),
        "stage5_calls_stage3_matched": sum(c["n_ext"] > 0 for c in calls),
        "stage5_calls_ok14": sum(c["ok14"] for c in calls),
        "port_stage5_calls_with_matches": sum(c["port_stage5_matches"] > 0 for c in calls),
        "port_stage5_matches_total": sum(c["port_stage5_matches"] for c in calls),
        "hood_unpaired_max": max((c["hood_unpaired"] for c in calls), default=0),
        "features_free_max": max((c["features_free"] for c in calls), default=0),
        "kept": len(rows),
        "kept_reference_matches_total": sum(r["reference_stage5_matches"] for r in rows),
        "kept_port_matches_total": sum(r["port_stage5_matches"] for r in rows),
        "kept_hfeat_equal": sum(r["hfeat_equal"] for r in rows),
        "drain_pass_s": t_drain}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
