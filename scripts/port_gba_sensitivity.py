"""How far rounding alone moves the JAX package's GBA: the evidence for the
bounds of `tests/test_torch_gba.py`.

For each comparison the test makes, the reference runs once on the test's
inputs and again with an input moved by one ulp (``np.nextafter`` up and
down: the keyframe poses, the landmark positions, the observed pixels;
for `run_gba`, the map's keyframe poses and landmark positions).  Printed
per scenario: the largest change of any state (poses, velocities, biases, landmarks: max abs), of the costs
(relative to the largest cost), whether a discrete outcome changed (the
damping, which encodes the step ladder's choice and the accept flag; the
pruned count), and the port's distance to the unperturbed reference on the
same inputs.

Usage: python scripts/port_gba_sensitivity.py  (a few minutes, CPU; needs
the JAX package)
"""

import dataclasses
import json
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _states(p):
    return [np.asarray(getattr(p, k)) for k in ("poses", "vels", "biases", "lms")]


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(1)
    import test_torch_gba as T
    from covins_tpu.ops import gba as ref_gba
    from covins_tpu_torch.ops import gba

    rp, p = T.problems.__wrapped__()
    perturbed = [dataclasses.replace(rp, **{name: jnp.asarray(np.nextafter(
        np.asarray(getattr(rp, name)), d))})
        for name in ("poses", "lms", "obs_uv") for d in (np.inf, -np.inf)]

    for variant in ("fused", "classic"):
        step = jax.jit(lambda q, st, lam: ref_gba._gn_schur_step(
            q, st, lam, 60, False, cg_variant=variant))

        def run(q):
            s, lam, c = step(q, (q.poses, q.vels, q.biases, q.lms), jnp.asarray(1e-4))
            return [np.asarray(x) for x in s], float(lam), float(c)

        s0, lam0, c0 = run(rp)
        d_state = d_cost = 0.0
        lam_changed = False
        for q in perturbed:
            s1, lam1, c1 = run(q)
            d_state = max(d_state, max(float(np.abs(a - b).max()) for a, b in zip(s0, s1)))
            d_cost = max(d_cost, abs(c1 - c0) / abs(c0))
            lam_changed |= lam1 != lam0
        ps, plam, pc = gba._gn_schur_step(
            p, gba.obs_graph(p), (p.poses, p.vels, p.biases, p.lms),
            torch.tensor(1e-4, dtype=torch.float64), 60, False, cg_variant=variant)
        print(json.dumps({
            "scenario": f"step_{variant}", "ref_state_spread": d_state,
            "ref_cost_spread": d_cost, "ref_lam_changed": lam_changed,
            "port_state_diff": max(float(np.abs(a.numpy() - b).max()) for a, b in zip(ps, s0)),
            "port_cost_diff": abs(float(pc) - c0) / abs(c0),
            "port_same_lam": float(plam) == lam0}))

    for scenario in ("outliers", "no_outliers", "visual_only"):
        kw = dict(n_gn=4, n_cg=30, outlier_removal=scenario == "outliers",
                  visual_only=scenario == "visual_only")
        r0, i0 = ref_gba.global_bundle_adjustment(rp, **kw)
        d_state = d_cost = 0.0
        pruned_changed = False
        for q in perturbed:
            r1, i1 = ref_gba.global_bundle_adjustment(q, **kw)
            d_state = max(d_state, max(float(np.abs(a - b).max())
                                       for a, b in zip(_states(r0), _states(r1))))
            d_cost = max(d_cost, _rel(i1["costs"], i0["costs"]))
            pruned_changed |= i1.get("n_pruned") != i0.get("n_pruned")
        p2, info = gba.global_bundle_adjustment(p, **kw)
        print(json.dumps({
            "scenario": scenario, "ref_state_spread": d_state, "ref_cost_spread": d_cost,
            "ref_pruned_changed": pruned_changed,
            "port_state_diff": max(float(np.abs(a.numpy() - b).max()) for a, b in zip(
                (p2.poses, p2.vels, p2.biases, p2.lms), _states(r0))),
            "port_cost_diff": _rel(info["costs"].numpy(), i0["costs"]),
            "port_same_pruned": info.get("n_pruned") == i0.get("n_pruned")}))

    # run_gba on the test's two-agent merged session, from the reference
    # map's state
    world, vocab = T.world_vocab.__wrapped__()
    from covins_tpu.agents.synthetic_agent import SyntheticAgent
    agents = [SyntheticAgent(world, client_id=0, n_keyframes=16),
              SyntheticAgent(world, client_id=1, n_keyframes=16, t0=1.0)]
    streams = [list(a.messages()) for a in agents]

    def ref_run(name, direction):
        mgr = T._ingest(streams, vocab, True, **T.CFG)
        mid = mgr.map_of_client[0]
        mp = mgr.maps[mid]
        if name is not None:
            getattr(mp, name)[...] = np.nextafter(getattr(mp, name), direction)
        info = mgr.run_gba(mid)
        return mp, np.asarray(info["costs"]), info["n_pruned"]

    m0, c0, n0 = ref_run(None, None)
    names = ("kf_pose", "kf_vel", "kf_bias", "lm_pos")
    d_state = d_cost = 0.0
    pruned_changed = False
    for name, d in [(k, d) for k in ("kf_pose", "lm_pos") for d in (np.inf, -np.inf)]:
        m1, c1, n1 = ref_run(name, d)
        d_state = max(d_state, max(float(np.abs(getattr(m0, k) - getattr(m1, k)).max())
                                   for k in names))
        d_cost = max(d_cost, _rel(c1, c0))
        pruned_changed |= n1 != n0
    print(json.dumps({"scenario": "run_gba", "ref_state_spread": d_state,
                      "ref_cost_spread": d_cost, "ref_pruned_changed": pruned_changed,
                      "n_pruned": int(n0)}))


if __name__ == "__main__":
    main()
