"""How far rounding alone moves the relative-pose refinement of
`tests/test_torch_loopverify.py::test_relative_pose_refinement_matches_reference`:
the evidence for that test's bound.

1. The port's `ops/relpose.optimize_relative_pose` on the test's inputs,
   once per ATen CPU kernel set (``ATEN_CPU_CAPABILITY=default``, ``avx2``,
   ``avx512``; each in its own process, since ATen reads the variable at
   start-up): the spread of the refined pose, and each one's distance to
   the JAX package's result.
2. The JAX package's own result when ``T0`` or ``p1`` moves by one ulp
   (each element once up and once down, ``np.nextafter``): how far the
   reference itself moves under a change of its inputs at the last bit.

Usage: python scripts/port_relpose_spread.py  (about a minute, CPU; needs
the JAX package, which the test's reference side uses)
"""

import json
import os
import subprocess
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPABILITIES = ("default", "avx2", "avx512")


def inputs():
    """The test's inputs, made exactly as the test makes them."""
    rng = np.random.default_rng(11)
    intr = np.asarray([458.654, 457.296, 367.215, 248.375, 0.0])
    dist = np.asarray([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])
    T_s_c = np.asarray([0.99, 0.05, -0.1, 0.02, 0.05, -0.02, 0.01])
    T_s_c[:4] /= np.linalg.norm(T_s_c[:4])
    T_true = np.asarray([0.98, 0.02, 0.15, -0.05, 0.3, -0.1, 0.2])
    T_true[:4] /= np.linalg.norm(T_true[:4])
    n = 200
    p2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(3, 8, n)], 1)
    return rng, intr, dist, T_s_c, T_true, p2


def reference_side():
    """(camera, T0, p1, p2, mask) with p1 from the JAX package's pose_apply,
    as in the test."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from covins_tpu.utils import cameras as ref_cam
    from covins_tpu.utils import geometry as ref_geo

    rng, intr, dist, T_s_c, T_true, p2 = inputs()
    p1 = np.asarray(ref_geo.pose_apply(jnp.asarray(T_true), jnp.asarray(p2)))
    p1 = p1 + 0.01 * rng.normal(size=p1.shape)
    p1[:20] += rng.normal(size=(20, 3))
    mask = rng.random(len(p2)) > 0.1
    T0 = T_true + np.concatenate([0.02 * rng.normal(size=4), 0.05 * rng.normal(size=3)])
    T0[:4] /= np.linalg.norm(T0[:4])
    rc = ref_cam.Camera(jnp.asarray(intr), jnp.asarray(dist), jnp.asarray(T_s_c),
                        ref_cam.PINHOLE, ref_cam.RADTAN)
    return rc, T0, p1, p2, mask, (intr, dist, T_s_c)


def port_once(path):
    """Child process: the port's refinement on the inputs in ``path``."""
    import torch

    sys.path.insert(0, _REPO)
    from covins_tpu_torch.ops import relpose
    from covins_tpu_torch.utils import cameras as cam

    torch.set_num_threads(1)
    z = np.load(path)
    pc = cam.Camera(torch.tensor(z["intr"]), torch.tensor(z["dist"]),
                    torch.tensor(z["T_s_c"]), cam.PINHOLE, cam.RADTAN)
    T, inl, nn = relpose.optimize_relative_pose(
        pc, pc, torch.tensor(z["T0"]), torch.tensor(z["p1"]), torch.tensor(z["p2"]),
        torch.tensor(z["mask"]), th_outlier=1.3)
    print(json.dumps({"capability": torch.backends.cpu.get_cpu_capability(),
                      "T": T.numpy().tolist(), "n": int(nn),
                      "inliers": inl.numpy().astype(int).tolist()}))


def main():
    import jax.numpy as jnp

    from covins_tpu.ops import relpose as ref_relpose

    rc, T0, p1, p2, mask, (intr, dist, T_s_c) = reference_side()

    def ref(T0_, p1_):
        rT, rinl, rn = ref_relpose.optimize_relative_pose(
            rc, rc, jnp.asarray(T0_), jnp.asarray(p1_), jnp.asarray(p2),
            jnp.asarray(mask), th_outlier=1.3)
        return np.asarray(rT), np.asarray(rinl), int(rn)

    rT, rinl, rn = ref(T0, p1)
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), "relpose_inputs.npz")
    np.savez(path, intr=intr, dist=dist, T_s_c=T_s_c, T0=T0, p1=p1, p2=p2, mask=mask)
    port = {}
    for cap in CAPABILITIES:
        env = dict(os.environ, ATEN_CPU_CAPABILITY=cap)
        out = subprocess.run([sys.executable, __file__, "--port", path], env=env,
                             capture_output=True, text=True, check=True)
        row = json.loads(out.stdout.strip().splitlines()[-1])
        port[cap] = row
    Ts = np.asarray([port[c]["T"] for c in CAPABILITIES])
    spread = float(np.abs(Ts[:, None] - Ts[None]).max())
    to_ref = {c: float(np.abs(np.asarray(port[c]["T"]) - rT).max()) for c in CAPABILITIES}
    same_inliers = all(port[c]["n"] == rn and
                       np.array_equal(np.asarray(port[c]["inliers"], bool), rinl)
                       for c in CAPABILITIES)
    print(json.dumps({"port_by_capability": {c: port[c]["capability"] for c in CAPABILITIES},
                      "port_spread": spread, "port_to_reference": to_ref,
                      "same_inliers_as_reference": same_inliers}))

    moved = {"T0": 0.0, "p1": 0.0}
    flips = 0
    for name in moved:
        base = T0 if name == "T0" else p1
        for direction in (np.inf, -np.inf):
            pert = np.nextafter(base, direction)
            T0_, p1_ = (pert, p1) if name == "T0" else (T0, pert)
            pT, pinl, pn = ref(T0_, p1_)
            moved[name] = max(moved[name], float(np.abs(pT - rT).max()))
            flips += int(pn != rn or not np.array_equal(pinl, rinl))
    print(json.dumps({"reference_moved_by_1ulp": moved,
                      "reference_inlier_changes": flips}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--port":
        port_once(sys.argv[2])
    else:
        sys.path.insert(0, _REPO)
        main()
