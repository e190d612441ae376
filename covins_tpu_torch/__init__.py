"""covins_tpu_torch: the collaborative VI-SLAM back-end in PyTorch and CUDA.

A port of the JAX package `covins_tpu` for one NVIDIA H100.  It mirrors that
package's module names, imports neither JAX nor `covins_tpu`, and runs on
the CUDA card unless an entry point is given ``device="cpu"``.  The
hand-written kernels live in `csrc/` and are built on first use
(`cuda_build.py`).

Ported so far: keyframe ingest with the batched landmark-attribute refresh
and the batched BoW insert + score into the device-resident retrieval
database (`models/session.py` with ``placerec_active=False``).
"""

from covins_tpu_torch import device  # noqa: F401  (sets the TF32 policy)
