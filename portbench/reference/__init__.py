"""The plain reference that decides `correct`: PyTorch and numpy only.

It imports neither JAX, nor the JAX package, nor anything of the program,
and takes nothing the program made but the outputs it judges and, where a
stage can only be followed step by step, the inputs the program gathered
for it (`PERF.md` names each such stage and what checks its start).
"""
