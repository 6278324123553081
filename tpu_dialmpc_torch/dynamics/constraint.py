"""Soft-constraint constants (MuJoCo's mjMINVAL / mjMINIMP / mjMAXIMP).

The same values as `tpu_dialmpc/dynamics/constraint.py`; the constraint rows
themselves are built inside the fused substep (`fused.py`).
"""

MJ_MINVAL = 1e-15
MJ_MINIMP = 0.0001
MJ_MAXIMP = 0.9999
