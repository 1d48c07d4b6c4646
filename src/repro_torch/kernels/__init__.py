"""Kernel subsystem of the port.

* ``template`` — the fused MC kernel's dispatcher (:func:`fused_mc`), its
  CUDA wrapper and its plain PyTorch version, launch counters.
* ``registry`` — kernel forms with capability metadata and form ids.
* ``mc_eval`` — the five eval bodies and packers, the plain oracle, and
  ``multi``: one launch per dim bucket for a whole spec.
* ``build`` — compiles ``csrc/*.cu`` with nvcc at first use and loads the
  libraries with ctypes.
"""
