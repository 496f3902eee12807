"""Hand-written CUDA kernels of the port and their wrappers.

csrc/ holds the CUDA C++ sources, built for sm_90a at first use by
_build.py; each wrapper module launches one kernel and keeps its launch
count; ops.py holds the public ops (padding, dispatch by device); ref.py
the plain PyTorch versions.
"""
