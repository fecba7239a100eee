"""Hand-written CUDA C++ kernels for Hopper (sm_90a) and their build.

The sources are compiled with nvcc into one shared library at first
use (see build.py) and called through a plain C interface."""
