"""Hand-written Hopper kernels (CUDA C++ for sm_90a), one subpackage per
JAX Pallas kernel family: ``ref.py`` holds the plain PyTorch version,
``csrc/`` the CUDA source, ``ops.py`` the checked wrapper with its launch
counters.  ``_build.py`` compiles the sources with nvcc at first use."""
