"""Native (C++) runtime components, loaded via ctypes when built.

The reference's host runtime (file parsing, replication, timers) is C/CUDA
(``src/helper.cu``, ``include/timer.h``); these are this build's native
equivalents.  Build with ``python -m cuda_matrix_inversion_tpu.native.build``;
every consumer has a pure-Python fallback so an unbuilt tree still works.
"""
