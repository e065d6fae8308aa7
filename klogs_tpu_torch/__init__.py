"""klogs_tpu_torch: the PyTorch/CUDA port of klogs-tpu's device half.

A package of its own beside ``klogs_tpu``: it imports torch and numpy,
never jax and nothing of ``klogs_tpu``. The layout mirrors the JAX
package so each module's counterpart is found by name; the NFA kernels
the JAX package wrote in Pallas are CUDA C++ for Hopper
(``ops/csrc/nfa_kernels.cu``).
"""
