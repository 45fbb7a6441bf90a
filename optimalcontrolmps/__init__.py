"""Quantum optimal control of MPS dynamics in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
fskovbo/OptimalControlMPS (GRAPE/GROUP optimal control of Bose-Hubbard
superfluid->Mott ramps with TEBD time evolution), redesigned for an
accelerator: fixed-rank padded MPS, scan/vmap-batched propagation, adjoint derivatives,
vmapped Hessian rows, and mesh-sharded multistart optimization.
"""

__version__ = "0.1.0"
