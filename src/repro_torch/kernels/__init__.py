"""Fused population evaluation + fitness: the hand-written CUDA kernel
(`gp_eval`), its public wrappers (`ops`) and the plain oracle (`ref`)."""
