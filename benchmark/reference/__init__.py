"""The benchmark's plain reference: NeuS and VolSDF in plain float32 PyTorch.

A frozen rewrite of the mathematics the program computes: the surface MLP
with its nablas and the eikonal double backward by autograd (`nets.py`), the
NeuS upsampler, render and loss (`neus.py`), the VolSDF error-bounded
sampler, render and loss (`volsdf.py`), the ray batch, the draws, Adam and
the schedules (`step.py`). It imports torch and numpy alone: nothing of the
program, and neither `jax` nor the JAX package. It takes the benchmark's own
weights, scene and generator states, never what the program derived from
them.

`tf32=True` rounds both operands of every matrix product to TF32 (in the
forward, the backward and the double backward) and accumulates in float32:
the reference computed one precision below the configuration's, which is
the control that the comparison has to fail.
"""
