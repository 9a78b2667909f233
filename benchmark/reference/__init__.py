"""The plain reference that decides ``correct``: float32 PyTorch, NumPy and
SciPy, written from the published description of the networks (Baur et
al., arXiv:2004.03271) and of the serving pipeline.  It imports neither
JAX, nor the JAX package, nor anything of the port, and takes nothing the
port made: the harness hands it the same weights, data and random streams
it hands the port.

``precision="fp8"`` computes every convolution and dense product from
operands rounded to float8 e4m3 with a per-tensor scale (accumulating in
float32): the control, one step below the configurations' bfloat16.
"""
