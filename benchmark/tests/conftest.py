"""CPU tests of the benchmark.  They import no JAX, so they run where JAX
is not installed too:

    python -m pytest benchmark/tests -q

One intra-op thread per process: small CPU convolutions slow down several
fold when workers oversubscribe the cores."""

import torch

torch.set_num_threads(1)
