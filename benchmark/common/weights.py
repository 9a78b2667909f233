"""Seeded weights, made on the device in one draw.

Every leaf the reference names gets its initial value: Glorot-uniform
kernels (bound sqrt(6 / (fan_in + fan_out)), fans over the receptive field
as ``torch.nn.init.xavier_uniform_`` takes them), zero biases, BatchNorm
at scale 1 and shift 0 with running statistics (0, 1).  All the kernels
come from one ``torch.rand`` call on a generator on the device, in
float32, the type the port keeps its parameters in.  The harness hands
the same tensors to the port (copied into its modules) and to the
reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str]


def glorot_bound(shape: Sequence[int]) -> float:
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    return math.sqrt(6.0 / (fan_in + fan_out))


def make(leaves: List[Leaf], seed: int, device: torch.device
         ) -> Dict[str, torch.Tensor]:
    """Initial values of ``leaves`` (name, shape, init) from ``seed``."""
    glorot = [(n, s) for n, s, init in leaves if init == "glorot"]
    sizes = [math.prod(s) for _, s in glorot]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    bounds = torch.repeat_interleave(
        torch.tensor([glorot_bound(s) for _, s in glorot], device=device,
                     dtype=torch.float32),
        torch.tensor(sizes, device=device, dtype=torch.int64))
    flat = (2.0 * flat - 1.0) * bounds
    out = {n: t.reshape(s) for (n, s), t in zip(glorot,
                                                flat.split(sizes))}
    for n, s, init in leaves:
        if init == "zeros":
            out[n] = torch.zeros(s, device=device)
        elif init == "ones":
            out[n] = torch.ones(s, device=device)
        elif init != "glorot":
            raise ValueError(f"unknown init {init!r} of {n}")
    return out


def initial(ref, cfg: Dict, seed: int, device: torch.device
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A configuration's initial parameters and BatchNorm statistics: the
    reference module's leaves made from ``seed``, with each kernel named
    under the file's ``assumed.kernel_scale`` scaled as it says."""
    p_leaves, b_leaves = ref.leaves(cfg)
    params = make(p_leaves, seed, device)
    for name, scale in cfg.get("assumed", {}).get("kernel_scale",
                                                  {}).items():
        params[name] = params[name] * float(scale)
    return params, make(b_leaves, seed, device)


def load_into(module: torch.nn.Module, values: Dict[str, torch.Tensor]
              ) -> None:
    """Copy ``values`` into the module's parameters and buffers of the same
    names; every parameter must be given."""
    state = module.state_dict()
    params = {n for n, _ in module.named_parameters()}
    missing = params - set(values)
    unknown = set(values) - set(state)
    if missing or unknown:
        raise KeyError(f"weights do not fit the model: missing "
                       f"{sorted(missing)}, unknown {sorted(unknown)}")
    with torch.no_grad():
        for n, v in values.items():
            state[n].copy_(v)
