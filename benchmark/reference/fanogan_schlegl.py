"""The ``fAnoGAN_schlegl`` preset (``mains/main_fAnoGAN_schlegl.py``):
Schlegl et al.'s f-AnoGAN (Medical Image Analysis 54, 2019) as Baur et al.
configure it, in plain float32 over explicit parameters.

  * Generator: ``gen_dense`` from the latent z to an (H / 8, W / 8, 8 dim)
    map (flattened in (h, w, c) order), the ResNet decoder
    (``reference/resnet.py``), tanh; NHWC out.
  * Critic: the ResNet encoder (``disc_features``) and ``disc_dense`` on
    each position of its (H / 8, W / 8, 8 dim) feature map, so a score map.
  * Encoder (izif): the unified encoder of Baur et al. with BatchNorm in
    training mode (``reference/backbone.py``), ``enc_dense`` from its
    (h, w, c)-flattened output to z, tanh.
  * WGAN-GP (Gulrajani et al.): the generator minimises -mean D(G(z)); the
    critic minimises mean D(G(z)) - mean D(x) + ``scale`` * mean((|dD/dx^|
    - 1)^2) at x^ = x + alpha (G(z) - x), alpha ~ U[0, 1) per sample, the
    gradient taken by ``torch.autograd.grad(create_graph=True)`` so that
    the critic's gradient runs through it (a double backward).  Schedule:
    one generator update, then ``critic_iters`` (5) critic updates, each
    with a fresh prior z ~ N(0, 1) and a fresh alpha; Adam with betas
    (0.5, 0.9) per group.
  * izif: mean (x - G(E(x)))^2 + ``kappa`` * mean (f(G(E(x))) - f(x))^2,
    f the critic's features.

Departures: the slope |dD/dx^| is reduced over axis 1 only (H of NHWC), a
quirk of Baur et al.'s code kept by every port, where Gulrajani reduces
over all pixels; the generator ends in tanh though the slices lie in
[0, 1]; the critic scores every position of its last feature map (Baur et
al.'s dense layer on a 4-D tensor), not one flattened vector.  ``dim`` is
the ResNets' width, 64 as published.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference import backbone as B
from benchmark.reference import layers as R
from benchmark.reference import resnet as RN

Tensor = torch.Tensor
Leaf = Tuple[str, Tuple[int, ...], str]
GROUPS = {"gen": ("gen_dense", "generator"),
          "disc": ("disc_features", "disc_dense"),
          "enc": ("encoder", "enc_dense")}


def schedule(cfg: Dict) -> List[str]:
    """The groups updated, in order, by one WGAN step."""
    return ["gen"] + ["disc"] * int(cfg["critic_iters"])


def groups(names) -> Dict[str, List[str]]:
    """The parameters each optimizer updates, by the name's first part."""
    return {g: [n for n in names if n.split(".")[0] in heads]
            for g, heads in GROUPS.items()}


def leaves(cfg: Dict) -> Tuple[List[Leaf], List[Leaf]]:
    """(parameters, buffers): names, shapes, inits, as the port names its
    parameters."""
    dim, c, z = cfg["dim"], cfg["numChannels"], cfg["zDim"]
    params, bufs = [], []
    for i, f in enumerate(B.encoder_channels(cfg)):
        params += [(f"encoder.enc_conv_{i}.weight", (f, c, 5, 5), "glorot"),
                   (f"encoder.enc_conv_{i}.bias", (f,), "zeros"),
                   (f"encoder.enc_norm_{i}.weight", (f,), "ones"),
                   (f"encoder.enc_norm_{i}.bias", (f,), "zeros")]
        bufs += [(f"encoder.enc_norm_{i}.running_mean", (f,), "zeros"),
                 (f"encoder.enc_norm_{i}.running_var", (f,), "ones")]
        c = f
    side = cfg["intermediateResolutions"][0]
    inter = cfg["outputWidth"] // 8
    params += [("enc_dense.weight", (z, side * side * c), "glorot"),
               ("enc_dense.bias", (z,), "zeros"),
               ("gen_dense.weight", (inter * inter * 8 * dim, z), "glorot"),
               ("gen_dense.bias", (inter * inter * 8 * dim,), "zeros")]
    params += RN.decoder_leaves("generator", dim, cfg["numChannels"])
    params += RN.encoder_leaves("disc_features", dim, cfg["numChannels"])
    params += [("disc_dense.weight", (1, 8 * dim), "glorot"),
               ("disc_dense.bias", (1,), "zeros")]
    return params, bufs


def critic(p: Dict[str, Tensor], x: Tensor, precision: str = "float32"
           ) -> Tuple[Tensor, Tensor]:
    """(features, score map) of NHWC images, both NHWC."""
    feats = RN.encoder(p, "disc_features", x.permute(0, 3, 1, 2),
                       precision).permute(0, 2, 3, 1)
    return feats, R.dense(feats, p["disc_dense.weight"], p["disc_dense.bias"],
                          precision)


def generate(p: Dict[str, Tensor], z: Tensor, cfg: Dict,
             precision: str = "float32") -> Tensor:
    """z -> NHWC image in (-1, 1)."""
    side = cfg["outputWidth"] // 8
    h = R.dense(z, p["gen_dense.weight"], p["gen_dense.bias"], precision)
    h = h.reshape(z.shape[0], side, side, -1).permute(0, 3, 1, 2)
    return torch.tanh(RN.decoder(p, "generator", h, precision)).permute(
        0, 2, 3, 1)


def encode(p: Dict[str, Tensor], b: Dict[str, Tensor], x: Tensor,
           precision: str = "float32") -> Tensor:
    """NHWC images -> z, BatchNorm in training mode (``b`` moves)."""
    h = B.Net(p, b, True, precision).encode(x)
    flat = h.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return torch.tanh(R.dense(flat, p["enc_dense.weight"],
                              p["enc_dense.bias"], precision))


def gen_loss(p: Dict[str, Tensor], x: Tensor, z: Tensor, alpha: Tensor,
             cfg: Dict, precision: str = "float32") -> Tensor:
    return -critic(p, generate(p, z, cfg, precision), precision)[1].mean()


def slopes_penalty(ddx: Tensor, scale: float) -> Tensor:
    """scale * mean((|ddx| - 1)^2), the norm over axis 1 of NHWC."""
    slopes = torch.sqrt((ddx * ddx).sum(dim=1) + 1e-12)
    return ((slopes - 1.0) ** 2).mean() * scale


def disc_loss(p: Dict[str, Tensor], x: Tensor, z: Tensor, alpha: Tensor,
              cfg: Dict, precision: str = "float32") -> Tensor:
    fake = generate(p, z, cfg, precision).detach()
    x_hat = (x + alpha * (fake - x)).requires_grad_(True)
    (ddx,) = torch.autograd.grad(critic(p, x_hat, precision)[1].sum(), x_hat,
                                 create_graph=True)
    return (critic(p, fake, precision)[1].mean()
            - critic(p, x, precision)[1].mean()
            + slopes_penalty(ddx, cfg["scale"]))


def enc_loss(p: Dict[str, Tensor], b: Dict[str, Tensor], x: Tensor,
             cfg: Dict, precision: str = "float32") -> Tensor:
    x_enc = generate(p, encode(p, b, x, precision), cfg, precision)
    f_enc = critic(p, x_enc, precision)[0]
    f_x = critic(p, x, precision)[0]
    return (((x - x_enc) ** 2).mean()
            + cfg["kappa"] * ((f_enc - f_x) ** 2).mean())


LOSSES = {"gen": gen_loss, "disc": disc_loss}
