"""The paper's policy/value CNNs.

``arch_nips``  — Mnih et al. 2013 network adapted to actor-critic (paper §5.1):
    conv 16x8x8 s4, conv 32x4x4 s2, dense 256.
``arch_nature`` — Mnih et al. 2015 adaptation:
    conv 32x8x8 s4, conv 64x4x4 s2, conv 64x3x3 s1, dense 512.

Input: (B, 84, 84, 4) stacked grayscale frames in [0, 1], channels last as
in ``repro``. The convolutions run in PyTorch's NCHW with OIHW weights (the
bridge carries the reference's HWIO weights across) and VALID padding; the
trunk permutes back to NHWC before it flattens, so the dense weights are
the reference's, row for row. With an empty ``cnn_spec`` (``paac_vector``)
the trunk is an MLP on the flattened observation.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import dtype_of, init_linear, linear


def init_cnn(generator, cfg):
    dtype = dtype_of(cfg.param_dtype)
    dev = generator.device
    p = {"convs": []}
    in_ch = cfg.obs_shape[-1]
    size = cfg.obs_shape[0]
    for feat, kern, stride in cfg.cnn_spec:
        std = 1.0 / math.sqrt(kern * kern * in_ch)
        w = torch.randn((feat, in_ch, kern, kern), generator=generator,
                        device=dev)
        p["convs"].append({"w": (w * std).to(dtype),
                           "b": torch.zeros((feat,), dtype=dtype, device=dev)})
        in_ch = feat
        size = (size - kern) // stride + 1
    if cfg.cnn_spec:
        flat = size * size * in_ch
    else:  # pure-MLP trunk on flattened observations (vector envs)
        flat = int(math.prod(cfg.obs_shape))
    p["dense"] = init_linear(generator, flat, cfg.cnn_dense, dtype, bias=True)
    return p


def cnn_forward(p, cfg, obs):
    """obs: (B, H, W, C) float -> (B, cnn_dense)."""
    x = obs.to(dtype_of(cfg.compute_dtype))
    if cfg.cnn_spec:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv, (_, _, stride) in zip(p["convs"], cfg.cnn_spec):
            x = F.relu(F.conv2d(x, conv["w"], conv["b"], stride=stride))
        x = x.permute(0, 2, 3, 1)  # back to NHWC: the reference's flatten order
    x = x.reshape(x.shape[0], -1)
    return F.relu(linear(p["dense"], x))
