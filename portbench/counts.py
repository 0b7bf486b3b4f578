"""Operations and bytes the benchmark counts from shapes, and the peaks of
the card it divides them by.

FLOPs are 2 per multiply-add of the convolutions and the dense layers;
biases, activations and the env are left out. One PAAC iteration of
``n_e`` environments over ``t_max`` steps runs the network forward on
n_e·t_max acting frames and n_e bootstrap frames, forward again on the
n_e·t_max learning frames, and backward over those: a weight gradient for
every layer and an input gradient for every layer but the first
convolution, whose input is the observation.

A returns kernel's least bytes count each input once and its output once.
"""
from __future__ import annotations

from typing import List, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def layer_macs(net: dict, num_actions: int) -> List[Tuple[str, int]]:
    """Multiply-adds of one frame's forward, layer by layer."""
    size, in_ch = net["obs_shape"][0], net["obs_shape"][-1]
    out = []
    for i, (feat, kern, stride) in enumerate(net["cnn_spec"]):
        size = (size - kern) // stride + 1
        out.append((f"conv{i + 1}", size * size * feat * kern * kern * in_ch))
        in_ch = feat
    d = net["cnn_dense"]
    out.append(("dense", size * size * in_ch * d))
    out.append(("heads", d * (num_actions + 1)))
    return out


def forward_flops(net: dict, num_actions: int) -> int:
    """FLOPs of one frame's forward."""
    return 2 * sum(m for _, m in layer_macs(net, num_actions))


def iteration_flops(net: dict, num_actions: int, n_envs: int,
                    t_max: int) -> int:
    """Model FLOPs of one PAAC iteration."""
    fwd = forward_flops(net, num_actions)
    first = 2 * layer_macs(net, num_actions)[0][1]
    frames = n_envs * t_max
    acting = (frames + n_envs) * fwd
    learning = frames * fwd
    backward = frames * (2 * fwd - first)
    return acting + learning + backward


def nstep_bytes(t_max: int, n_envs: int) -> int:
    """K1: rewards (f32), dones (bool) and the bootstrap (f32) read, the
    returns (f32) written."""
    te = t_max * n_envs
    return 4 * te + te + 4 * n_envs + 4 * te


def vtrace_bytes(t_max: int, n_envs: int) -> int:
    """K2: rewards, values and ratios (f32), dones (bool) and the bootstrap
    (f32) read, the targets and advantages (f32) written."""
    te = t_max * n_envs
    return 3 * 4 * te + te + 4 * n_envs + 2 * 4 * te
