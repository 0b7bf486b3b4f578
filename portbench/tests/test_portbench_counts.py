"""The benchmark's FLOP and byte counts against arithmetic by hand."""
import pytest

from portbench import counts
from portbench import spec

NATURE = spec.load_json(spec.HERE / "configs" / "paac_nature.json")
NIPS = spec.load_json(spec.HERE / "configs" / "paac_nips.json")


@pytest.mark.parametrize("net, macs", [
    # conv 32x8x8 s4 -> 20x20, 64x4x4 s2 -> 9x9, 64x3x3 s1 -> 7x7,
    # dense 7*7*64 -> 512, heads 512 -> 3 + 1
    (NATURE, [("conv1", 20 * 20 * 32 * 8 * 8 * 4),
              ("conv2", 9 * 9 * 64 * 4 * 4 * 32),
              ("conv3", 7 * 7 * 64 * 3 * 3 * 64),
              ("dense", 7 * 7 * 64 * 512), ("heads", 512 * 4)]),
    # conv 16x8x8 s4 -> 20x20, 32x4x4 s2 -> 9x9, dense 9*9*32 -> 256
    (NIPS, [("conv1", 20 * 20 * 16 * 8 * 8 * 4),
            ("conv2", 9 * 9 * 32 * 4 * 4 * 16),
            ("dense", 9 * 9 * 32 * 256), ("heads", 256 * 4)]),
])
def test_layer_macs(net, macs):
    assert counts.layer_macs(net, 3) == macs


@pytest.mark.parametrize("net, fwd, it", [
    (NATURE, 18_690_048, 92_089_090_048),
    (NIPS, 5_933_056, 27_701_805_056),
])
def test_iteration_flops(net, fwd, it):
    assert counts.forward_flops(net, 3) == fwd
    first = 2 * counts.layer_macs(net, 3)[0][1]
    # (1280 acting + 256 bootstrap + 1280 learning) forwards and 1280
    # backwards without the first convolution's input gradient
    assert it == fwd * (1280 + 256 + 1280) + 1280 * (2 * fwd - first)
    assert counts.iteration_flops(net, 3, 256, 5) == it


def test_returns_bytes():
    # K1: rewards 4 + dones 1 + returns 4 bytes a step and env, bootstrap 4
    assert counts.nstep_bytes(5, 256) == 5 * 256 * 9 + 256 * 4 == 12544
    # K2: rewards, values, ratios 12 + dones 1 + two outputs 8, bootstrap 4
    assert counts.vtrace_bytes(5, 256) == 5 * 256 * 21 + 256 * 4 == 27904


def test_peaks():
    assert counts.PEAK_FLOPS["float32"] == 67e12
    assert counts.PEAK_FLOPS["tf32"] == 495e12
    assert counts.HBM_BYTES_PER_S == 3.35e12
