"""Per-device memory fit of the port: each architecture's parameters plus
its fp32 RMSProp state under the ``fsdp_tp`` rules on the 16 x 16
production mesh, against an H100's 80 GB (the train_4k configuration).
The trees are built on fake tensors: nothing is allocated.

    PYTHONPATH=src python scripts/hbm_fit_torch.py
"""
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.distributed.sharding import param_specs
from repro_torch.launch.dryrun import device_bytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import init_policy

MESH = make_production_mesh()
HBM = 80e9  # H100 SXM


def main():
    print("| arch | mode | params GB/device | RMSProp fp32 GB/device | "
          "total GB/device | fits 80 GB (w/ activations headroom) |")
    print("|---|---|---|---|---|---|")
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        with FakeTensorMode():
            params = init_policy(cfg, generator=torch.Generator(),
                                 device="cpu")
        mode = "fsdp_tp"
        specs = param_specs(params, MESH, mode)
        pb = device_bytes(params, specs, MESH)
        sb = device_bytes(params, specs, MESH, itemsize=4)  # "sq" mirrors params
        tot = pb + sb
        print(f"| {arch} | {mode} | {pb / 1e9:.2f} | {sb / 1e9:.2f} | "
              f"{tot / 1e9:.2f} | {'yes' if tot < 0.625 * HBM else 'NO'} |")


if __name__ == "__main__":
    main()
