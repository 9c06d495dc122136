"""Device inventory (parity: get_hw_info.ipynb).

Usage: python -m vali_tpu_torch.samples.get_device_info [--device cuda|cpu]
"""

import torch

from . import command_line


def main(argv=None):
    device, _ = command_line(argv, "get_device_info")
    import vali_tpu_torch as vali

    print(f"accelerators: {vali.GetNumGpus()}")
    for i in range(vali.GetNumGpus()):
        print(f"  [{i}] {torch.cuda.get_device_name(i)} (cuda)")
    print(f"samples run on: {device}")
    print("encoder options:")
    for key, doc in sorted(vali.GetNvencParams().items()):
        print(f"  {key:14s} {doc}")


if __name__ == "__main__":
    main()
