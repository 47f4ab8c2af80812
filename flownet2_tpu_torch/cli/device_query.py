"""device_query on PyTorch: enumerate the CUDA devices (the ``caffe
device_query`` brew command, tools/caffe.cpp:111-121; flownet2_tpu/cli/
device_query.py lists the JAX devices).

    python -m flownet2_tpu_torch.cli.device_query

Prints the backend and, for each device ``torch.cuda`` sees, its name,
total memory, SM count and compute capability. Without a card it says so
and exits 0: it runs no model.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("backend: cpu")
        print(f"no CUDA device visible (torch {torch.__version__}, built for CUDA {torch.version.cuda})")
        return 0
    print(f"backend: cuda (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print("process 0 of 1")
    for i in range(torch.cuda.device_count()):
        prop = torch.cuda.get_device_properties(i)
        print(f"device {i}: {prop.name} (platform cuda), {prop.total_memory / 2**30:.1f} GiB, "
              f"{prop.multi_processor_count} SMs, compute capability {prop.major}.{prop.minor}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
