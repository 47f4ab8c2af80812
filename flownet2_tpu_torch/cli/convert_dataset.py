"""convert_dataset on PyTorch's side: pack an image+flow or image+disparity
dataset into ``.flowrec`` records (flownet2_tpu/cli/convert_dataset.py).

The ``convert_imageset_and_flow`` analogue (tools/convert_imageset_and_flow
.cpp, driven by data/make-lmdbs.sh):

    python -m flownet2_tpu_torch.cli.convert_dataset OUT.flowrec
        (--listfile FILE | --dataset NAME --data-root DIR) [--limit N]

- ``--listfile``: lines of ``img0 img1 flow [occ]``; the flow is a ``.flo``
  or a ``.pfm``, whose first two channels are the flow, or whose one
  channel is a disparity (the record then holds a 1-channel payload, which
  ``cli.train --model dispnetc`` trains on); ``occ`` an image, occluded
  where its first channel is above 127;
- ``--dataset``: a layout or packed format ``data.open_dataset`` opens.

Each sample is packed with the reference's datum encoding (uint8 images,
int16 x32 flow with the NaN sentinel, bit-packed occlusion); the output is
byte for byte the JAX package's.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("output", help="output .flowrec path")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--listfile", help="lines of: img0 img1 flow [occ]")
    src.add_argument("--dataset", help="dataset name (flyingchairs|sintel|...)")
    p.add_argument("--data-root", help="dataset root for --dataset")
    p.add_argument("--limit", type=int, default=0, help="stop after N samples")
    args = p.parse_args(argv)

    import numpy as np

    from flownet2_tpu_torch.core.flow_io import read_flo, read_image, read_pfm
    from flownet2_tpu_torch.data import FlowRecordWriter, open_dataset

    def iter_samples():
        if args.listfile:
            with open(args.listfile) as f:
                for ln, line in enumerate(f, 1):
                    parts = line.split()
                    if not parts:
                        continue
                    if len(parts) not in (3, 4):
                        raise SystemExit(f"{args.listfile}:{ln}: expected 3-4 paths")
                    img0 = read_image(parts[0])
                    img1 = read_image(parts[1])
                    if parts[2].lower().endswith(".pfm"):
                        flow = read_pfm(parts[2])[0][:, :, :2]
                    else:
                        flow = read_flo(parts[2])
                    occ = None
                    if len(parts) == 4:
                        occ = read_image(parts[3])[..., 0] > 127
                    yield img0, img1, flow, occ
        else:
            if not args.data_root:
                raise SystemExit("--dataset requires --data-root")
            ds = open_dataset(args.dataset, args.data_root)
            for i in range(len(ds)):
                s = ds[i]
                occ = s["occ"][..., 0] > 0.5 if "occ" in s else None
                yield s["img0"].astype(np.uint8), s["img1"].astype(np.uint8), s["flow"], occ

    n = 0
    with FlowRecordWriter(args.output) as w:
        for img0, img1, flow, occ in iter_samples():
            w.write(img0, img1, flow, occ)
            n += 1
            if n % 500 == 0:
                print(f"packed {n} samples")
            if args.limit and n >= args.limit:
                break
    print(f"wrote {n} records to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
