"""The dataset index CLI (counterpart of ``tools/get_dataset_infos.py``;
reference: get_dataset_infos.py:204-222).

Usage (from the repository root):

  python -m pnnp_tpu_torch.tools.get_dataset_infos --dstname SID  --root_dir /data/SID --mode train
  python -m pnnp_tpu_torch.tools.get_dataset_infos --dstname ELD  --root_dir /data/ELD
  python -m pnnp_tpu_torch.tools.get_dataset_infos --dstname LRID --root_dir /data/LRID --subset indoor_x5
  python -m pnnp_tpu_torch.tools.get_dataset_infos --dstname LRID --root_dir /data/LRID   # all subsets

With no ``--subset``, LRID indexes every subset it finds (indoor_x5,
indoor_x3, outdoor_x3), skipping those whose directory is absent, as the
reference does (get_dataset_infos.py:216-221). The indexes come from the
port's ``data/infos.py``; their pickles load as the JAX CLI's do.

The camera raws are decoded to the npy caches these indexes point at by
``tools/decode_cache.py``, which imports rawpy and neither package, so it
serves the port as it is.
"""

from __future__ import annotations

import argparse
import os

from pnnp_tpu_torch.data.infos import get_eld_info, get_lrid_info, get_sid_info

LRID_SUBSETS = ("indoor_x5", "indoor_x3", "outdoor_x3")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dstname", required=True, choices=["SID", "ELD", "LRID"])
    p.add_argument("--root_dir", required=True)
    p.add_argument("--mode", default="train")
    p.add_argument("--subset", default=None,
                   help="LRID subset; default indexes every available one")
    p.add_argument("--out_dir", default="infos")
    p.add_argument("--pair_list", default=None, help="SID pair list txt")
    a = p.parse_args(argv)
    os.makedirs(a.out_dir, exist_ok=True)
    if a.dstname == "SID":
        get_sid_info(a.root_dir, os.path.join(a.out_dir, f"SID_{a.mode}.info"),
                     mode=a.mode, pair_list=a.pair_list)
    elif a.dstname == "ELD":
        get_eld_info(a.root_dir, os.path.join(a.out_dir, "ELD_SonyA7S2.info"))
    else:
        subsets = ([a.subset] if a.subset else
                   [s for s in LRID_SUBSETS if os.path.isdir(os.path.join(a.root_dir, s))])
        if not subsets:
            raise SystemExit(f"no LRID subset directories under {a.root_dir}")
        for s in subsets:
            get_lrid_info(a.root_dir, os.path.join(a.out_dir, f"{s}_GT_align_ours.info"),
                          dstname=s)


if __name__ == "__main__":
    main()
