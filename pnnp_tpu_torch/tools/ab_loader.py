#!/usr/bin/env python3
"""Time the host loader of the train path in one tree, for A/B runs on one
machine.

    python3 pnnp_tpu_torch/tools/ab_loader.py ROOT [ROOT ...]

Makes one SID fixture as ``chip_smoke.py``'s train run does (4 scenes at
2848x4256), then for each ROOT (a checkout of the repository, e.g. the parent
commit unpacked with ``git archive`` next to the working tree) a fresh
process imports ``pnnp_tpu_torch`` and ``chip_smoke`` from that tree, builds
the train run's ``Raw_Dataset`` (8 crops of 512^2) and times its
``DataLoader`` at the run's 4 workers: ms between batches over 32 batches
after 4 warm-ups (median and mean), ms per item on one thread, and the
median read / pack / crop split of an item. Give the
trees in turns (parent, change, change, parent) to compare two versions.
Prints one JSON line per tree. Host code only: needs no card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

BATCHES, WARMUP, WORKERS = 32, 4, 4


class _Cycle:
    """``n`` items cycling over a data set, as one epoch."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.ds[i % len(self.ds)]

    def reseed_worker(self, *args):
        self.ds.reseed_worker(*args)


def measure(root: str, fixture: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as C
    from pnnp_tpu_torch.data import DataLoader, build_dataset

    from pnnp_tpu_torch.data import native

    dst = C._train_runfile(fixture)["dst_train"]
    ds = build_dataset(dst, seed=1997)
    one = []
    for i in range(len(ds)):
        t0 = time.perf_counter()
        ds[i]
        one.append(1e3 * (time.perf_counter() - t0))
    split = C._loader_split(ds)  # read / pack / crop of one item, medians
    stamps = []
    for _ in DataLoader(_Cycle(ds, BATCHES + WARMUP + 1), batch_size=1,
                        num_workers=WORKERS, seed=1997):
        stamps.append(time.perf_counter())
    gaps = [1e3 * (b - a) for a, b in zip(stamps[WARMUP:], stamps[WARMUP + 1:])]
    return {"root": root, "workers": WORKERS, "median_ms": statistics.median(gaps),
            "mean_ms": statistics.mean(gaps), "n": len(gaps),
            "one_thread_ms": one, "one_thread_split_ms": split,
            "native_pack": native.available(), "cpus": os.cpu_count()}


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        print(json.dumps(measure(argv[1], argv[2])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(argv[0]))
    import chip_smoke as C
    from pnnp_tpu_torch.data.fixtures import make_sid_fixture, place_eval_split

    with tempfile.TemporaryDirectory(prefix="pnnp_ab_loader_") as fixture:
        infos = make_sid_fixture(fixture, n_scenes=C.TRAIN_SCENES, H=C.MOSAIC_H, W=C.MOSAIC_W)
        place_eval_split(fixture, infos, 250)
        for root in argv:  # one process per tree: each imports its own package
            subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root,
                            fixture], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
