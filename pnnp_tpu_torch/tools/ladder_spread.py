"""Spread of the proxy's ISO-ladder acceptance over seeds.

Runs :func:`pnnp_tpu_torch.tools.validate_proxy.main` once per seed (each
seed shifts the init draw, the training stream and the scoring draws), and
reports each run's table row beside the bars of
tests/test_proxy_iso_ladder.py, and per ISO the least, median and largest
KLD over the runs. ``--init-from`` starts every run from one params pickle
in the JAX tree layout instead of a fresh init draw (e.g. the JAX tool's
``python tools/validate_proxy.py --cpu --steps 0 --save init.pkl``, its
key-0 init), so that only the training stream varies.

Usage (from the repository root; on the card unless ``--cpu``):

    python -m pnnp_tpu_torch.tools.ladder_spread --seeds 0,1,2 [--init-from PKL] \\
        [validate_proxy flags, e.g. --steps 4000 --eval-frames 16]

Prints one line per run and, last, one JSON line (also :func:`main`'s
return value).
"""

from __future__ import annotations

import argparse
import json
import pickle
import statistics

# tests/test_proxy_iso_ladder.py's bars: heldout -> (kld, row_kld)
TEST_BARS = {False: (0.06, 0.08), True: (0.08, 0.30)}


def inside_bars(row) -> bool:
    kld, row_kld = TEST_BARS[row["heldout"]]
    return row["kld"] <= kld and row["row_kld"] <= row_kld


def main(argv=None, device=None):
    from pnnp_tpu_torch.tools.validate_proxy import main as ladder

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--init-from", default="")
    a, rest = ap.parse_known_args(argv)
    init = None
    if a.init_from:
        with open(a.init_from, "rb") as f:
            init = pickle.load(f)
    runs = []
    for seed in (int(s) for s in a.seeds.split(",")):
        res = ladder(rest, device=device, seed=seed, init=init)
        rows = [dict(r, inside=inside_bars(r)) for r in res["rows"]]
        runs.append({"seed": seed, "nll": res["nll"], "train_s": res["train_s"],
                     "rows": rows})
        print(f"seed {seed}: " + ", ".join(
            f"{r['iso']}{'*' if r['heldout'] else ''} {r['kld']:.4f}/{r['row_kld']:.4f}"
            f"{'' if r['inside'] else ' (over)'}" for r in rows), flush=True)
    spread = {}
    for i, r0 in enumerate(runs[0]["rows"]):
        vals = {k: [run["rows"][i][k] for run in runs] for k in ("kld", "row_kld")}
        spread[r0["iso"]] = {
            **{f"{k}_{stat}": fn(v) for k, v in vals.items()
               for stat, fn in (("min", min), ("median", statistics.median), ("max", max))},
            "inside": sum(run["rows"][i]["inside"] for run in runs), "heldout": r0["heldout"]}
    result = {"metric": "proxy_iso_ladder_spread", "argv": rest, "init_from": a.init_from,
              "runs": runs, "spread": spread}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
