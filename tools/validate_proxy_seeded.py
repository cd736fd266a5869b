"""``tools/validate_proxy.py`` (the JAX package's ISO ladder) at another
seed, or in float64.

The JAX tool draws from fixed keys: the init from ``key(0)``, the training
stream from ``key(7)``, the scoring draws from ``key(1000 + iso)``.
``--seed s`` shifts every key it makes by ``s`` (``--seed 0`` is the tool as
it is), as ``pnnp_tpu_torch/tools/ladder_spread.py`` shifts the port's
generators. ``--x64`` runs the ladder in float64: JAX's x64 mode, with the
params cast to float64 at init (the proxy still builds its ISO features in
float32).

Usage (from the repository root; the JAX tool's flags after ``--``):

    python tools/validate_proxy_seeded.py --seed 1 [--x64] -- --cpu --steps 4000

Prints what the JAX tool prints: a table and, last, one JSON line.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--x64", action="store_true")
    a, rest = ap.parse_known_args(argv)
    rest = [r for r in rest if r != "--"]

    import jax
    import jax.numpy as jnp

    from pnnp_tpu.train.state import TrainState
    from tools.validate_proxy import main as ladder

    key = jax.random.key
    jax.random.key = lambda seed: key(seed + a.seed)
    if a.x64:
        jax.config.update("jax_enable_x64", True)
        create = TrainState.create.__func__

        def create_f64(cls, *, params, **kw):
            return create(cls, params=jax.tree.map(lambda p: p.astype(jnp.float64), params),
                          **kw)

        TrainState.create = classmethod(create_f64)
    return ladder(rest)


if __name__ == "__main__":
    main()
