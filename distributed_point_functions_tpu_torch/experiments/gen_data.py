"""Generates the synthetic sparse-histogram inputs of the reference
library's experiments (its CSV fixtures are git-LFS pointers with no
content, so they are regenerated from their documented distributions,
the reference's ``experiments/README.md``):

1. power law: 90% of nonzeros uniform in the first 10% of the domain
2. power law: 90% of nonzeros uniform in the first 50% of the domain
3. uniform

    python -m distributed_point_functions_tpu_torch.experiments.gen_data \\
        [--log_domain_size 32] [--num_nonzeros 1048576] [--out_dir DIR]

Writes ``<bits>_<nonzeros>_<count>_<skew>.csv`` with one bucket id a line
(the first column, which the experiments read), byte-identical to the JAX
package's ``experiments/gen_data.py`` for the same arguments: the RNG is
seeded from the fixture's parameters. The default ``--out_dir`` is this
package's ``experiments/data/``. The last line is one JSON record naming
the files written.
"""

from __future__ import annotations

import argparse
import json
import os
import random

SKEWS = ("0.1", "0.5", "uniform")


def sample_unique(num: int, log_domain: int, skew) -> list:
    """`num` unique bucket ids, sorted; skew in {0.1, 0.5, 'uniform'}."""
    rng = random.Random(f"{log_domain}-{num}-{skew}")
    domain = 1 << log_domain
    seen = set()
    if skew == "uniform":
        while len(seen) < num:
            seen.add(rng.randrange(domain))
    else:
        hot = max(int(domain * float(skew)), 1)
        while len(seen) < num:
            if rng.random() < 0.9:
                seen.add(rng.randrange(hot))
            else:
                seen.add(rng.randrange(domain))
    return sorted(seen)


def fixture_name(log_domain: int, num: int, skew: str) -> str:
    return f"{log_domain}_{num}_{num}_{skew}.csv"


def write_fixture(out_dir: str, log_domain: int, num: int, skew: str) -> str:
    """Writes one fixture (skew one of SKEWS) and returns its path."""
    path = os.path.join(out_dir, fixture_name(log_domain, num, skew))
    values = sample_unique(num, log_domain, skew if skew == "uniform" else float(skew))
    with open(path, "w") as f:
        f.writelines(f"{v}\n" for v in values)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log_domain_size", type=int, default=32)
    ap.add_argument("--num_nonzeros", type=int, default=1 << 20)
    ap.add_argument("--out_dir", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                      "data"))
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    paths = []
    for skew in SKEWS:
        paths.append(write_fixture(args.out_dir, args.log_domain_size, args.num_nonzeros, skew))
        print(f"wrote {paths[-1]} ({args.num_nonzeros} nonzeros)")
    print(json.dumps({"tool": "gen_data", "platform": "host", "paths": paths,
                      "log_domain_size": args.log_domain_size,
                      "num_nonzeros": args.num_nonzeros}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
