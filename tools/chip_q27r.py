"""Run TPC-DS q27r whole on the card as phase 23 of chip_smoke.py runs it
(SF-10 store_sales' item, store and quantity; item and store broadcast;
Expand x3 into the partial aggregation; hash(4); take-ordered 200),
from the checkout in the working directory, and print its stage times
beside the card's name and power limit.  Run from two checkouts' roots
in one chip call, it compares their stage times on one machine:

    cd build/parent && python3 ../../tools/chip_q27r.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=C.SF10_STORE_SALES_ROWS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_q27r: no CUDA device", file=sys.stderr)
        return 2
    from auron_tpu_torch import resolve_device
    from auron_tpu_torch.ops import kernels_cuda as K
    dev = resolve_device("cuda")
    card = C.card_line()
    K.build()
    cols, valid = C.make_store_sales(args.rows, args.seed)
    item_k, store_k, store_v, _, _ = C.make_ss_keys(args.rows, args.seed)
    item_cat, _ = C.make_item_dims(args.seed)
    ss = ([item_k, store_k, cols[1]],
          [np.ones(args.rows, bool), store_v, valid[1]])
    q = C.run_slice9_query("q27r", {
        "store_sales": ss, "store": C.make_store(), "item": item_cat},
        {"store_sales": C.N_MAPS, "store": 1, "item": 1}, dev, K, card)
    print(f"q27r from {os.getcwd()}: {C.check_q27r(q.out(), *ss)} groups "
          f"equal to numpy | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
