#!/usr/bin/env python3
"""How often a tests/test_book.py program of paddle_tpu_torch's static
graph misses its book threshold, over global seeds, on the CPU.

    python3 scripts/book_seed_sweep.py [--name recommender] [--seeds 40]

For each seed in 0 .. seeds-1: ``paddle_tpu_torch.seed(seed)``, the
program's startup program (its own random initial parameters), then
chip_smoke.py's ``train_book`` over the book feeds, as phase
``static_book`` trains it. Prints each seed that misses the threshold
(first and last loss) and the count. The book feeds do not depend on
the seed; only the initial parameters do.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--name", default="recommender")
    ap.add_argument("--seeds", type=int, default=40)
    args = ap.parse_args()
    import chip_smoke
    import paddle_tpu_torch as tpt
    tpt.set_device("cpu")
    api = chip_smoke.port_static_api()
    feeds, _ = chip_smoke.book_feeds(args.name)
    program = chip_smoke.book_program(api, args.name)
    missed = 0
    for seed in range(args.seeds):
        tpt.seed(seed)
        losses, last, _ = chip_smoke.train_book(
            api, args.name, tpt.Executor(), tpt.Scope(), program, feeds)
        if not chip_smoke.book_converged(args.name, losses, last):
            missed += 1
            print(f"seed {seed}: loss {losses[0]:.6f} -> {losses[-1]:.6f}, "
                  f"threshold missed")
    print(f"{args.name}: {missed} of {args.seeds} seeds miss the book "
          f"threshold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
