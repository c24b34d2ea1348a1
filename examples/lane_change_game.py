"""Game-theoretic lane-change decision demo (reference: game_theory.py:352-395).

Runs the three reference fixtures through the vectorized decision rollout and
prints the first lane-change time per fixture — the analogue of the
reference's "Changing lanes at:" prints.

Run:  python examples/lane_change_game.py [--plot out.png]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json

import numpy as np

from mpc_tpu.decision.game_theory import (decision_rollout, scenario_1,
                                          scenario_2, scenario_3)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--plot", type=str, default="")
    args = ap.parse_args()

    dt, n = 0.1, 50
    results = {}
    curves = {}
    for name, builder in [("test_1", scenario_1), ("test_2", scenario_2),
                          ("test_3", scenario_3)]:
        ego, cars = builder()
        payoffs, change = decision_rollout(ego, cars, n_steps=n, dt=dt)
        payoffs = np.asarray(payoffs)
        change = np.asarray(change)
        t_change = float(np.argmax(change) * dt) if change.any() else None
        results[name] = {"first_change_t": t_change,
                         "n_change_steps": int(change.sum())}
        curves[name] = payoffs

    print(json.dumps(results))

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        t = np.arange(n) * dt
        fig, axes = plt.subplots(3, 1, figsize=(8, 9), sharex=True)
        for ax, (name, p) in zip(axes, curves.items()):
            ax.plot(t, p[:, 0], label="lane 1")
            ax.plot(t, p[:, 1], label="lane 2")
            ax.set_title(name)
            ax.grid(True)
            ax.legend()
        fig.savefig(args.plot, dpi=100)
        print("saved", args.plot)


if __name__ == "__main__":
    from mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
