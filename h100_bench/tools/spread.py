"""The spread of a cell's runs, and the bounds it allows.

    python3 h100_bench/tools/spread.py RESULTS.jsonl [...]

Each line of the files is ``{"set": k, "seed": n, "line": <run.py's result
line>}``.  For every end-to-end metric: each set's median and spread (the
quartile distance over the median, ``statistics.quantiles(n=4)``), the
wider of the sets' spreads, five times it (never under 1%) as the bound it
suggests, and how far the second set's median lies from the first's; and
whether every run read ``correct``.  ``tight`` is the spread as a check
reads tightness: the mean of the sets' spreads, each set's run farthest
from its median left out where that narrows it; a bound under twice it is
too tight.  ``loose``: the spread of all runs together; a bound over
eight times it is too loose.
"""
from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from harness.stats import spread  # noqa: E402


def trimmed(values) -> float:
    """A set's spread with its run farthest from the median left out,
    where that narrows it."""
    med = statistics.median(values)
    rest = list(values)
    rest.remove(max(rest, key=lambda v: abs(v - med)))
    return min(spread(values), spread(rest)) if len(rest) >= 2 else spread(values)


def main(paths) -> int:
    runs = [json.loads(line) for p in paths for line in open(p) if line.strip()]
    sets = sorted({r["set"] for r in runs})
    names = sorted({m for r in runs for m in r["line"]["metrics"]})
    print(f"{len(runs)} runs, sets {sets}; correct: "
          f"{sum(r['line']['correct'] for r in runs)}/{len(runs)}")
    for name in names:
        per = {s: [r["line"]["metrics"][name]["value"] for r in runs
                   if r["set"] == s and name in r["line"]["metrics"]] for s in sets}
        meds = {s: statistics.median(v) for s, v in per.items()}
        spreads = {s: spread(v) for s, v in per.items() if len(v) >= 2}
        wide = max(spreads.values())
        shift = abs(meds[sets[-1]] - meds[sets[0]]) / abs(meds[sets[0]])
        tight = statistics.mean(trimmed(v) for v in per.values() if len(v) >= 3)
        loose = spread([x for v in per.values() for x in v])
        print(f"{name}: medians {meds} spreads {spreads} widest {wide:.5f} "
              f"bound {max(5 * wide, 0.01):.4f} medians apart {shift:.5f} "
              f"tight {tight:.5f} (bound from {2 * tight:.4f}) loose {loose:.5f} "
              f"(bound to {8 * loose:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
