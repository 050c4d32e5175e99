"""One process on one card: the harness runs in this process."""

from splatbench import harness


def run(cell, seed, seconds, trace, started, clock):
    return harness.run_cell(cell, seed, seconds, trace, started, clock)
